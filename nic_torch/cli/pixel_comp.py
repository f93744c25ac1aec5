"""Per-pixel MLP decode compression (port of ``nic.cli.pixel_comp``):
conv-encode once to a (S/4 + 1)² latent lattice, train a tiny MLP to
decode each pixel from its 2×2 latent patch on random pixel batches,
store the quantized lattice as a uint8 ``.npy``, and decode the whole
image at once through the folded first layer.

Run: ``python -m nic_torch.cli.pixel_comp [--image_path ...]`` with the
JAX CLI's flags (``--batch_pixels``, ``--pe_channels``, ``--hidden``
included) plus ``--device`` (``cuda`` by default, which raises without a
card; ``--device cpu``)."""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np

from nic_torch.cli import common
from nic_torch.obs.log import RunLog, ScalarWriter, make_filename_by_seq

PROJECT = "pixel"
USE_PE = False


def run(argv=None, project: str = PROJECT, use_pe: bool = USE_PE) -> float:
    from nic_torch.data.assets import load_image_mips
    from nic_torch.io.artifacts import save_latent
    from nic_torch.train.pixel import PixelTrainer

    parser = common.standard_parser(__doc__, num_bits=8, num_epochs=20000)
    parser.add_argument("--batch_pixels", type=int, default=256)
    parser.add_argument("--pe_channels", type=int, default=4)
    parser.add_argument("--hidden", type=int, default=64)
    args = parser.parse_args(argv)
    device = common.resolve(args)
    name = common.save_name(project, args)

    def out(*p):
        return os.path.join(args.output_root, *p)

    log = RunLog(make_filename_by_seq(out("printlog"), f"{name}.txt"))
    log(datetime.datetime.now())
    if args.data_parallel:
        log("--data_parallel: the per-pixel workload has no mesh path (as "
            "in the JAX CLI); training on one device")

    image = load_image_mips(args.image_path, args.image_size,
                            0)[0].transpose(1, 2, 0)
    trainer = PixelTrainer(
        image, num_bits=args.num_bits, latent_channels=args.latent_channels,
        hidden=args.hidden, num_epochs=args.num_epochs,
        batch_pixels=args.batch_pixels, use_pe=use_pe,
        pe_channels=args.pe_channels, lr=args.lr, seed=args.seed,
        qat_ste=args.qat_ste, device=device)
    common.maybe_resume(trainer, args, log, project)
    writer = ScalarWriter(out("log", name), out("log", f"{name}_scalars.csv"))
    if args.train_model:
        common.run_training(trainer, args, log, writer, project)

    if args.save_model:
        with log.span("encode time"):
            latent = trainer.encode()
        save_latent(out("comp", f"{name}.npy"), latent, args.num_bits)
    else:
        latent = np.load(out("comp", f"{name}.npy"))

    with log.span("decode time"):
        rec = trainer.decode(latent)
    p = common.report_image(log, image, rec, make_filename_by_seq(
        out("image"), f"{name}.png"))
    writer.close()
    log(datetime.datetime.now())
    return p


if __name__ == "__main__":
    run(sys.argv[1:])
