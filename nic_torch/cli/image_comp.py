"""Whole-image conv-AE compression (port of ``nic.cli.image_comp``): train
a 2D conv autoencoder on one image, quantize its latent to ``--num_bits``
(default 4), store it as a uint8 ``.npy``, decode it in one call and
report the PSNR.

Run: ``python -m nic_torch.cli.image_comp [--image_path ... --num_bits 4
...]`` with the JAX CLI's flags plus ``--device`` (``cuda`` by default,
which raises without a card; ``--device cpu``). ``nic_torch.cli.
movie_lavel_comp`` aliases this workload. Outputs under ``--output_root``:
``printlog/``, ``log/`` (scalars CSV), ``model/`` (checkpoints under the
JAX keys), ``comp/`` (the latent) and ``image/`` (the PNG)."""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np

from nic_torch.cli import common
from nic_torch.obs.log import ScalarWriter, make_filename_by_seq

PROJECT = "image"


def run(argv=None, project: str = PROJECT) -> float:
    from nic_torch.data.assets import load_image_mips
    from nic_torch.io.artifacts import save_latent
    from nic_torch.train.conv_ae import ConvAETrainer

    args = common.standard_parser(__doc__, num_bits=4,
                                  num_epochs=80000).parse_args(argv)
    name = common.save_name(project, args)
    device, mesh, log = common.start(args, name)

    def out(*p):
        return os.path.join(args.output_root, *p)

    log(datetime.datetime.now())

    image_hw3 = load_image_mips(args.image_path, args.image_size,
                                0)[0].transpose(1, 2, 0)
    trainer = ConvAETrainer(
        image_hw3, num_bits=args.num_bits,
        latent_channels=args.latent_channels,
        hidden_channels=args.hidden_channels, num_epochs=args.num_epochs,
        lr=args.lr, seed=args.seed, qat_ste=args.qat_ste, device=device,
        mesh=mesh)
    common.maybe_resume(trainer, args, log, project)
    main = common.is_main(trainer)
    writer = (ScalarWriter(out("log", name), out("log", f"{name}_scalars.csv"))
              if main else ScalarWriter(None))
    if args.train_model:
        common.run_training(trainer, args, log, writer, project)

    if args.save_model:
        with log.span("encode time"):
            latent = trainer.encode()
        if main:
            save_latent(out("comp", f"{name}.npy"), latent, args.num_bits)
        log(f"latent shape: {latent.shape}")
    else:
        latent = np.load(out("comp", f"{name}.npy"))

    with log.span("decode time"):
        rec = trainer.decode(latent)
    p = common.report_image(log, image_hw3, rec, make_filename_by_seq(
        out("image"), f"{name}.png") if main else None)
    writer.close()
    log(datetime.datetime.now())
    return p


if __name__ == "__main__":
    run(sys.argv[1:])
