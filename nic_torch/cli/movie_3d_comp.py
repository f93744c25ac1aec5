"""True-3D video compression (port of ``nic.cli.movie_3d_comp``): a Conv3d
autoencoder over the [T, H, W, 3] clip (NCDHW inside), 8-bit latent, the
frames' average PSNR, checkpoint and resume (``--resume`` /
``--resume_step``).

Run: ``python -m nic_torch.cli.movie_3d_comp --image_path
data/misty_64_64.avi`` with the JAX CLI's flags plus ``--device``
(``cuda`` by default, which raises without a card; ``--device cpu``)."""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np

from nic_torch.cli import common
from nic_torch.obs.log import ScalarWriter, make_filename_by_seq

PROJECT = "movie_3d"


def run(argv=None) -> float:
    from nic_torch.data.assets import read_clip
    from nic_torch.io.artifacts import save_latent
    from nic_torch.train.conv_ae import ConvAETrainer

    parser = common.standard_parser(
        __doc__, image_path="data/misty_64_64.avi", num_bits=8,
        num_epochs=3200000, latent_channels=16, hidden_channels=32)
    args = parser.parse_args(argv)
    name = common.save_name(PROJECT, args)
    device, mesh, log = common.start(args, name)

    def out(*p):
        return os.path.join(args.output_root, *p)

    log(datetime.datetime.now())

    movie = read_clip(args.image_path).astype(np.float32) / 255.0
    trainer = ConvAETrainer(
        movie, num_bits=args.num_bits, latent_channels=args.latent_channels,
        hidden_channels=args.hidden_channels, num_epochs=args.num_epochs,
        lr=args.lr, seed=args.seed, qat_ste=args.qat_ste, device=device,
        mesh=mesh)
    common.maybe_resume(trainer, args, log, PROJECT)
    main = common.is_main(trainer)
    writer = (ScalarWriter(out("log", name), out("log", f"{name}_scalars.csv"))
              if main else ScalarWriter(None))
    if args.train_model:
        common.run_training(trainer, args, log, writer, PROJECT)

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
    p = common.report_video(log, movie, rec, make_filename_by_seq(
        out("image"), f"{name}.avi") if main else None)
    writer.close()
    log(datetime.datetime.now())
    return p


if __name__ == "__main__":
    run(sys.argv[1:])
