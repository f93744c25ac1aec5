"""Frame-flattened video compression (port of
``nic.cli.movie_frame_comp``): read an uncompressed AVI, tile its T
frames of S² into one √T·S square sheet, compress the sheet with the 2D
conv-AE, then un-tile the reconstruction and write it as an AVI.

Run: ``python -m nic_torch.cli.movie_frame_comp --image_path
data/misty_64_64.avi`` with the JAX CLI's flags plus ``--device``
(``cuda`` by default, which raises without a card; ``--device cpu``)."""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np

from nic_torch.cli import common
from nic_torch.obs.log import ScalarWriter, make_filename_by_seq

PROJECT = "movie_frame"


def run(argv=None, project: str = PROJECT) -> float:
    from nic_torch.data.assets import (flatten_3d_to_2d, read_clip,
                                       unflatten_2d_to_3d)
    from nic_torch.io.artifacts import save_latent
    from nic_torch.train.conv_ae import ConvAETrainer

    parser = common.standard_parser(
        __doc__, image_path="data/misty_64_64.avi", num_bits=8,
        num_epochs=100000, latent_channels=16)
    args = parser.parse_args(argv)
    name = common.save_name(project, args)
    device, mesh, log = common.start(args, name)

    def out(*p):
        return os.path.join(args.output_root, *p)

    log(datetime.datetime.now())

    movie = read_clip(args.image_path)  # [T, S, S, 3] uint8
    t, s = movie.shape[0], movie.shape[1]
    sheet_size = int(np.sqrt(t)) * s  # 64 frames of 64² → a 512² sheet
    sheet = flatten_3d_to_2d(movie, sheet_size).astype(np.float32) / 255.0

    trainer = ConvAETrainer(
        sheet, num_bits=args.num_bits, latent_channels=args.latent_channels,
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
    else:
        latent = np.load(out("comp", f"{name}.npy"))

    with log.span("decode time"):
        rec_sheet = trainer.decode(latent)
    rec_movie = unflatten_2d_to_3d(rec_sheet, s, t)
    p = common.report_video(
        log, movie.astype(np.float32) / 255.0, rec_movie,
        make_filename_by_seq(out("image"), f"{name}.avi") if main else None)
    writer.close()
    log(datetime.datetime.now())
    return p


if __name__ == "__main__":
    run(sys.argv[1:])
