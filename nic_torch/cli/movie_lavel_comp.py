"""movie_lavel workload (port of ``nic.cli.movie_lavel_comp``), both modes:

- default: the image_comp alias (the reference's file is a copy of
  image_comp);
- ``--label_embedding true --image_path <video>``: the per-frame
  label-embedding method (``nic_torch.train.movie_label``).

Run: ``python -m nic_torch.cli.movie_lavel_comp [--label_embedding true]
[flags]`` with the JAX CLI's flags plus ``--device`` (``cuda`` by
default, which raises without a card; ``--device cpu``)."""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np

from nic_torch.cli import common
from nic_torch.cli.image_comp import run as _image_run


def run(argv=None) -> float:
    argv = list(argv) if argv is not None else sys.argv[1:]
    if "--label_embedding" in argv:
        i = argv.index("--label_embedding")
        flag = argv[i + 1].lower() in ("true", "1")
        del argv[i:i + 2]
        if flag:
            return _run_label(argv)
    return _image_run(argv, project="movie_lavel")


def _run_label(argv) -> float:
    from nic_torch.data.assets import read_clip
    from nic_torch.io.artifacts import save_latent
    from nic_torch.obs.log import make_filename_by_seq
    from nic_torch.train.movie_label import MovieLabelTrainer

    parser = common.standard_parser(
        "per-frame label-embedding video compression",
        image_path="data/misty_64_64.avi", num_bits=8, num_epochs=50000)
    args = parser.parse_args(argv)
    name = common.save_name("movie_label", args)
    device, mesh, log = common.start(args, name)

    def out(*p):
        return os.path.join(args.output_root, *p)

    log(datetime.datetime.now())

    movie = read_clip(args.image_path).astype(np.float32) / 255.0
    trainer = MovieLabelTrainer(
        movie, num_bits=args.num_bits, latent_channels=args.latent_channels,
        hidden_channels=args.hidden_channels, num_epochs=args.num_epochs,
        lr=args.lr, seed=args.seed, qat_ste=args.qat_ste, device=device,
        mesh=mesh)
    with log.span("train time"):
        losses = trainer.train_many(args.num_epochs)
    log(f"loss: first {losses[0]:.6f}, last {losses[-1]:.6f}")
    with log.span("encode time"):
        latent = trainer.encode()
    main = common.is_main(trainer)
    if main:
        save_latent(out("comp", f"{name}.npy"), latent, args.num_bits)
    with log.span("decode time"):
        rec = trainer.decode(latent)
    p = common.report_video(log, movie, rec, make_filename_by_seq(
        out("image"), f"{name}.avi") if main else None)
    log(datetime.datetime.now())
    return p


if __name__ == "__main__":
    run(sys.argv[1:])
