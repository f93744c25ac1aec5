"""Workload dispatcher: ``python -m nic_torch.cli <workload> [args...]``
(port of ``nic.cli.__main__``, the same workload names)."""

from __future__ import annotations

import sys

WORKLOADS = {
    "pixel_comp": "nic_torch.cli.pixel_comp",
    "pixel_pos_comp": "nic_torch.cli.pixel_pos_comp",
    "image_comp": "nic_torch.cli.image_comp",
    "movie_lavel_comp": "nic_torch.cli.movie_lavel_comp",
    "movie_frame_comp": "nic_torch.cli.movie_frame_comp",
    "movie_2d_comp": "nic_torch.cli.movie_2d_comp",
    "movie_3d_comp": "nic_torch.cli.movie_3d_comp",
    "image_compression": "nic_torch.cli.image_compression",
    "hyperprior_comp": "nic_torch.cli.hyperprior_comp",
    "decode": "nic_torch.cli.decode",
}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m nic_torch.cli <workload> [args...]\n"
              "workloads:")
        for name in WORKLOADS:
            print(f"  {name}")
        raise SystemExit(0 if argv else 1)
    name = argv[0]
    if name not in WORKLOADS:
        raise SystemExit(f"unknown workload {name!r}; try --help")
    import importlib

    importlib.import_module(WORKLOADS[name]).run(argv[1:])


if __name__ == "__main__":
    main()
