"""Frame-flattened video compression at the reference's production scale
(port of ``nic.cli.movie_2d_comp``): movie_frame_comp's tiling, scalars,
checkpoints and resume, with 3.2M epochs unless ``--num_epochs`` says
otherwise.

Run: ``python -m nic_torch.cli.movie_2d_comp --image_path
data/misty_64_64.avi`` (movie_frame_comp's flags, ``--device``
included)."""

import sys

from nic_torch.cli import movie_frame_comp


def run(argv=None) -> float:
    argv = list(argv) if argv is not None else sys.argv[1:]
    if not any(a.startswith("--num_epochs") for a in argv):
        argv = ["--num_epochs", "3200000"] + argv  # the reference's scale
    return movie_frame_comp.run(argv, project="movie_2d")


if __name__ == "__main__":
    run(sys.argv[1:])
