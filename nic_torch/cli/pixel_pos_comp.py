"""pixel_comp with a sinusoidal positional encoding of (x, y) concatenated
to the MLP's input (port of ``nic.cli.pixel_pos_comp``: 8·4 latent + 4·2
PE = 40 inputs).

Run: ``python -m nic_torch.cli.pixel_pos_comp [--image_path ...]``
(pixel_comp's flags, ``--device`` included)."""

import sys

from nic_torch.cli.pixel_comp import run as _run


def run(argv=None) -> float:
    return _run(argv, project="pixel_pos", use_pe=True)


if __name__ == "__main__":
    run(sys.argv[1:])
