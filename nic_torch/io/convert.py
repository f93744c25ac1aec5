"""Parameters between the JAX package and the port.

The JAX package holds a pyramid as a tuple of ``[C, s+1, s+1]`` arrays and
the decoder as a dict of ``[in, out]`` weights; the port keeps the same
layouts, so conversion is a copy through numpy with no transposes. Any
array type numpy can read (JAX arrays included) is accepted, and nothing
here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from nic_torch.models.mlp import PARAM_NAMES, MLPDecoder

__all__ = ["params_from_jax", "params_to_jax"]


def params_from_jax(fp, mlp, device) -> tuple[tuple, MLPDecoder]:
    """(pyramid arrays, MLP dict) from the JAX package → (tuple of float32
    tensors, :class:`MLPDecoder` without grad) on ``device``."""
    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    grids = tuple(tensor(g) for g in fp)
    return grids, MLPDecoder({k: tensor(mlp[k]) for k in PARAM_NAMES},
                             requires_grad=False)


def params_to_jax(fp, mlp) -> tuple[tuple, dict]:
    """Inverse of :func:`params_from_jax`: float32 numpy arrays the JAX
    package takes as they are."""
    def array(t):
        return t.detach().to(device="cpu", dtype=torch.float32).numpy()

    return tuple(array(g) for g in fp), {k: array(mlp[k]) for k in PARAM_NAMES}
