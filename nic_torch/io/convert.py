"""Parameters between the JAX package and the port.

The JAX package holds a pyramid as a tuple of ``[C, s+1, s+1]`` arrays and
the decoder as a dict of ``[in, out]`` weights; the port keeps the same
layouts, so conversion is a copy through numpy with no transposes. Any
array type numpy can read (JAX arrays included) is accepted, and nothing
here imports JAX.

A trainer state (params plus the two Adam states) crosses as the flat
arrays of the JAX package's checkpoint, under its keys: ``params/fp/i``,
``params/mlp/w1`` …, and for each optimizer (``fp``, ``mlp``) optax's
``adam`` state ``opt/<g>/0/.count``, ``opt/<g>/0/.mu/<leaf>``,
``opt/<g>/0/.nu/<leaf>`` and the schedule's ``opt/<g>/1/.count``. The
Adam count is torch's per-parameter ``step``.
"""

from __future__ import annotations

import numpy as np
import torch

from nic_torch.models.mlp import PARAM_NAMES, MLPDecoder

__all__ = ["params_from_jax", "params_to_jax", "trainer_state_to_arrays",
           "trainer_state_from_arrays"]


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


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(device="cpu", dtype=torch.float32).numpy()


def _adam_to_arrays(opt, leaves: dict, prefix: str) -> dict:
    out = {}
    count = 0
    for name, p in leaves.items():
        st = opt.state.get(p)
        if st:
            count = int(st["step"])
            mu, nu = _numpy(st["exp_avg"]), _numpy(st["exp_avg_sq"])
        else:
            mu = nu = np.zeros(tuple(p.shape), np.float32)
        out[f"{prefix}/0/.mu/{name}"] = mu
        out[f"{prefix}/0/.nu/{name}"] = nu
    out[f"{prefix}/0/.count"] = np.asarray(count, np.int32)
    out[f"{prefix}/1/.count"] = np.asarray(count, np.int32)
    return out


def _leaves(fp, mlp) -> tuple[dict, dict]:
    return ({str(i): g for i, g in enumerate(fp)},
            {k: mlp[k] for k in PARAM_NAMES})


def trainer_state_to_arrays(fp, mlp, opt_fp, opt_mlp) -> dict:
    """Params and Adam states → {npz key: numpy array}."""
    fp_leaves, mlp_leaves = _leaves(fp, mlp)
    arrays = {f"params/fp/{k}": _numpy(g) for k, g in fp_leaves.items()}
    arrays.update({f"params/mlp/{k}": _numpy(v)
                   for k, v in mlp_leaves.items()})
    arrays.update(_adam_to_arrays(opt_fp, fp_leaves, "opt/fp"))
    arrays.update(_adam_to_arrays(opt_mlp, mlp_leaves, "opt/mlp"))
    return arrays


def _take(arrays: dict, key: str, like: torch.Tensor) -> torch.Tensor:
    arr = np.asarray(arrays[key])
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint field {key}: stored shape "
                         f"{tuple(arr.shape)} != {tuple(like.shape)} — "
                         "config/architecture mismatch")
    return torch.from_numpy(arr.astype(np.float32)).to(like.device)


def trainer_state_from_arrays(arrays: dict, fp, mlp, opt_fp,
                              opt_mlp) -> None:
    """Load {npz key: array} into the trainer's params (in place) and its
    two Adam optimizers."""
    fp_leaves, mlp_leaves = _leaves(fp, mlp)
    for group, leaves, opt in (("fp", fp_leaves, opt_fp),
                               ("mlp", mlp_leaves, opt_mlp)):
        count = int(np.asarray(arrays[f"opt/{group}/0/.count"]))
        with torch.no_grad():
            for name, p in leaves.items():
                p.copy_(_take(arrays, f"params/{group}/{name}", p))
                if count == 0:
                    opt.state.pop(p, None)
                    continue
                opt.state[p] = {
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": _take(arrays, f"opt/{group}/0/.mu/{name}", p),
                    "exp_avg_sq": _take(arrays, f"opt/{group}/0/.nu/{name}",
                                        p),
                }
