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

The scale-hyperprior model crosses the same way, under the keys of the
JAX trainer's checkpoint (``params/params/g_a/MatmulConv_0/kernel`` …,
and for ``chain(clip_by_global_norm, adam)`` the Adam state
``opt/1/0/.count``, ``opt/1/0/.mu/params/<leaf>``,
``opt/1/0/.nu/params/<leaf>``). A JAX conv kernel is ``[k²·Cin, Cout]``,
offset-major (rows in ``itertools.product`` order, blocks of Cin):
``Conv2d`` takes ``W[co, ci, ky, kx] = w[(ky·k + kx)·Cin + ci, co]``; a
transposed conv's ``w`` is the kernel of JAX's zero-inserted stride-1
conv, which ``ConvTranspose2d`` flips: ``W[ci, co, ky, kx] =
w[((k−1−ky)·k + (k−1−kx))·Cin + ci, co]``.
"""

from __future__ import annotations

import numpy as np
import torch

from nic_torch.models.mlp import PARAM_NAMES, MLPDecoder

__all__ = ["params_from_jax", "params_to_jax", "trainer_state_to_arrays",
           "trainer_state_from_arrays", "conv_to_jax", "conv_from_jax",
           "conv_transpose_to_jax", "conv_transpose_from_jax",
           "hyperprior_leaves", "hyperprior_to_jax", "hyperprior_from_jax",
           "hyperprior_state_to_arrays", "hyperprior_state_from_arrays"]


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


# ---- the scale-hyperprior model ------------------------------------------

def conv_to_jax(w: torch.Tensor) -> torch.Tensor:
    """``Conv2d`` weight [Cout, Cin, k, k] → JAX kernel [k²·Cin, Cout]."""
    co, ci, k, _ = w.shape
    return w.permute(2, 3, 1, 0).reshape(k * k * ci, co)


def conv_from_jax(w: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`conv_to_jax`."""
    ci = w.shape[0] // (k * k)
    return w.reshape(k, k, ci, w.shape[1]).permute(3, 2, 0, 1)


def conv_transpose_to_jax(w: torch.Tensor) -> torch.Tensor:
    """``ConvTranspose2d`` weight [Cin, Cout, k, k] → JAX kernel
    [k²·Cin, Cout] (the zero-inserted conv's, flipped)."""
    ci, co, k, _ = w.shape
    return w.flip(2, 3).permute(2, 3, 0, 1).reshape(k * k * ci, co)


def conv_transpose_from_jax(w: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`conv_transpose_to_jax`."""
    ci = w.shape[0] // (k * k)
    return w.reshape(k, k, ci, w.shape[1]).flip(0, 1).permute(2, 3, 0, 1)


def hyperprior_leaves(model) -> dict:
    """{JAX leaf path under ``params/``: (torch parameter, to JAX's layout,
    back)} of a ``nic_torch.models.hyperprior.HyperpriorModel``, in the
    model's order; flax names each submodule by class and count
    (``h_s/MatmulConvTranspose_1``, ``h_s/MatmulConv_0``)."""
    def ident(t):
        return t

    leaves = {}
    for part in ("g_a", "g_s", "h_a", "h_s"):
        counts: dict = {}
        for conv in getattr(model, part).convs:
            k = conv.kernel_size[0]
            if isinstance(conv, torch.nn.ConvTranspose2d):
                cls, to, back = ("MatmulConvTranspose", conv_transpose_to_jax,
                                 conv_transpose_from_jax)
            else:
                cls, to, back = "MatmulConv", conv_to_jax, conv_from_jax
            i = counts.get(cls, 0)
            counts[cls] = i + 1
            path = f"{part}/{cls}_{i}"
            leaves[f"{path}/kernel"] = (conv.weight, to,
                                        lambda t, k=k, back=back: back(t, k))
            leaves[f"{path}/bias"] = (conv.bias, ident, ident)
    leaves["z_mu"] = (model.z_mu, ident, ident)
    leaves["z_log_s"] = (model.z_log_s, ident, ident)
    return leaves


def hyperprior_to_jax(model, tensors: dict | None = None) -> dict:
    """{JAX leaf path: float32 numpy array in JAX's layout} of the model's
    parameters, or of ``tensors`` ({path: tensor shaped like its
    parameter}, e.g. gradients); copies, never views of the tensors."""
    return {path: np.array(_numpy(to(p if tensors is None
                                     else tensors[path])))
            for path, (p, to, _) in hyperprior_leaves(model).items()}


def hyperprior_from_jax(model, arrays: dict, prefix: str = "") -> None:
    """Load {``prefix`` + JAX leaf path: array} into the model (in place),
    checking every shape."""
    with torch.no_grad():
        for path, (p, to, back) in hyperprior_leaves(model).items():
            key = prefix + path
            arr = np.array(arrays[key], np.float32)
            want = tuple(to(p).shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"checkpoint field {key}: stored shape "
                                 f"{tuple(arr.shape)} != {want} — config/"
                                 "architecture mismatch")
            p.copy_(back(torch.from_numpy(arr)).to(p.device))


def hyperprior_state_to_arrays(model, opt) -> dict:
    """Params and the Adam state (``torch.optim.Adam``) → {npz key: array}
    under the JAX trainer's checkpoint keys."""
    arrays = {f"params/params/{k}": v
              for k, v in hyperprior_to_jax(model).items()}
    count = 0
    for path, (p, to, _) in hyperprior_leaves(model).items():
        st = opt.state.get(p)
        if st:
            count = int(st["step"])
            mu, nu = _numpy(to(st["exp_avg"])), _numpy(to(st["exp_avg_sq"]))
        else:
            mu = nu = np.zeros(tuple(to(p).shape), np.float32)
        arrays[f"opt/1/0/.mu/params/{path}"] = mu
        arrays[f"opt/1/0/.nu/params/{path}"] = nu
    arrays["opt/1/0/.count"] = np.asarray(count, np.int32)
    return arrays


def hyperprior_state_from_arrays(arrays: dict, model, opt) -> bool:
    """Load a JAX-keyed checkpoint into the model (in place) and, where it
    holds one, the Adam state; returns whether it did (a checkpoint of
    params alone, or another optimizer's layout, leaves Adam fresh, as
    the JAX trainer's loader does)."""
    hyperprior_from_jax(model, arrays, "params/params/")
    leaves = hyperprior_leaves(model)
    if "opt/1/0/.count" not in arrays or any(
            f"opt/1/0/.mu/params/{path}" not in arrays for path in leaves):
        return False
    count = int(np.asarray(arrays["opt/1/0/.count"]))
    with torch.no_grad():
        for path, (p, _, back) in leaves.items():
            if count == 0:
                opt.state.pop(p, None)
                continue

            def moment(name):
                arr = np.array(arrays[f"opt/1/0/.{name}/params/{path}"],
                                 np.float32)
                return back(torch.from_numpy(arr)).contiguous().to(p.device)

            opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": moment("mu"), "exp_avg_sq": moment("nu")}
    return True
