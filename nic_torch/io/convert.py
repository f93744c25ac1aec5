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
w[((k−1−ky)·k + (k−1−kx))·Cin + ci, co]``; 3D kernels likewise over
(kz, ky, kx).

The conv-AE family (``nic_torch.train.conv_ae``, ``pixel``,
``movie_label``) crosses the same way: a trainer's leaves are
:func:`conv_leaves` of its convs (``enc/params/MatmulConv_0`` … in the
``conv_impl="matmul"`` trees the JAX CLIs write, ``enc/params/Conv_0`` …
in flax's ``"xla"`` trees), plus :func:`plain_leaves` (the pixel MLP)
and the movie-label embedding; optax ``adam``'s state is
``opt/0/.count``, ``opt/0/.mu/<leaf>``, ``opt/0/.nu/<leaf>``
(:func:`adam_to_arrays`).
"""

from __future__ import annotations

import numpy as np
import torch

from nic_torch.models.mlp import PARAM_NAMES, MLPDecoder

__all__ = ["params_from_jax", "params_to_jax", "trainer_state_to_arrays",
           "trainer_state_from_arrays", "conv_to_jax", "conv_from_jax",
           "conv_transpose_to_jax", "conv_transpose_from_jax",
           "conv_leaves", "plain_leaves", "conv_impl_of", "leaves_to_jax",
           "leaves_from_jax", "adam_to_arrays", "adam_from_arrays",
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


# ---- conv models: the scale-hyperprior and the conv-AE family ------------

def conv_to_jax(w: torch.Tensor) -> torch.Tensor:
    """``Conv{2,3}d`` weight [Cout, Cin, k, …] → JAX kernel [kⁿ·Cin, Cout]."""
    nd = w.dim() - 2
    return w.permute(*range(2, 2 + nd), 1, 0).reshape(-1, w.shape[0])


def conv_from_jax(w: torch.Tensor, k: int, ndim: int = 2) -> torch.Tensor:
    """Inverse of :func:`conv_to_jax`."""
    ci = w.shape[0] // k**ndim
    return w.reshape(*(k,) * ndim, ci, w.shape[1]).permute(
        ndim + 1, ndim, *range(ndim))


def conv_transpose_to_jax(w: torch.Tensor) -> torch.Tensor:
    """``ConvTranspose{2,3}d`` weight [Cin, Cout, k, …] → JAX kernel
    [kⁿ·Cin, Cout] (the zero-inserted conv's, flipped)."""
    nd = w.dim() - 2
    sp = tuple(range(2, 2 + nd))
    return w.flip(sp).permute(*sp, 0, 1).reshape(-1, w.shape[1])


def conv_transpose_from_jax(w: torch.Tensor, k: int,
                            ndim: int = 2) -> torch.Tensor:
    """Inverse of :func:`conv_transpose_to_jax`."""
    ci = w.shape[0] // k**ndim
    return w.reshape(*(k,) * ndim, ci, w.shape[1]).flip(
        tuple(range(ndim))).permute(ndim, ndim + 1, *range(ndim))


def _ident(t):
    return t


def conv_leaves(convs, prefix: str, impl: str = "matmul") -> dict:
    """{JAX leaf path: (torch parameter, to JAX's layout, back)} of a list
    of convs under ``prefix``, as flax names them: each class counted on
    its own. ``impl="matmul"``: ``MatmulConv_i`` / ``MatmulConvTranspose_i``,
    kernels [kⁿ·Cin, Cout]; ``impl="xla"``: flax's ``Conv_i`` (kernel
    [k, …, Cin, Cout]) / ``ConvTranspose_i`` with ``transpose_kernel=True``
    (kernel [k, …, Cout, Cin], the forward conv's, unflipped)."""
    if impl not in ("matmul", "xla"):
        raise ValueError(f"conv_impl must be matmul or xla, not {impl!r}")
    leaves, counts = {}, {}
    for conv in convs:
        k, nd = conv.kernel_size[0], len(conv.kernel_size)
        sp = tuple(range(nd))
        if conv.transposed and impl == "matmul":
            cls, to, back = ("MatmulConvTranspose", conv_transpose_to_jax,
                             lambda t, k=k, nd=nd: conv_transpose_from_jax(
                                 t, k, nd))
        elif impl == "matmul":
            cls, to, back = ("MatmulConv", conv_to_jax,
                             lambda t, k=k, nd=nd: conv_from_jax(t, k, nd))
        else:
            cls = "ConvTranspose" if conv.transposed else "Conv"

            def to(t, nd=nd):
                return t.permute(*range(2, 2 + nd), 1, 0)

            def back(t, sp=sp, nd=nd):
                return t.permute(nd + 1, nd, *sp)
        i = counts.get(cls, 0)
        counts[cls] = i + 1
        path = f"{prefix}/{cls}_{i}"
        leaves[f"{path}/kernel"] = (conv.weight, to, back)
        leaves[f"{path}/bias"] = (conv.bias, _ident, _ident)
    return leaves


def plain_leaves(tensors: dict, prefix: str) -> dict:
    """Leaves that keep JAX's layout ({name: tensor} under ``prefix``)."""
    return {f"{prefix}/{k}": (t, _ident, _ident) for k, t in tensors.items()}


def conv_impl_of(arrays: dict, prefix: str) -> str:
    """``"matmul"`` or ``"xla"``: which JAX tree a checkpoint's convs under
    ``prefix`` (e.g. ``params/enc/params/``) hold."""
    if any(k.startswith(prefix + "MatmulConv") for k in arrays):
        return "matmul"
    if any(k.startswith(prefix + "Conv") for k in arrays):
        return "xla"
    raise KeyError(f"no conv parameters under {prefix!r}")


def leaves_to_jax(leaves: dict, tensors: dict | None = None) -> dict:
    """{JAX leaf path: float32 numpy array in JAX's layout} of the leaves'
    parameters, or of ``tensors`` ({path: tensor shaped like its
    parameter}, e.g. gradients); copies, never views of the tensors."""
    return {path: np.array(_numpy(to(p if tensors is None
                                     else tensors[path])))
            for path, (p, to, _) in leaves.items()}


def leaves_from_jax(leaves: dict, arrays: dict, prefix: str = "") -> None:
    """Load {``prefix`` + JAX leaf path: array} into the leaves' parameters
    (in place), checking every shape."""
    with torch.no_grad():
        for path, (p, to, back) in leaves.items():
            key = prefix + path
            arr = np.array(arrays[key], np.float32)
            want = tuple(to(p).shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"checkpoint field {key}: stored shape "
                                 f"{tuple(arr.shape)} != {want} — config/"
                                 "architecture mismatch")
            p.copy_(back(torch.from_numpy(arr)).to(p.device))


def adam_to_arrays(leaves: dict, opt, prefix: str) -> dict:
    """optax ``scale_by_adam``'s state of a ``torch.optim.Adam`` over the
    leaves: ``{prefix}/.count``, ``{prefix}/.mu/<path>``,
    ``{prefix}/.nu/<path>`` (zeros for a parameter not stepped yet)."""
    arrays, count = {}, 0
    for path, (p, to, _) in leaves.items():
        st = opt.state.get(p)
        if st:
            count = int(st["step"])
            mu, nu = _numpy(to(st["exp_avg"])), _numpy(to(st["exp_avg_sq"]))
        else:
            mu = nu = np.zeros(tuple(to(p).shape), np.float32)
        arrays[f"{prefix}/.mu/{path}"] = mu
        arrays[f"{prefix}/.nu/{path}"] = nu
    arrays[f"{prefix}/.count"] = np.asarray(count, np.int32)
    return arrays


def adam_from_arrays(arrays: dict, leaves: dict, opt, prefix: str) -> bool:
    """Load :func:`adam_to_arrays`'s layout into ``opt``; returns whether
    the arrays held it (else ``opt`` is left as it was)."""
    if f"{prefix}/.count" not in arrays or any(
            f"{prefix}/.mu/{path}" not in arrays for path in leaves):
        return False
    count = int(np.asarray(arrays[f"{prefix}/.count"]))
    with torch.no_grad():
        for path, (p, _, back) in leaves.items():
            if count == 0:
                opt.state.pop(p, None)
                continue

            def moment(name):
                arr = np.array(arrays[f"{prefix}/.{name}/{path}"],
                               np.float32)
                return back(torch.from_numpy(arr)).contiguous().to(p.device)

            opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": moment("mu"), "exp_avg_sq": moment("nu")}
    return True


def hyperprior_leaves(model) -> dict:
    """{JAX leaf path under ``params/``: (torch parameter, to JAX's layout,
    back)} of a ``nic_torch.models.hyperprior.HyperpriorModel``, in the
    model's order; flax names each submodule by class and count
    (``h_s/MatmulConvTranspose_1``, ``h_s/MatmulConv_0``)."""
    leaves = {}
    for part in ("g_a", "g_s", "h_a", "h_s"):
        leaves.update(conv_leaves(getattr(model, part).convs, part))
    leaves["z_mu"] = (model.z_mu, _ident, _ident)
    leaves["z_log_s"] = (model.z_log_s, _ident, _ident)
    return leaves


def hyperprior_to_jax(model, tensors: dict | None = None) -> dict:
    """:func:`leaves_to_jax` of the model's :func:`hyperprior_leaves`."""
    return leaves_to_jax(hyperprior_leaves(model), tensors)


def hyperprior_from_jax(model, arrays: dict, prefix: str = "") -> None:
    """:func:`leaves_from_jax` of the model's :func:`hyperprior_leaves`."""
    leaves_from_jax(hyperprior_leaves(model), arrays, prefix)


# optax.chain(clip_by_global_norm, adam): adam's state is the chain's 1st
_HP_ADAM = "opt/1/0"


def hyperprior_state_to_arrays(model, opt) -> dict:
    """Params and the Adam state (``torch.optim.Adam``) → {npz key: array}
    under the JAX trainer's checkpoint keys."""
    leaves = {f"params/{k}": v for k, v in hyperprior_leaves(model).items()}
    arrays = {f"params/{k}": v for k, v in leaves_to_jax(leaves).items()}
    arrays.update(adam_to_arrays(leaves, opt, _HP_ADAM))
    return arrays


def hyperprior_state_from_arrays(arrays: dict, model, opt) -> bool:
    """Load a JAX-keyed checkpoint into the model (in place) and, where it
    holds one, the Adam state; returns whether it did (a checkpoint of
    params alone, or another optimizer's layout, leaves Adam fresh, as
    the JAX trainer's loader does)."""
    leaves = {f"params/{k}": v for k, v in hyperprior_leaves(model).items()}
    leaves_from_jax(leaves, arrays, "params/")
    return adam_from_arrays(arrays, leaves, opt, _HP_ADAM)
