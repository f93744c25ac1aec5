"""Compressed-artifact I/O (port of the artifact half of ``nic.io.artifacts``).

Training checkpoints are ``.npz`` files of flat arrays under the JAX
package's keys (``nic_torch.io.convert.trainer_state_to_arrays``) plus a
``__meta__`` JSON blob with the step, so a run started by either package
resumes in the other.

One ``.npz`` holds the decoder MLP (keys ``mlp/w1`` … ``mlp/b3``, weights
``[in, out]``), the bit-packed pyramid (``grid{i}``, fixed-length b-bit
codes) and a ``__meta__`` JSON blob. The format is the JAX package's, so
an artifact written by either package decodes in the other.

Entropy-coded (rANS) artifacts are refused on both save and load: the
rANS coder comes to the port with the hyperprior codec (ROADMAP.md,
queue 1, item 12).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from nic_torch.core.quant import pack_bits, pack_grid, unpack_bits, unpack_grid
from nic_torch.models.mlp import PARAM_NAMES, MLPDecoder

__all__ = ["save_compressed", "load_compressed", "compressed_num_bits",
           "save_checkpoint", "load_checkpoint", "CheckpointManager"]

_NO_RANS = ("entropy-coded (rANS) artifacts are not supported by nic_torch "
            "yet: the rANS coder is ported with the hyperprior codec "
            "(ROADMAP.md, queue 1, item 12)")


def _atomic_savez(path: str, **arrays) -> None:
    """np.savez to a temporary file beside ``path``, then os.replace, so a
    kill mid-write never leaves a truncated artifact."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_compressed(path: str, mlp_params, pyramid, fp_bits: int, meta: dict,
                    mlp_store_bits: int = 32,
                    entropy_coded: bool = False) -> int:
    """Write the single-file artifact; returns payload bits (pyramid codes
    plus MLP params at their stored width) for bpp accounting.
    ``mlp_store_bits=16`` stores the decoder weights as float16."""
    if entropy_coded:
        raise NotImplementedError(_NO_RANS)
    arrays: dict = {}
    shapes = []
    for i, g in enumerate(pyramid):
        codes = pack_grid(g, fp_bits).cpu().numpy()
        shapes.append(list(codes.shape))
        arrays[f"grid{i}"] = pack_bits(codes, fp_bits)
    store = np.float16 if mlp_store_bits == 16 else np.float32
    mlp = {k: mlp_params[k].detach().cpu().numpy().astype(store)
           for k in PARAM_NAMES}
    arrays.update({f"mlp/{k}": v for k, v in mlp.items()})
    meta = dict(meta, fp_bits=fp_bits, grid_shapes=shapes,
                entropy_coded=False)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    _atomic_savez(path, **arrays)
    return (sum(int(np.prod(s)) for s in shapes) * fp_bits
            + sum(v.size * v.dtype.itemsize * 8 for v in mlp.values()))


def load_compressed(path: str, *, device) -> tuple[MLPDecoder, tuple, dict]:
    """Read the artifact → (MLPDecoder, pyramid, meta) on ``device``, in
    float32. The decoder's parameters do not require grad (this is the
    decode path)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("entropy_coded"):
            raise NotImplementedError(_NO_RANS)
        fp_bits = meta["fp_bits"]
        pyramid = []
        for i, shape in enumerate(meta["grid_shapes"]):
            codes = unpack_bits(z[f"grid{i}"], fp_bits, int(np.prod(shape)))
            codes = torch.from_numpy(codes.reshape(shape)).to(device)
            pyramid.append(unpack_grid(codes, fp_bits))
        params = {k: torch.from_numpy(z[f"mlp/{k}"]).to(device=device,
                                                         dtype=torch.float32)
                  for k in PARAM_NAMES}
    return MLPDecoder(params, requires_grad=False), tuple(pyramid), meta


def compressed_num_bits(path: str) -> int:
    """True payload bits of a saved artifact from what it stores: code
    bits (or, for an entropy-coded artifact, blob and histogram sizes)
    plus the MLP params at their stored dtype."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("entropy_coded"):
            bits = sum(int(z[f"grid{i}"].size) * 8
                       + int(z[f"hist{i}"].size) * 32
                       for i in range(len(meta["grid_shapes"])))
        else:
            bits = (sum(int(np.prod(s)) for s in meta["grid_shapes"])
                    * meta["fp_bits"])
        for key in z.files:
            if key.startswith("mlp/"):
                bits += z[key].size * z[key].dtype.itemsize * 8
    return bits


def save_checkpoint(path: str, step: int, arrays: dict,
                    extra: dict | None = None) -> None:
    """Step-tagged training snapshot; atomic (temporary file + replace)."""
    arrays = dict(arrays)
    meta = {"step": step, **(extra or {})}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    _atomic_savez(path, **arrays)


def load_checkpoint(path: str) -> tuple[int, dict, dict]:
    """(step, {key: array}, meta) of a checkpoint from either package."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return meta["step"], arrays, meta


class CheckpointManager:
    """Step-tagged checkpoints in one directory, keeping the newest
    ``keep``; the writer saves to :meth:`path_for` and calls
    :meth:`prune`."""

    name = "ckpt"
    keep = 2

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.name}_{step:012d}.npz")

    def steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.directory):
            if f.startswith(self.name + "_") and f.endswith(".npz"):
                try:
                    out.append(int(f[len(self.name) + 1:-4]))
                except ValueError:
                    pass
        return sorted(out)

    def prune(self) -> None:
        for old in self.steps()[:-self.keep]:
            os.remove(self.path_for(old))

    def paths_newest_first(self) -> list[str]:
        return [self.path_for(s) for s in reversed(self.steps())]
