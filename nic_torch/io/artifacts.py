"""Compressed-artifact I/O (port of the artifact half of ``nic.io.artifacts``).

Training checkpoints are ``.npz`` files of flat arrays under the JAX
package's keys (``nic_torch.io.convert.trainer_state_to_arrays``) plus a
``__meta__`` JSON blob with the step, so a run started by either package
resumes in the other.

One ``.npz`` holds the decoder MLP (keys ``mlp/w1`` … ``mlp/b3``, weights
``[in, out]``), the bit-packed pyramid (``grid{i}``, fixed-length b-bit
codes) and a ``__meta__`` JSON blob. The format is the JAX package's, so
an artifact written by either package decodes in the other.

The conv-AE family's latent is a uint8 ``.npy`` of its codes
(:func:`save_latent`), the JAX package's bytes.

With ``entropy_coded=True`` each grid's codes are rANS-coded against
their own histogram instead (``grid{i}`` the stream, ``hist{i}`` the
2^bits counts, one CDF row, every bin 0; ``nic_torch.native``), with
``meta["rans_format"]`` (3 or 2, informational: the decoder reads the
magic; 1, or no key, means a legacy format-1 stream). The bytes are the
JAX package's for the same codes.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from nic_torch.core.quant import pack_bits, pack_grid, unpack_bits, unpack_grid
from nic_torch.models.mlp import PARAM_NAMES, MLPDecoder

__all__ = ["save_compressed", "load_compressed", "compressed_num_bits",
           "artifact_meta",
           "save_latent", "load_latent", "save_checkpoint",
           "load_checkpoint", "CheckpointManager"]

def _grid_cdf(hist: np.ndarray) -> np.ndarray:
    """One CDF row from a grid's code histogram (the JAX package's)."""
    from nic_torch.io.entropy import quantize_pmf

    return quantize_pmf(hist / max(1, hist.sum()))[None, :]


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
    ``mlp_store_bits=16`` stores the decoder weights as float16;
    ``entropy_coded=True`` rANS-codes each grid against its histogram."""
    from nic_torch.native import rans_encode

    arrays: dict = {}
    shapes = []
    for i, g in enumerate(pyramid):
        codes = pack_grid(g, fp_bits).cpu().numpy()
        shapes.append(list(codes.shape))
        if entropy_coded:
            flat = codes.reshape(-1)
            hist = np.bincount(flat, minlength=2**fp_bits).astype(np.int64)
            blob = rans_encode(flat.astype(np.int32),
                               np.zeros(flat.size, np.int32),
                               _grid_cdf(hist))
            arrays[f"grid{i}"] = np.frombuffer(blob, np.uint8)
            arrays[f"hist{i}"] = hist
        else:
            arrays[f"grid{i}"] = pack_bits(codes, fp_bits)
    store = np.float16 if mlp_store_bits == 16 else np.float32
    mlp = {k: mlp_params[k].detach().cpu().numpy().astype(store)
           for k in PARAM_NAMES}
    arrays.update({f"mlp/{k}": v for k, v in mlp.items()})
    meta = dict(meta, fp_bits=fp_bits, grid_shapes=shapes,
                entropy_coded=entropy_coded)
    if entropy_coded:
        meta["rans_format"] = (3 if arrays["grid0"][:4].tobytes()
                               == b"NR3\x01" else 2)
        code_bits = sum(arrays[f"grid{i}"].size * 8
                        + arrays[f"hist{i}"].size * 32
                        for i in range(len(shapes)))
    else:
        code_bits = sum(int(np.prod(s)) for s in shapes) * fp_bits
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    _atomic_savez(path, **arrays)
    return code_bits + sum(v.size * v.dtype.itemsize * 8
                           for v in mlp.values())


def load_compressed(path: str, *, device) -> tuple[MLPDecoder, tuple, dict]:
    """Read the artifact → (MLPDecoder, pyramid, meta) on ``device``, in
    float32. The decoder's parameters do not require grad (this is the
    decode path)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        fp_bits = meta["fp_bits"]
        pyramid = []
        for i, shape in enumerate(meta["grid_shapes"]):
            count = int(np.prod(shape))
            if meta.get("entropy_coded"):
                from nic_torch.native import rans_decode

                codes = rans_decode(
                    z[f"grid{i}"].tobytes(), np.zeros(count, np.int32),
                    _grid_cdf(z[f"hist{i}"]),
                    legacy=meta.get("rans_format", 1) == 1).astype(np.uint8)
            else:
                codes = unpack_bits(z[f"grid{i}"], fp_bits, count)
            codes = torch.from_numpy(codes.reshape(shape)).to(device)
            pyramid.append(unpack_grid(codes, fp_bits))
        params = {k: torch.from_numpy(z[f"mlp/{k}"]).to(device=device,
                                                         dtype=torch.float32)
                  for k in PARAM_NAMES}
    return MLPDecoder(params, requires_grad=False), tuple(pyramid), meta


def artifact_meta(path: str) -> dict:
    """A saved artifact's ``__meta__`` (its config, bits, grid shapes and
    whether its grids are rANS-coded)."""
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


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


def save_latent(path: str, latent_codes, num_bits: int) -> None:
    """Conv-AE / pixel latent codes (0..2^b − 1) → a uint8 ``.npy``, the
    JAX package's bytes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, np.asarray(latent_codes).astype(np.uint8))


def load_latent(path: str, num_bits: int, *, device="cpu",
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 ``.npy`` → the dequantized latent in [0, 1], in the file's
    (the JAX package's, channels-last) layout."""
    codes = torch.from_numpy(np.load(path)).to(device=device, dtype=dtype)
    return codes / (2.0**num_bits - 1.0)


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
