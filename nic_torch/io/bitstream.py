"""The hyperprior bitstream container (.nicx), port of
``nic.io.bitstream``; the format is the JAX package's, so a file written
by either package reads in the other:

    magic  b"NICX\\x02"
    u32le  header length
    JSON   header: a_y, a_z, y_shape, z_shape, hw, len_y, len_z,
           rans_format, model: {n, m, params_digest}
    bytes  y stream (rANS, self-describing format-2/3 header)
    bytes  z stream

``y_shape`` and ``z_shape`` are JAX's NHWC shapes ([1, h, w, C]): the
streams are the latents flattened channel-fastest.

The params digest binds a bitstream to the checkpoint that encoded it:
σ comes from the decoded z through the model's hyper-synthesis, so a
decode with another model gives garbage, and callers check the digest.
It hashes the tree's structure string as JAX prints it
(``PyTreeDef({'params': {'g_a': …``), rebuilt here without JAX, then
each leaf's dtype, shape and bytes in JAX's layout.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct

import numpy as np

__all__ = ["params_digest", "nest", "write_nicx", "read_nicx", "NICX_MAGIC"]

# \x02: the JAX package's second format, whose bins come from σ in fp32
# (the first mapped σ in float64 on the host, so a boundary σ could bin
# differently); older streams are refused by the magic.
NICX_MAGIC = b"NICX\x02"


def _treedef(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` of a tree of nested
    dicts, without JAX: keys sorted, leaves ``*``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def nest(flat: dict) -> dict:
    """{"a/b/c": leaf} → {"a": {"b": {"c": leaf}}}."""
    out: dict = {}
    for key, leaf in flat.items():
        node = out
        *parts, last = key.split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def params_digest(params: dict) -> str:
    """Order-stable blake2b fingerprint of a model's parameter tree (nested
    dicts of arrays in the JAX package's layouts, e.g. ``{"params":
    {"g_a": {"MatmulConv_0": {"bias": …, "kernel": …}}, …}}``): the JAX
    package's digest of the same tree, byte for byte."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"PyTreeDef({_treedef(params)})".encode())
    for leaf in _leaves(params):
        a = np.asarray(leaf)
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def write_nicx(path: str, blob: dict, model_info: dict) -> int:
    """Serialize a ``HyperpriorCodec`` blob; returns the bytes written."""
    header = {
        "a_y": int(blob["a_y"]),
        "a_z": int(blob["a_z"]),
        "y_shape": [int(v) for v in blob["y_shape"]],
        "z_shape": [int(v) for v in blob["z_shape"]],
        "hw": [int(v) for v in blob["hw"]],
        "len_y": len(blob["y"]),
        "len_z": len(blob["z"]),
        "rans_format": 3 if blob["y"][:4] == b"NR3\x01" else 2,
        "model": model_info,
    }
    payload = json.dumps(header, sort_keys=True).encode()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(NICX_MAGIC)
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
        f.write(blob["y"])
        f.write(blob["z"])
    os.replace(tmp, path)  # atomic, like the artifact writer
    return len(NICX_MAGIC) + 4 + len(payload) + len(blob["y"]) + len(blob["z"])


def read_nicx(path: str) -> tuple[dict, dict]:
    """Read a .nicx file → (blob dict for HyperpriorCodec.decompress,
    header's ``model`` info for the caller to verify)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(NICX_MAGIC):
        raise ValueError(f"{path}: not a .nicx bitstream (bad magic)")
    (hlen,) = struct.unpack_from("<I", data, len(NICX_MAGIC))
    off = len(NICX_MAGIC) + 4
    header = json.loads(data[off : off + hlen].decode())
    off += hlen
    y = data[off : off + header["len_y"]]
    off += header["len_y"]
    z = data[off : off + header["len_z"]]
    if len(y) != header["len_y"] or len(z) != header["len_z"]:
        raise ValueError(f"{path}: truncated bitstream")
    blob = {
        "y": y,
        "z": z,
        "a_y": header["a_y"],
        "a_z": header["a_z"],
        "y_shape": tuple(header["y_shape"]),
        "z_shape": tuple(header["z_shape"]),
        "hw": tuple(header["hw"]),
    }
    return blob, header.get("model", {})
