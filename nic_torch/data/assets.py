"""Host-side image I/O (part of the port of ``nic.data.assets``).

``save_png`` is written with the standard library alone (``zlib`` and
``struct``), so a decode can be written where PIL is not installed;
``load_image_mips`` keeps the JAX package's PIL resize, imported lazily.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["load_image_mips", "save_png"]


def load_image_mips(path: str, image_size: int, max_mip_level: int,
                    image_size_w: int = 0) -> list[np.ndarray]:
    """RGB image → list of [3, H/2^i, W/2^i] float32 mips in [0,1], each a
    bilinear resize of the original (not successive halving)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w0 = image_size_w or image_size
    mips = []
    for i in range(max_mip_level + 1):
        h, w = image_size // (2**i), w0 // (2**i)
        resized = img if (w, h) == img.size else img.resize((w, h),
                                                            Image.BILINEAR)
        arr = np.asarray(resized, dtype=np.float32) / 255.0  # [H, W, 3]
        mips.append(arr.transpose(2, 0, 1))
    return mips


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(image_u8: np.ndarray, path: str) -> None:
    """[H, W, 3] uint8 → an 8-bit RGB PNG (colour type 2, filter 0 rows)."""
    img = np.ascontiguousarray(image_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"save_png takes [H, W, 3] uint8, got {img.shape} "
                         f"{img.dtype}")
    h, w, _ = img.shape
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))
