"""Host-side asset I/O: images, AVI clips, LUT volumes (port of
``nic.data.assets``).

``save_png`` and the AVI pair are written with the standard library alone
(``zlib``, ``struct``), so a decode can be written where PIL and OpenCV
are not installed; ``load_image_mips`` keeps the JAX package's PIL
resize, imported lazily. The AVI reader takes the uncompressed DIB AVIs
the repository bundles (``data/misty_*.avi``) bit for bit as the JAX
package reads them. The writer differs from the JAX package's in its
codec: ``write_timelaps`` writes the same [T, H, W, 3] uint8 frames as an
uncompressed 24-bit DIB AVI (the inverse of the reader, lossless), where
the JAX package encodes mp4v through OpenCV. Other video formats, which
the JAX package reads through OpenCV, are refused.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["asset_kind", "load_image_mips", "read_clip", "write_timelaps",
           "load_volume", "flatten_3d_to_2d", "unflatten_2d_to_3d",
           "save_png", "save_lut_csv"]


def asset_kind(path: str) -> str:
    """File extension → data kind: ``ndarray`` (npy/npz), ``movie``
    (avi/mp4) or ``image`` (png/jpg)."""
    ext = os.path.splitext(path)[1][1:].lower()
    if ext in ("npy", "npz"):
        return "ndarray"
    if ext in ("avi", "mp4"):
        return "movie"
    if ext in ("png", "jpg", "jpeg"):
        return "image"
    raise ValueError(f"unsupported asset extension: {ext!r}")


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


# ---- AVI clips: uncompressed 24-bit DIB video ----------------------------

def _riff_chunks(data: bytes, start: int, end: int):
    """(fourcc, payload start, payload size) over a run of RIFF chunks."""
    pos = start
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def _read_avi_raw_dib(path: str) -> np.ndarray | None:
    """Frames of an AVI carrying uncompressed DIB video ('00db' chunks,
    BI_RGB 24-bit) → [T, H, W, 3] uint8 in the file's BGR order, top row
    first; None if the file is not such an AVI."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        return None
    strf = data.find(b"strf")
    if strf < 0:
        return None
    bih = data[strf + 8:strf + 8 + 40]  # BITMAPINFOHEADER
    width = int.from_bytes(bih[4:8], "little", signed=True)
    height = int.from_bytes(bih[8:12], "little", signed=True)
    bit_count = int.from_bytes(bih[14:16], "little")
    compression = int.from_bytes(bih[16:20], "little")
    if compression != 0 or bit_count != 24:
        return None
    bottom_up = height > 0
    height = abs(height)
    row_bytes = (width * 3 + 3) & ~3  # rows padded to 4 bytes
    pos = data.find(b"movi")
    if pos < 0:
        return None
    frames = []
    for fourcc, payload, size in _riff_chunks(data, pos + 4, len(data)):
        if fourcc[2:4] in (b"db", b"dc") and size >= row_bytes * height:
            raw = np.frombuffer(data, np.uint8, count=row_bytes * height,
                                offset=payload)
            frame = raw.reshape(height, row_bytes)[:, :width * 3]
            frame = frame.reshape(height, width, 3)
            frames.append(frame[::-1] if bottom_up else frame)
    if not frames:
        return None
    return np.stack(frames)


def read_clip(path: str) -> np.ndarray:
    """An uncompressed DIB AVI → [T, H, W, 3] uint8 (BGR, the byte order
    the file stores and the JAX package returns)."""
    raw = _read_avi_raw_dib(path) if path.lower().endswith(".avi") else None
    if raw is None:
        raise ValueError(f"{path}: only uncompressed 24-bit DIB AVIs are read "
                         "here (the JAX package decodes other video through "
                         "OpenCV)")
    return raw


def write_timelaps(movie: np.ndarray, path: str, frame_rate: int = 32) -> None:
    """[T, H, W, 3] uint8 → an uncompressed 24-bit DIB AVI (bottom-up rows,
    one '00db' chunk per frame, an idx1 index), which :func:`read_clip`
    reads back unchanged. The JAX package writes mp4v through OpenCV
    instead: same frames, another codec."""
    movie = np.ascontiguousarray(movie)
    if movie.dtype != np.uint8 or movie.ndim != 4 or movie.shape[3] != 3:
        raise ValueError(f"write_timelaps takes [T, H, W, 3] uint8, got "
                         f"{movie.shape} {movie.dtype}")
    t, h, w, _ = movie.shape
    row_bytes = (w * 3 + 3) & ~3
    frame_bytes = row_bytes * h

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        return (fourcc + struct.pack("<I", len(payload)) + payload
                + b"\0" * (len(payload) & 1))

    def riff_list(kind: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", kind + payload)

    avih = struct.pack("<14I", 1_000_000 // frame_rate,
                       frame_bytes * frame_rate, 0, 0x10, t, 0, 1,
                       frame_bytes, w, h, 0, 0, 0, 0)
    strh = (b"vids" + b"DIB " + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, 1,
                                            frame_rate, 0, t, frame_bytes,
                                            -1, 0)
            + struct.pack("<4h", 0, 0, w, h))
    strf = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, frame_bytes, 0, 0,
                       0, 0)
    hdrl = riff_list(b"hdrl", chunk(b"avih", avih) + riff_list(
        b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    frames, index = [], []
    offset = 4  # idx1 offsets count from the 'movi' fourcc
    pad = np.zeros((h, row_bytes - w * 3), np.uint8)
    for i in range(t):
        rows = np.concatenate([movie[i, ::-1].reshape(h, w * 3), pad], axis=1)
        frames.append(chunk(b"00db", rows.tobytes()))
        index.append(struct.pack("<4sIII", b"00db", 0x10, offset,
                                 frame_bytes))
        offset += len(frames[-1])
    body = (hdrl + riff_list(b"movi", b"".join(frames))
            + chunk(b"idx1", b"".join(index)))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI " + body)


def load_volume(path: str, image_bits: int = 8) -> np.ndarray:
    """Movie or ndarray asset → [T, H, W, 3] float32 b-bit code values,
    re-quantized as the JAX package does: the float64 codes are normalized
    and rounded half up in float64, and the code book division and scale
    run in float32, where the JAX package's floor returns."""
    import torch

    from nic_torch.core.quant import normalize_from_bit, scale_to_bit

    if asset_kind(path) == "movie":
        vol = read_clip(path).astype(np.float64)
    else:
        vol = np.load(path).astype(np.float64)
    s = 2.0**image_bits - 1.0
    codes = torch.floor(normalize_from_bit(torch.from_numpy(vol), image_bits)
                        * s + 0.5).float()
    return scale_to_bit(codes / s, image_bits).numpy()


def flatten_3d_to_2d(volume: np.ndarray, image_size: int) -> np.ndarray:
    """[T, S, S, 3] → one [R, R, 3] tile sheet (method 2): frame i goes to
    tile (i // (R/S), i % (R/S))."""
    t, s = volume.shape[0], volume.shape[1]
    per_row = image_size // s
    sheet = np.zeros((image_size, image_size, volume.shape[3]),
                     dtype=volume.dtype)
    for i in range(t):
        r, c = divmod(i, per_row)
        sheet[r * s:(r + 1) * s, c * s:(c + 1) * s] = volume[i]
    return sheet


def unflatten_2d_to_3d(sheet: np.ndarray, frame_size: int,
                       num_frames: int) -> np.ndarray:
    """Inverse of :func:`flatten_3d_to_2d`."""
    per_row = sheet.shape[0] // frame_size
    frames = []
    for i in range(num_frames):
        r, c = divmod(i, per_row)
        frames.append(sheet[r * frame_size:(r + 1) * frame_size,
                            c * frame_size:(c + 1) * frame_size])
    return np.stack(frames)


def save_lut_csv(lut: np.ndarray, path: str) -> None:
    """[S, S, S, 3] LUT → CSV, one row per (a, b) with the S·3 values of
    axis 2 and channels, each row ending in a comma (the JAX package's
    layout)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    s = lut.shape[0]
    with open(path, "w") as f:
        for a in range(s):
            for b in range(s):
                f.write(",".join(str(float(lut[a, b, r, c]))
                                 for r in range(s) for c in range(3)) + ",\n")
