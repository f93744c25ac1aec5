"""ctypes binding of the rANS coder (``rans.cpp``, a copy of
``nic/native/rans.cpp``), with ``nic.native``'s ``rans_encode`` /
``rans_decode`` semantics.

``rans.cpp`` is compiled with ``g++ -O3 -fPIC -std=c++17 -shared`` at
first use into ``build/nic_torch/<key>/librans.so`` at the repository
root, where ``<key>`` hashes the source and the flags (the way
``nic_torch.kernels._build`` builds the CUDA sources). The library is
written to a temporary file and renamed, so two processes may build at
once. There is no fallback: a library that does not build or load
raises, and the pure-Python coders of ``nic_torch.io.entropy`` are the
plain versions the tests hold this coder to.

Stream formats (the encoder picks; decoders read the magic):

- format 3 (``NR3\\x01``), at ≥ 16384 symbols: 64 lanes sharing one u16
  word stream, decoded by AVX-512 where the host has it
  (:func:`decode_path`), else by the scalar loop;
- format 2 (``NR2\\x01``), below that: 8 interleaved lanes behind a
  header of their byte lengths;
- format 1 (headerless, byte-renormalized), read only, for old
  artifacts (``legacy=True``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["rans_encode", "rans_decode", "decode_path", "load"]

SOURCE = Path(__file__).resolve().parent / "rans.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "nic_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
LIB_NAME = "librans.so"

_RANS2_MAGIC = b"NR2\x01"
_RANS3_MAGIC = b"NR3\x01"
# format 3 carries ~384 B of fixed overhead (64 u32 states + load pad);
# small streams stay format 2 where that would cost real bpp
_RANS3_MIN_SYMS = 16384
_RANS_LANES = 8
_LUT3_SHIFT = 6  # coarse cum→symbol buckets: 2^(16-6) entries per bin

_lib: ctypes.CDLL | None = None


def _key() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return "rans-" + h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    lib.nic_rans_decode.restype = ctypes.c_int
    lib.nic_rans_decode.argtypes = [u8p, i64, i32p, i64, i32p, i64, i32p]
    lib.nic_rans_encode_ilv.restype = i64
    lib.nic_rans_encode_ilv.argtypes = [i32p, i32p, i64, i32p, i64, i32,
                                        u8p, i64, i64p]
    lib.nic_rans_decode_ilv.restype = ctypes.c_int
    lib.nic_rans_decode_ilv.argtypes = [u8p, i64p, i32, i32p, i64, i32p,
                                        i64, u16p, i32p]
    lib.nic_rans_build_lut.restype = None
    lib.nic_rans_build_lut.argtypes = [i32p, i64, i64, u16p]
    lib.nic_rans_encode_ilv3.restype = i64
    lib.nic_rans_encode_ilv3.argtypes = [i32p, i32p, i64, i32p, i64, u8p,
                                         i64]
    lib.nic_rans_decode_ilv3.restype = ctypes.c_int
    lib.nic_rans_decode_ilv3.argtypes = [u8p, i64, i32p, i64, i32p, i64,
                                         u16p, i32, i32p]
    lib.nic_rans_build_lut_coarse.restype = None
    lib.nic_rans_build_lut_coarse.argtypes = [i32p, i64, i64, i32, u16p]
    lib.nic_rans_simd_available.restype = ctypes.c_int
    lib.nic_rans_simd_available.argtypes = []
    return lib


def load() -> ctypes.CDLL:
    """The rANS library, built on first use in this checkout; raises if
    ``g++`` is missing or the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    out_dir = BUILD_ROOT / _key()
    lib_path = out_dir / LIB_NAME
    if not lib_path.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if not cxx:
            raise RuntimeError("g++ not found: the rANS coder "
                               "(nic_torch/native/rans.cpp) needs a C++ "
                               "compiler to build")
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building the rANS coder failed "
                               f"({proc.returncode}): {' '.join(cmd)}\n"
                               + proc.stderr[-4000:])
        os.replace(tmp, lib_path)  # atomic: a reader never sees half a file
    _lib = _declare(ctypes.CDLL(str(lib_path)))
    return _lib


def decode_path() -> str:
    """The format-3 decode path this host runs: ``"avx512"`` or
    ``"scalar"`` (``rans.cpp`` asks the CPU at run time)."""
    return "avx512" if load().nic_rans_simd_available() else "scalar"


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def rans_encode(symbols: np.ndarray, bins: np.ndarray,
                cdf: np.ndarray) -> bytes:
    """rANS-encode ``symbols``, each drawn from its ``bins`` row of the
    int32 [n_bins, S + 1] 16-bit-total ``cdf``: a format-3 stream at
    ≥ 16384 symbols, else format 2 with 8 lanes. Raises on a symbol
    outside its row."""
    symbols = np.ascontiguousarray(symbols, np.int32).reshape(-1)
    bins = np.ascontiguousarray(bins, np.int32).reshape(-1)
    cdf = np.ascontiguousarray(cdf, np.int32)
    lib = load()
    i32 = ctypes.c_int32
    if symbols.size >= _RANS3_MIN_SYMS:
        cap = symbols.size * 2 + 64 * 4 + 256
        out = np.empty(cap, np.uint8)
        total = lib.nic_rans_encode_ilv3(
            _ptr(symbols, i32), _ptr(bins, i32), symbols.size,
            _ptr(cdf, i32), cdf.shape[1], _ptr(out, ctypes.c_uint8), cap)
        if total < 0:
            raise ValueError("rans encode failed (symbol out of CDF range?)")
        return _RANS3_MAGIC + out[:total].tobytes()
    cap = symbols.size * 2 + 8 * _RANS_LANES + 64
    out = np.empty(cap, np.uint8)
    lane_lens = np.empty(_RANS_LANES, np.int64)
    n = lib.nic_rans_encode_ilv(
        _ptr(symbols, i32), _ptr(bins, i32), symbols.size, _ptr(cdf, i32),
        cdf.shape[1], _RANS_LANES, _ptr(out, ctypes.c_uint8), cap,
        _ptr(lane_lens, ctypes.c_int64))
    if n < 0:
        raise ValueError("rans encode failed (symbol out of CDF range?)")
    header = _RANS2_MAGIC + struct.pack(f"<B{_RANS_LANES}I", _RANS_LANES,
                                        *lane_lens.tolist())
    return header + out[:n].tobytes()


# cum→symbol tables by CDF contents; bounded (tables are ≤ tens of MB)
_LUT_CACHE: dict = {}


def _lut(cdf: np.ndarray, coarse: bool) -> np.ndarray:
    key = (coarse, cdf.shape,
           hashlib.blake2b(cdf.tobytes(), digest_size=16).digest())
    hit = _LUT_CACHE.get(key)
    if hit is not None:
        return hit
    lib = load()
    i32, u16 = ctypes.c_int32, ctypes.c_uint16
    if coarse:  # 2 KB per bin, corrected in the loop over the CDF rows
        lut = np.empty((cdf.shape[0] << (16 - _LUT3_SHIFT)) + 2, np.uint16)
        lib.nic_rans_build_lut_coarse(_ptr(cdf, i32), cdf.shape[0],
                                      cdf.shape[1], _LUT3_SHIFT,
                                      _ptr(lut, u16))
    else:
        lut = np.empty(cdf.shape[0] << 16, np.uint16)
        lib.nic_rans_build_lut(_ptr(cdf, i32), cdf.shape[0], cdf.shape[1],
                               _ptr(lut, u16))
    if len(_LUT_CACHE) >= 8:
        _LUT_CACHE.clear()
    _LUT_CACHE[key] = lut
    return lut


def rans_decode(data: bytes, bins: np.ndarray, cdf: np.ndarray,
                legacy: bool | None = None) -> np.ndarray:
    """Decode a rANS stream → int32 symbols. A format-3 stream is read by
    its magic; otherwise ``legacy=True`` reads format 1, ``False``
    requires format 2 and ``None`` reads the format-2 magic if present,
    else format 1."""
    bins = np.ascontiguousarray(bins, np.int32).reshape(-1)
    cdf = np.ascontiguousarray(cdf, np.int32)
    lib = load()
    i32 = ctypes.c_int32
    out = np.empty(bins.size, np.int32)
    if data.startswith(_RANS3_MAGIC):
        buf = np.ascontiguousarray(np.frombuffer(data[4:], np.uint8))
        rc = lib.nic_rans_decode_ilv3(
            _ptr(buf, ctypes.c_uint8), buf.size, _ptr(bins, i32), bins.size,
            _ptr(cdf, i32), cdf.shape[1], _ptr(_lut(cdf, True), ctypes.c_uint16),
            _LUT3_SHIFT, _ptr(out, i32))
    else:
        if legacy is None:
            legacy = not data.startswith(_RANS2_MAGIC)
        elif not legacy and not data.startswith(_RANS2_MAGIC):
            raise ValueError("rans stream lacks the format-2/3 header")
        if legacy:
            buf = np.ascontiguousarray(np.frombuffer(data, np.uint8))
            rc = lib.nic_rans_decode(
                _ptr(buf, ctypes.c_uint8), buf.size, _ptr(bins, i32),
                bins.size, _ptr(cdf, i32), cdf.shape[1], _ptr(out, i32))
        else:
            lanes = data[4]
            lens = struct.unpack_from(f"<{lanes}I", data, 5)
            buf = np.ascontiguousarray(
                np.frombuffer(data[5 + 4 * lanes:], np.uint8))
            off = np.zeros(lanes + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            # the dense table pays only when the symbol count amortizes
            # its build (2^16 writes per bin); else a branchless search
            lut = (_lut(cdf, False) if bins.size >= cdf.shape[0] * 4096
                   else None)
            rc = lib.nic_rans_decode_ilv(
                _ptr(buf, ctypes.c_uint8), _ptr(off, ctypes.c_int64), lanes,
                _ptr(bins, i32), bins.size, _ptr(cdf, i32), cdf.shape[1],
                _ptr(lut, ctypes.c_uint16) if lut is not None
                else ctypes.cast(None, ctypes.POINTER(ctypes.c_uint16)),
                _ptr(out, i32))
    if rc != 0:
        raise ValueError("rans decode failed")
    return out
