"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` per source, all
started together (``-I csrc`` for the shared ``*.cuh`` headers), and the
objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``. The library lives under ``build/nic_torch/<key>/``
at the repository root, where ``<key>`` hashes the sources, the headers
and the flags: a changed source or header builds anew, an unchanged tree
loads the library already built. Nothing is built at import time; the
first kernel launch builds, and a build that fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load", "build_seconds"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "nic_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libnic_torch_kernels.so"

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin):"
                       " the CUDA kernels need the CUDA toolkit to build")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.nic_decode_fused_v2
    fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_float, p,
                   i, i, i, i, i, i, i, p]
    fn.restype = i
    fn = lib.nic_decode_fused_3d
    fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_float, p,
                   i, i, i, i, i, i, i, i, p]
    fn.restype = i
    fn = lib.nic_train_fused_ff
    fn.argtypes = [p] * 20 + [i] * 19 + [p]
    fn.restype = i
    fn = lib.nic_train_fused_dx
    fn.argtypes = [p] * 11 + [i] * 6 + [p]
    fn.restype = i
    fn = lib.nic_train_fused_ng
    fn.argtypes = [p] * 14 + [i] * 8 + [p]
    fn.restype = i
    fn = lib.nic_train_fused_ng3
    fn.argtypes = [p] * 14 + [i] * 8 + [p]
    fn.restype = i
    fn = lib.nic_train_fused_ff3
    fn.argtypes = [p] * 17 + [i] * 16 + [p]
    fn.restype = i
    lib.nic_cuda_error_string.argtypes = [i]
    lib.nic_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this checkout."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    sources = _sources()
    out_dir = BUILD_ROOT / _key(sources)
    lib_path = out_dir / LIB_NAME
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        nvcc = _nvcc()
        objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
        t0 = time.perf_counter()
        jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True))
                for cmd in ([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                             str(obj), str(src)]
                            for src, obj in zip(sources, objs))]
        results = []
        for cmd, proc in jobs:
            out, err = proc.communicate()
            results.append((cmd, proc.returncode, out, err))
        tmp = out_dir / f"{LIB_NAME}.{tag}"
        if all(rc == 0 for _, rc, _, _ in results):
            cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            results.append((cmd, proc.returncode, proc.stdout, proc.stderr))
        build_seconds = time.perf_counter() - t0
        (out_dir / "nvcc.log").write_text("".join(
            " ".join(cmd) + "\n" + out + err for cmd, _, out, err in results))
        for obj in objs:
            obj.unlink(missing_ok=True)
        failed = [(cmd, rc, err) for cmd, rc, _, err in results if rc != 0]
        if failed:
            cmd, rc, err = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}) building {lib_path}: "
                               f"{' '.join(cmd)}\n" + err[-4000:])
        os.replace(tmp, lib_path)  # atomic: a reader never sees half a file
    _lib = _declare(ctypes.CDLL(str(lib_path)))
    return _lib
