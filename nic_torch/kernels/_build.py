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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["load", "log_path", "build_seconds", "source_seconds",
           "body_launches", "clear_body_launches"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "nic_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libnic_torch_kernels.so"
NVCC_TIMEOUT = 600  # seconds one source may take before the build fails

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build
source_seconds: dict = {}  # per source: seconds from the start to its end


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
    fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_float, p] + [i] * 8 + [p]
    fn.restype = i
    fn = lib.nic_decode_fused_3d
    fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_float, p] + [i] * 9 + [p]
    fn.restype = i
    fn = lib.nic_decode_z1mm
    fn.argtypes = [p] * 9 + [i] * 11 + [p]
    fn.restype = i
    fn = lib.nic_decode_fused_v1
    fn.argtypes = [p] * 9 + [i] * 8 + [ctypes.c_float] * 2 + [i] * 3 + [p]
    fn.restype = i
    fn = lib.nic_mlp_tail
    fn.argtypes = [p] * 6 + [ctypes.c_longlong] + [i] * 5 + [p]
    fn.restype = i
    fn = lib.nic_train_fused_ff
    fn.argtypes = [p] * 21 + [i] * 20 + [p]
    fn.restype = i
    fn = lib.nic_eps_grad
    fn.argtypes = [p] * 2 + [i] * 11 + [p]
    fn.restype = i
    fn = lib.nic_train_fused_dx
    fn.argtypes = [p] * 11 + [i] * 7 + [p]
    fn.restype = i
    fn = lib.nic_train_fused_ng
    fn.argtypes = [p] * 15 + [i] * 9 + [p]
    fn.restype = i
    fn = lib.nic_node_windows
    fn.argtypes = [p] * 5 + [i] * 4 + [p]
    fn.restype = i
    fn = lib.nic_train_fused_ng3
    fn.argtypes = [p] * 14 + [i] * 9 + [p]
    fn.restype = i
    fn = lib.nic_train_fused_ff3
    fn.argtypes = [p] * 17 + [i] * 17 + [p]
    fn.restype = i
    fn = lib.nic_hs_bins
    fn.argtypes = [p] * 11 + [i] * 5 + [p]
    fn.restype = i
    lib.nic_cuda_error_string.argtypes = [i]
    lib.nic_cuda_error_string.restype = ctypes.c_char_p
    lib.nic_body_log.argtypes = [i, ctypes.c_char_p, i,
                                 ctypes.POINTER(ctypes.c_longlong)]
    lib.nic_body_log.restype = i
    lib.nic_body_log_clear.argtypes = []
    lib.nic_body_log_clear.restype = None
    return lib


def body_launches() -> dict[str, int]:
    """The per-pixel bodies (train and decode) launched since the last
    :func:`clear_body_launches`: {the CUDA runtime's name of the launched
    ``__global__``: launches} (``csrc/body_log.cu``)."""
    lib = load()
    name = ctypes.create_string_buffer(512)
    count = ctypes.c_longlong(0)
    n = lib.nic_body_log(-1, name, len(name), ctypes.byref(count))
    if n < 0:
        raise RuntimeError("the body launch log overflowed; clear it first")
    got = {}
    for i in range(n):
        lib.nic_body_log(i, name, len(name), ctypes.byref(count))
        got[name.value.decode()] = count.value
    return got


def clear_body_launches() -> None:
    """Empty the launch log that :func:`body_launches` reads."""
    load().nic_body_log_clear()


def log_path() -> Path:
    """The nvcc log of this checkout's build (``ptxas -v`` per kernel, then
    each source's seconds)."""
    return BUILD_ROOT / _key(_sources()) / "nvcc.log"


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

        def finish(job):  # waits for one nvcc and notes when it ended
            cmd, proc = job
            try:
                out, err = proc.communicate(timeout=NVCC_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
                err += f"\nkilled after {NVCC_TIMEOUT} s\n"
            return cmd, proc.returncode, out, err, time.perf_counter() - t0

        with ThreadPoolExecutor(len(jobs)) as pool:
            done = list(pool.map(finish, jobs))
        results = [r[:4] for r in done]
        source_seconds.update((src.name, r[4])
                              for src, r in zip(sources, done))
        tmp = out_dir / f"{LIB_NAME}.{tag}"
        if all(rc == 0 for _, rc, _, _ in results):
            cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            results.append((cmd, proc.returncode, proc.stdout, proc.stderr))
        build_seconds = time.perf_counter() - t0
        (out_dir / "nvcc.log").write_text("".join(
            " ".join(cmd) + "\n" + out + err for cmd, _, out, err in results)
            + "".join(f"{name}: {sec:.1f} s\n"
                      for name, sec in source_seconds.items()))
        for obj in objs:
            obj.unlink(missing_ok=True)
        failed = [(cmd, rc, err) for cmd, rc, _, err in results if rc != 0]
        if failed:
            cmd, rc, err = failed[0]
            raise RuntimeError(
                f"nvcc failed ({rc}) building {lib_path}: {' '.join(cmd)}\n"
                + err[-4000:] + "\nseconds per source: "
                + ", ".join(f"{name} {sec:.1f}"
                            for name, sec in source_seconds.items()))
        os.replace(tmp, lib_path)  # atomic: a reader never sees half a file
    _lib = _declare(ctypes.CDLL(str(lib_path)))
    return _lib
