#!/usr/bin/env python3
"""Probe K13 (``nic_torch/kernels/csrc/hs_bins.cu``) on one NVIDIA GPU:
where a block's time goes, and what the row tile does.

    python3 scripts/torch_k13_probe.py [ROWS]

builds standalone copies of the source with ``nvcc`` (the flags of
``nic_torch.kernels._build``) under ``build/k13_probe/``:

- ``timeline``: the source with a ``clock64`` record at each tap's
  barrier, after its copies' issue and after its compute, by lane 0 of
  each warp of the blocks of output-channel tile 0 (batch 0, phase 0);
- ``rows<R>``: the source with every 16-column layer forced to tiles of R
  rows, for each R of ROWS (comma-separated, default 1,2,4).

On a seeded random n = 96, m = 128 model (``HyperpriorModel``, generator
seed 13) and ẑ at 512×768 (1×96×8×12) and 2048² (1×96×32×32) it prints
each copy's device ms per layer (``torch.profiler``, 20 calls) beside the
library kernel's, and whether its σ and bins equal the library kernel's
bit for bit (the tiles change no output's order of operations); then the
timeline at 512×768: per layer, the cycles to the first tap's data, and
per tap the medians over those blocks and both warps of the copies'
issue, the compute and the wait at the next barrier.
"""

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from nic_torch.kernels import _build, hs_bins as k13  # noqa: E402
from nic_torch.models.hyperprior import HyperpriorModel  # noqa: E402

OUT = os.path.join(ROOT, "build", "k13_probe")
SOURCE = os.path.join(ROOT, "nic_torch", "kernels", "csrc", "hs_bins.cu")
# the records: [layer][block][tap][warp][after the barrier, after the
# copies' issue, after the compute]
TIMELINE = """__device__ long long g_probe[3][1024][9][2][3];
extern "C" int nic_hs_probe(void* out) {
  return cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}
"""


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"the source has changed: {old!r} not found")
    return src.replace(old, new, 1)


def timeline_source(src: str) -> str:
    src = _sub(src, "constexpr int kTC = 16;",
               TIMELINE.split("extern")[0] + "constexpr int kTC = 16;")
    src = _sub(src, "  const int tid = threadIdx.x, lane = tid & 31, "
               "warp = tid >> 5;\n",
               "  const int tid = threadIdx.x, lane = tid & 31, "
               "warp = tid >> 5;\n"
               "  const int lay_ = kConvT ? (kInCL ? 1 : 0) : 2;\n"
               "  const bool rec_ = lane == 0 && warp < 2 && blockIdx.x < "
               "1024 && blockIdx.y == 0 && blockIdx.z == 0;\n"
               "  const long long t0_ = clock64();\n")
    rec = ("    if (rec_) g_probe[lay_][blockIdx.x][t][warp][{}] = "
           "clock64() - t0_;\n")
    src = _sub(src, "all are done with tap t - 1\n",
               "all are done with tap t - 1\n" + rec.format(0))
    src = _sub(src, "      stage(t + 1, dy_of(t) + kTR, dy_of(t + 1) + kTR - "
               "1);\n", "      stage(t + 1, dy_of(t) + kTR, dy_of(t + 1) + "
               "kTR - 1);\n" + rec.format(1))
    src = _sub(src, "      tap_chains<kTR>(acc, xq, wq, N, RP, wS);\n    }\n"
               "  }\n", "      tap_chains<kTR>(acc, xq, wq, N, RP, wS);\n"
               "    }\n" + rec.format(2) + "  }\n")
    return src + 'extern "C"' + TIMELINE.split('extern "C"')[1]


def rows_source(src: str, rows: int) -> str:
    src = _sub(src, "  const size_t smem = smem_bytes(tw, tr, N);",
               f"  tr = {rows};\n  const size_t smem = smem_bytes(tw, tr, N);")
    return re.sub(r"auto kern = tw == 8[^;]*;",
                  f"auto kern = hs_layer<16, {rows}, kConvT, kInCL>;", src)


def build(sources: dict) -> dict:
    os.makedirs(OUT, exist_ok=True)
    nvcc, jobs = _build._nvcc(), {}
    for name, src in sources.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        jobs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
             os.path.join(OUT, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{out[-3000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        lib.nic_hs_bins.argtypes = ([ctypes.c_void_p] * 11
                                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def call(lib, z, hs):
    """σ, bins of a standalone copy, as ``hs_bins_kernel`` calls the
    library's."""
    b, n, h4, w4 = z.shape
    m, s = hs.w3.shape[0], k13._chan_stride(n)
    s1 = torch.empty((b, 2 * h4, 2 * w4, s), device="cuda")
    s2 = torch.empty((b, 4 * h4, 4 * w4, s), device="cuda")
    sigma = torch.empty((b, m, 4 * h4, 4 * w4), device="cuda")
    bins = torch.empty(sigma.shape, dtype=torch.int32, device="cuda")
    rc = lib.nic_hs_bins(z.data_ptr(), *(t.data_ptr() for t in hs),
                         s1.data_ptr(), s2.data_ptr(), sigma.data_ptr(),
                         bins.data_ptr(), b, n, m, h4, w4, ctypes.c_void_p(
                             torch.cuda.current_stream().cuda_stream))
    if rc:
        raise SystemExit(f"launch failed: {rc}")
    return sigma, bins


def layers_ms(fn) -> str:
    total, per = chip_smoke.device_ms(fn)
    return f"{total:.4f} ms (" + "; ".join(
        f"{name.split('hs_layer')[1].split('(')[0]} {t:.4f}"
        for name, t in sorted(per.items()) if "hs_layer" in name) + ")"


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    rows = [int(r) for r in (sys.argv[1] if len(sys.argv) > 1
                             else "1,2,4").split(",")]
    print(f"K13 probe: {chip_smoke.smi_line()}", flush=True)
    src = open(SOURCE).read()
    libs = build({"timeline": timeline_source(src),
                  **{f"rows{r}": rows_source(src, r) for r in rows}})
    gen = torch.Generator().manual_seed(13)
    model = HyperpriorModel(96, 128, generator=gen).cuda()
    hs = k13.hs_weights(model.h_s)
    zs = {"512×768": torch.round(torch.randn(1, 96, 8, 12, generator=gen)
                                 * 3.0).cuda(),
          "2048²": torch.round(torch.randn(1, 96, 32, 32, generator=gen)
                               * 3.0).cuda()}
    for where, z in zs.items():
        want = k13.hs_bins_kernel(z, hs)
        print(f"K13 probe {where}: library kernel "
              + layers_ms(lambda: k13.hs_bins_kernel(z, hs)), flush=True)
        for name, lib in libs.items():
            got = call(lib, z, hs)
            same = (torch.equal(got[0].view(torch.int32),
                                want[0].view(torch.int32))
                    and torch.equal(got[1], want[1]))
            print(f"K13 probe {where}: {name} "
                  + layers_ms(lambda: call(libs[name], z, hs))
                  + f"; σ and bins {'equal' if same else 'DIFFER'}",
                  flush=True)
    z = zs["512×768"]
    for _ in range(3):
        call(libs["timeline"], z, hs)
    torch.cuda.synchronize()
    rec = np.zeros((3, 1024, 9, 2, 3), np.int64)
    libs["timeline"].nic_hs_probe(rec.ctypes.data)
    for layer, plan in enumerate(k13.launch_plan(96, 128, 8, 12)):
        taps = 4 if layer < 2 else 9
        t = rec[layer, :plan["grid"][0], :taps]
        med = lambda a: int(np.median(a))  # noqa: E731
        print(f"K13 probe timeline 512×768 layer {layer + 1} "
              f"({plan['tw']}×{plan['tr']} tiles, {plan['grid'][0]} blocks "
              f"of channel tile 0): first tap's data at {med(t[:, 0, :, 0])} "
              f"cycles; per tap, issue "
              f"{[med(t[:, k, :, 1] - t[:, k, :, 0]) for k in range(taps)]}, "
              f"compute "
              f"{[med(t[:, k, :, 2] - t[:, k, :, 1]) for k in range(taps)]}, "
              f"wait {[med(t[:, k + 1, :, 0] - t[:, k, :, 2])
                        for k in range(taps - 1)]}", flush=True)


if __name__ == "__main__":
    main()
