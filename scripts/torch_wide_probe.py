#!/usr/bin/env python3
"""Probe the wide tensor-core train body ``mlp_pixel_mma_wide``
(``nic_torch/kernels/csrc/train_fused_mma_wide.cu``) on one NVIDIA GPU:
where a 64-pixel tile's time goes.

    python3 scripts/torch_wide_probe.py [HIDDEN,...]

builds a standalone copy of the source with ``nvcc`` (the flags of
``nic_torch.kernels._build``) under ``build/wide_probe/``, with a
``clock64`` record by thread 0 of block 0 at each phase boundary of its
first 16 tiles: tile start, layer 1 (z1, h1b), layer 2 (z2, o3's share),
o3's reduction, the sigmoid and dz3, the per-unit pass (dW3, dz2b, db2),
layer 2's backward (dh1, dW2, dz1), dz1 out and db1, dW1 (and dx). On the
sinusoidal gather of a random flagship pyramid at 8 crops of 256² (K7's
shape, seed 27; MLP at each H of HIDDEN, default 128,256), bf16·poly, it
launches the copy as K7 does (the node-gradient mode: dz1 out), checks
its loss against the library body's, and prints per phase the median
cycles over tiles 1-15 and the share of the tile, beside the library
body's device ms (``torch.profiler``) and the card's SM clock.
"""

import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from nic_torch.kernels import _build  # noqa: E402
from nic_torch.kernels import train_fused as k67  # noqa: E402

SRC = os.path.join(ROOT, "nic_torch", "kernels", "csrc",
                   "train_fused_mma_wide.cu")
OUT = os.path.join(ROOT, "build", "wide_probe")
TILES = 16
# the phases that end at each `// @probe-mark <label>` comment of the
# source's tile loop, in order; the tile's end is `// @probe-mark end`
MARKS = ("start", "layer 1", "layer 2", "o3 reduce", "sigmoid, dz3",
         "dz2 pass", "layer 2 back", "dz1 out, db1")


def build() -> ctypes.CDLL:
    text = open(SRC).read()
    head = ('__device__ long long g_tl[%d][16];\n'
            '#define NIC_TL(k) if (threadIdx.x == 0 && blockIdx.x == 0 && '
            'tile / static_cast<int>(gridDim.x) < %d) '
            'g_tl[tile / gridDim.x][k] = clock64();\n' % (TILES, TILES))
    text = text.replace('#include "train_common.cuh"\n',
                        '#include "train_common.cuh"\n' + head, 1)
    for k, label in enumerate((*MARKS, "end")):
        mark = f"    // @probe-mark {label}\n"
        if text.count(mark) != 1:
            sys.exit(f"{mark.strip()!r} not found once in {SRC}")
        text = text.replace(mark, mark + f"    NIC_TL({k});\n")
    text += ('\nextern "C" int nic_wide_timeline(long long* out) {\n'
             '  return static_cast<int>(cudaMemcpyFromSymbol(out, g_tl, '
             'sizeof(g_tl)));\n}\n')
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "wide_timeline.cu")
    with open(src, "w") as fh:
        fh.write(text)
    lib = os.path.join(OUT, "libwide_timeline.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-shared", "-o", lib, src, str(_build.CSRC / "body_log.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        sys.exit(proc.stderr[-4000:])
    regs = re.findall(r"mlp_pixel_mma_wide\S*'\s*\n.*?Used (\d+) registers",
                      proc.stdout + proc.stderr, re.S)
    print(f"probe: built {lib} (registers {sorted(set(regs))})", flush=True)
    return ctypes.CDLL(lib)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    hiddens = [int(h) for h in (sys.argv[1] if len(sys.argv) > 1
                                else "128,256").split(",")]
    print(f"probe: {chip_smoke.smi_line()}", flush=True)
    lib = build()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nic_mlp_pixel_mma_wide.argtypes = [p] * 11 + [i] * 6 + [p]
    lib.nic_mlp_pixel_mma_wide.restype = i
    lib.nic_wide_timeline.argtypes = [p]
    lib.nic_wide_timeline.restype = i
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    gen = torch.Generator().manual_seed(27)
    for hidden in hiddens:
        fp, weights, x, tgt, origins = chip_smoke._gather_inputs(
            gen, "cuda", 256, 0.25, False, hidden=hidden)
        kw = dict(n=256, f=4, gelu="poly", cd=torch.bfloat16,
                  g0_nodes=tuple(fp[0].shape[1:]),
                  g1_nodes=tuple(fp[1].shape[1:]))
        want = k67.fused_mlp_loss_ng_kernel(x, tgt, origins, *weights, **kw)
        _, per = chip_smoke.device_ms(lambda: k67.fused_mlp_loss_ng_kernel(
            x, tgt, origins, *weights, **kw))
        lib_ms = chip_smoke._body_ms(per, "mlp_pixel_mma_wide")
        npix, feat = x.shape
        xs, tg, *ws = k67._prep(x, tgt, *weights)
        w1, b1, w2, b2, w3, b3 = k67._body_weights("mlp_pixel_mma_wide", *ws)
        part, nblk = k67._partials(npix, feat, hidden, "mlp_pixel_mma_wide",
                                   "cuda")
        out = torch.empty(npix, 3, device="cuda")
        dz1 = torch.empty(npix, hidden, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.nic_mlp_pixel_mma_wide(
            *(t.data_ptr() for t in (xs, tg, w1, b1, w2, b2, w3, b3, out,
                                     dz1, part)),
            npix, feat, hidden, 0, k67.GELU_IDS["poly"], nblk, stream)
        torch.cuda.synchronize()
        if rc:
            sys.exit(f"launch failed: CUDA error {rc}")
        loss = float(part[:, 0].sum())
        tl = torch.zeros(TILES, 16, dtype=torch.int64)
        if lib.nic_wide_timeline(tl.data_ptr()):
            sys.exit("cudaMemcpyFromSymbol failed")
        # the phase between record k and record k + 1 is named by the
        # label of record k + 1 (the last one, the tile's end, is dW1's)
        labels = [*MARKS[1:], "dW1"]
        steps = tl[1:, 1:len(MARKS) + 1] - tl[1:, :len(MARKS)]
        med = steps.double().median(dim=0).values.tolist()
        total = sum(med)
        print(f"probe: H={hidden} 8×256² bf16·poly: loss {loss:.6f} (library "
              f"body {float(want[0]):.6f}); library body device {lib_ms:.4f} "
              f"ms over {nblk} blocks, {-(-npix // 64)} tiles; SM clock "
              f"now, max (MHz) {clock.strip()}; a tile of block 0, median "
              f"over tiles 1-{TILES - 1}: {total:.0f} cycles: " + "; ".join(
                  f"{m} {c:.0f} ({c / total:.3f})"
                  for m, c in zip(labels, med)), flush=True)


if __name__ == "__main__":
    main()
