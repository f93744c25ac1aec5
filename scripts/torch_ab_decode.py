#!/usr/bin/env python3
"""Time the folded decode kernels K1 (2D) and K5 (3D) of one checkout of
the port, for A/B comparisons of two checkouts on one card.

    python3 scripts/torch_ab_decode.py ROOT

imports ``nic_torch`` from the checkout at ROOT (which builds its own
kernels under ROOT/build) and times it with the helpers of the
``chip_smoke.py`` beside this script, so that both checkouts are measured
by the same code. On a machine with one NVIDIA GPU it prints, for
``decode_kernel_2d`` on the column stage of ``chip_smoke``'s 2048² random
flagship-width model at mip 0, in fp32·exact, fp32·poly, bf16·exact,
bf16·poly and i16·tanherf, and for ``decode_kernel_3d`` on the frame and
column stage of its 256³ random m3 model at mip 0 in fp32·exact and
bf16·exact, the median of 50 CUDA-event timings of the wrapper and, by
``torch.profiler``, the device time per call of all its kernels and of
the longest by name (the body: ``decode_fused_v2_kernel`` or
``decode_v2_mma``).

Compare two checkouts only inside one call, in turns (parent, change,
change, parent).
"""

import importlib.util
import os
import sys

import torch

# scripts/torch_ab_train.py imports nic_torch from the checkout at
# sys.argv[1] and this checkout's chip_smoke.py; its report() times a call
_spec = importlib.util.spec_from_file_location(
    "torch_ab_train",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "torch_ab_train.py"))
ab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ab)

from nic_torch.grids.pyramid import pyramid_mip_levels  # noqa: E402
from nic_torch.kernels import decode_fused_3d as k5  # noqa: E402
from nic_torch.kernels import decode_fused_v2 as k  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    if not k.__file__.startswith(ab.ROOT):
        sys.exit(f"nic_torch came from {k.__file__}, not {ab.ROOT}")
    print(f"AB {sys.argv[1]}: {ab.chip_smoke.smi_line()}", flush=True)
    fp, mlp, m2l = ab.chip_smoke._random_flagship("cuda", 2048)
    with torch.inference_mode():
        for mode, dtype, gelu in (("fp32", None, "exact"),
                                  ("fp32", None, "poly"),
                                  ("bf16", torch.bfloat16, "exact"),
                                  ("bf16", torch.bfloat16, "poly"),
                                  ("i16", "i16", "tanherf")):
            pc, c1v, pe_u, w2, b2, w3, b3, s, geom = k._prepare_2d(
                fp, mlp, 0, image_size=2048, mip_to_level=m2l,
                pe_channels=6, use_tri_pe=True, dtype=dtype)
            args = (pc, c1v, pe_u, w2, b2, w3, b3, s)
            kw = dict(f=geom["f"], f1=geom["f1"], gelu=gelu)
            ab.report(f"K1 2048² {mode}·{gelu}",
                      lambda: k.decode_kernel_2d(*args, **kw))
        del fp, mlp, pc, c1v, pe_u, args
        gen = torch.Generator(device="cpu").manual_seed(256)
        fp3, mlp3 = ab.chip_smoke._pyramid3(gen, "cuda", 256, False,
                                            no_mip=True)
        m2l3 = pyramid_mip_levels(256, 64, True)
        for mode, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
            pc, c1v, pe_u, w2, b2, w3, b3, s, geom = k5._prepare_3d(
                fp3, mlp3, 0, image_size=256, mip_to_level=m2l3,
                pe_channels=6, use_tri_pe=True, sparse_g0=False, dtype=dtype)
            args = (pc, c1v, pe_u, w2, b2, w3, b3, s)
            kw = dict(f=geom["f"], f1=geom["f1"], gelu="exact")
            ab.report(f"K5 256³ {mode}·exact",
                      lambda: k5.decode_kernel_3d(*args, **kw))
            del pc, c1v, pe_u, args


if __name__ == "__main__":
    main()
