#!/usr/bin/env python3
"""Time the decode kernels K1 (2D), K2 (the z1-matmul decode), K5 (3D),
K3 (the v1 decode), K4 (the v3 MLP tail) and K13 (the hyperprior's σ →
bin) of one checkout of the port, for A/B comparisons of two checkouts on
one card.

    python3 scripts/torch_ab_decode.py ROOT [PARTS]

imports ``nic_torch`` from the checkout at ROOT (which builds its own
kernels under ROOT/build) and times it with the helpers of the
``chip_smoke.py`` beside this script, so that both checkouts are measured
by the same code. On a machine with one NVIDIA GPU it prints, for
``decode_kernel_2d`` on the column stage of ``chip_smoke``'s 2048² random
flagship-width model at mip 0, in fp32·exact, fp32·poly, bf16·exact,
bf16·poly, i16·tanherf and surgical·exact; for ``decode_kernel_z1mm``
(K2) on the same column stage in fp32·exact, bf16·poly and
surgical·exact, each beside K1 in its mode; for ``decode_kernel_3d`` on
the frame and
column stage of its 256³ random m3 model at mip 0 in fp32·exact and
bf16·exact; for ``decode_kernel_v1`` (K3) on the 2048² model at mip 0 in
fp32 and bf16; and for ``mlp_tail`` (K4) on that model's mip-0
first-layer accumulator in all four accumulator × dot dtypes, and the
whole v3 decode of that model (accumulator and K4) in fp32: the median
of 50 CUDA-event timings of the wrapper, by ``torch.profiler`` the device
time per call of all its kernels and of the longest by name (the body,
e.g. ``decode_v2_mma``, ``decode_z1mm_mma``, ``decode_v1_mma``,
``mlp_tail_mma``), and the first 16 hex digits of the SHA-256 of the
output's bytes: two checkouts whose kernels compute the same bits print
the same digest. It first prints the registers and spills ``ptxas -v``
reported for the checkout's decode tensor-core bodies
(``chip_smoke.ptxas_usage``). For ``hs_bins_kernel`` (K13, the
hyper-synthesis and σ → bin) it prints the registers and spills of the
checkout's K13 kernels (``ptxas -v``, by kernel), then on a seeded random
n = 96, m = 128 model (``HyperpriorModel``, generator seed 13) and ẑ at
512×768 (1×96×8×12) the wrapper ms, the device ms and the SHA-256 of σ's
bytes followed by the bins': K13 keeps its bits across a redesign when
both checkouts print the same digest. PARTS (comma-separated, of k1, k2,
k3, k4, v3, k5, k13; all by default) times only those.

Compare two checkouts only inside one call, in turns (parent, change,
change, parent).
"""

import hashlib
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

from nic_torch.grids.fastdecode import first_layer_acc  # noqa: E402
from nic_torch.grids.pyramid import pyramid_mip_levels  # noqa: E402
from nic_torch.kernels import decode_fused as k3  # noqa: E402
from nic_torch.kernels import decode_fused_3d as k5  # noqa: E402
from nic_torch.kernels import decode_fused_v2 as k  # noqa: E402
from nic_torch.kernels import decode_fused_v3 as k4  # noqa: E402
from nic_torch.kernels import _build  # noqa: E402
from nic_torch.kernels import hs_bins as k13  # noqa: E402
from nic_torch.models.hyperprior import HyperpriorModel  # noqa: E402


def report(tag: str, fn) -> None:
    """ab.report's timings of ``fn``, with the digest of its output."""
    out = fn()
    torch.cuda.synchronize()
    digest = hashlib.sha256(out.float().cpu().numpy().tobytes()).hexdigest()
    ab.report(f"{tag} sha256 {digest[:16]}", fn)


def k13_ptxas(log: str) -> list:
    """[(K13 kernel, registers, spill stores B, spill loads B)] from the
    ``ptxas -v`` lines of an nvcc log (the kernels of ``hs_bins.cu``, by
    mangled name and template arguments, e.g. ``hs_layerILi16ELi1ELb1ELb0EE``
    for ``hs_layer<16, 1, true, false>``)."""
    import re

    out, cur, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d(hs_[a-z_]+"
                      r"(?:I(?:L[ib]\d+E)+E)?)", line)
        if m or "Compiling entry function" in line:
            cur = m.group(1) if m else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur and spill:
            out.append((cur, int(m.group(1)), *spill))
            cur = None
    return out


def time_k13() -> None:
    print(f"AB {sys.argv[1]}: ptxas -v of K13 (registers, spill "
          "stores/loads B): " + "; ".join(
              f"{name} {r}, {ss}/{sl}" for name, r, ss, sl in
              k13_ptxas(_build.log_path().read_text())), flush=True)
    gen = torch.Generator().manual_seed(13)
    model = HyperpriorModel(96, 128, generator=gen).cuda()
    z = torch.round(torch.randn(1, 96, 8, 12, generator=gen) * 3.0).cuda()
    hs = k13.hs_weights(model.h_s)
    sigma, bins = k13.hs_bins_kernel(z, hs)
    torch.cuda.synchronize()
    digest = hashlib.sha256(sigma.cpu().numpy().tobytes()
                            + bins.cpu().numpy().tobytes()).hexdigest()
    ab.report(f"K13 512×768 (z 8×12×96 → σ 32×48×128) sha256 "
              f"{digest[:16]}", lambda: k13.hs_bins_kernel(z, hs))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    if not k.__file__.startswith(ab.ROOT):
        sys.exit(f"nic_torch came from {k.__file__}, not {ab.ROOT}")
    parts = (sys.argv[2].split(",") if len(sys.argv) > 2 else
             ["k1", "k2", "k3", "k4", "v3", "k5", "k13"])
    print(f"AB {sys.argv[1]}: {ab.chip_smoke.smi_line()}", flush=True)
    _build.load()
    usage = ab.chip_smoke.ptxas_usage(_build.log_path().read_text())
    print(f"AB {sys.argv[1]}: ptxas -v of the decode tensor-core bodies "
          "(registers, spill stores/loads B): " + "; ".join(
              f"{body}{key} {r}, {ss}/{sl}"
              for (body, key), (r, ss, sl, _) in sorted(usage.items())
              if body.startswith(("decode", "mlp_tail"))), flush=True)
    if "k13" in parts:
        time_k13()
    if not {"k1", "k2", "k3", "k4", "v3", "k5"} & set(parts):
        return
    fp, mlp, m2l = ab.chip_smoke._random_flagship("cuda", 2048)
    with torch.inference_mode():
        for mode, dtype, gelu in (("fp32", None, "exact"),
                                  ("fp32", None, "poly"),
                                  ("bf16", torch.bfloat16, "exact"),
                                  ("bf16", torch.bfloat16, "poly"),
                                  ("i16", "i16", "tanherf"),
                                  ("surgical", "surgical", "exact")):
            if not {"k1", "k2"} & set(parts):
                break
            pc, c1v, pe_u, w2, b2, w3, b3, s, geom = k._prepare_2d(
                fp, mlp, 0, image_size=2048, mip_to_level=m2l,
                pe_channels=6, use_tri_pe=True, dtype=dtype)
            args = (pc, c1v, pe_u, w2, b2, w3, b3)
            kw = dict(f=geom["f"], f1=geom["f1"], gelu=gelu)
            k2_cell = f"{mode}·{gelu}" in ("fp32·exact", "bf16·poly",
                                           "surgical·exact")
            if "k2" in parts and k2_cell:
                report(f"K2 2048² {mode}·{gelu}",
                       lambda: k.decode_kernel_z1mm(*args, R=geom["R"], **kw))
            if "k1" in parts or k2_cell:
                report(f"K1 2048² {mode}·{gelu}",
                       lambda: k.decode_kernel_2d(*args, s, **kw))
            del pc, c1v, pe_u, args
        for mode, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
            if "k3" not in parts:
                break
            args, kw = ab.chip_smoke._v1_args(fp, mlp, 0, m2l, 2048, dtype)
            report(f"K3 2048² {mode}",
                   lambda: k3.decode_kernel_v1(*args, use_tri_pe=True, **kw))
        if "k4" in parts:
            acc = first_layer_acc(fp, mlp, 0, image_size=2048,
                                  mip_to_level=m2l, pe_channels=6,
                                  use_tri_pe=True).contiguous()
            for acc_dtype in (torch.float32, torch.bfloat16):
                a = acc.to(acc_dtype)
                for dot in (torch.float32, torch.bfloat16):
                    w = (a, mlp["w2"].to(dot), mlp["b2"], mlp["w3"].to(dot),
                         mlp["b3"])
                    report(f"K4 2048² {str(acc_dtype)[6:]} accumulator, "
                           f"{str(dot)[6:]} dots", lambda: k4.mlp_tail(*w))
                del a, w
            del acc
        if "v3" in parts:
            report("v3 decode 2048² fp32 (accumulator + K4)",
                   lambda: k4.decode_image_fused_v3(
                       fp, mlp, 0, image_size=2048, mip_to_level=m2l,
                       pe_channels=6, use_tri_pe=True))
        del fp, mlp
        if "k5" not in parts:
            return
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
            report(f"K5 256³ {mode}·exact",
                   lambda: k5.decode_kernel_3d(*args, **kw))
            del pc, c1v, pe_u, args


if __name__ == "__main__":
    main()
