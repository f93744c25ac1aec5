#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``nic_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. a CUDA device is present; print ``nvidia-smi`` name and power limit;
2. build every CUDA kernel from ``nic_torch/kernels/csrc`` (the decode
   kernels K1 and K5 (the 3D decode, K1's body with a frame axis), the
   kernel3 train steps K11 (2D) and K12 (3D), and the dx (K6) and
   node-gradient (K7, kernel2; K9 in 3D) train kernels; one nvcc per
   source, all started together) for sm_90a, and print the build time;
3. each kernel against its plain PyTorch version on the card, on the
   committed trained artifact's column-stage outputs at mips 0-2, for every
   plane mode x GELU;
4. serve: the decoder-only CLI (``nic_torch.cli.decode.run``) decodes the
   committed artifact at mips 0-9 and is held to the JAX fold's decode
   stored beside it (u8 within 2 LSB, mip-0 PSNR within 0.05 dB); the
   kernel's launch counter must rise by exactly 3 (mips 0, 1, 2 take the
   kernel, thumbnails 3-9 the folded path); then the reduced-precision modes
   at mip 0 against their accuracy envelopes;
5. scale: a flagship-width 2048^2 artifact (C=12, H=64, FP_BITS 8, random
   weights from a seeded torch.Generator) saved and reloaded through the
   artifact format, decoded at mip 0 through the CLI, and the kernel timed
   against its plain version with CUDA events;
6. K11 against its plain version on the card at the flagship shape class
   (C=12, H=64, PE 6, 8 crops of 256², f=4) and at f=2 (128² crops) and
   f=1 (64² crops), random pyramid and MLP from a seeded torch.Generator,
   in fp32·erf and bf16·poly, each with QAT noise off and on: loss,
   ``out``, every MLP and PE grad and both accumulated node planes; then
   kernel vs plain timed at the flagship shape (bf16·poly noise on, the
   path's mode, and fp32·erf);
7. K7 against its plain version on the card at 8 crops of 256² (f=4),
   128² (f=2), 64² (f=1) and 16² (f=1), on the sinusoidal-PE gather of a
   random flagship-width pyramid and MLP, in fp32·erf and bf16·poly: loss,
   ``out``, every MLP grad, and dG0/dG1 after the unfold; two runs must
   be bit-identical; kernel vs plain timed at 8×256²;
8. K6 likewise at 8×32² (LOD 3), 8×4² (LOD 6), 8×2² (LOD 7) and 8×1²
   (LODs 8, 9; these two fill part of one 128-pixel tile) and 8×256² (the
   TRAIN_FORWARD=kernel shape), with dx among the compared outputs;
9. train: the training CLI (``nic_torch.cli.image_compression.run``) at
   the flagship configuration for 200 epochs (the overrides that made the
   committed fixture). The gate log must name kernel3 in both phases, K11
   must launch exactly 200 times, every loss be finite and the last 20
   lower than the first 20 on average, mip-0 PSNR within 1.0 dB of the
   fixture's JAX run; then the decode CLI decodes the artifact at mips
   0-9 with exactly 3 K1 launches;
10. path A, mip-mode training (TF_NO_MIP=0), 200 epochs: the gate log
    names kernel3 at LODs 0, 1, 2, 4 and kernel at the others it meets;
    K11 and K6 launch as often as the replayed LOD sequence visits those
    LODs (189 and 11 at SEED=0); the decode CLI decodes mips 0-9 with a
    K1 launch for each mip the kernel covers; mip-0 PSNR within 1.0 dB
    of a TRAIN_FORWARD=gather run of the same configuration; then
    TRAIN_FORWARD=kernel2 and kernel against gather from one seed
    (TRAIN_GELU=erf, the GELU gather runs): the same draws, so the
    losses must agree at step 1 to rel 1e-5 and over steps 1-10 to rtol
    2e-3 (the JAX suite's kernel tracking tolerance);
11. path B, sinusoidal-PE training (TF_USE_TRI_PE=0), 200 epochs: kernel2
    in both phases, K7 on every step, mip-0 PSNR and bpp beside a gather
    run's; then kernel2 against gather, as in phase 10;
12. train-step time (CUDA events, median over steps 50-199) for
    kernel3, kernel2 (path B), kernel (TRAIN_FORWARD=kernel) and gather
    (plain autograd), all at LOD 0, with the device operations per step
    counted by ``torch.profiler`` over 5 steps.

The 3D path (methods 3 and 4, the misty 64³ protocol: C=12, H=64, PE 6,
8 crops of 32³):

13. K5 against its plain version on random m3 and m4 mip-mode pyramids
    at 64³, mips 0, 1, 2 and 4, in fp32·exact, bf16·exact, bf16·poly and
    i16·tanherf;
14. the decode CLI on the committed 3D fixture at mips 0-6 against the
    JAX fold (fp32·exact within 2 u8 LSB at every mip, mip-0 PSNR within
    0.05 dB, K5 launched for mips 0, 1, 2, the ``--out`` AVI read back),
    then bf16 (≤ 8 LSB) and i16·tanherf (≤ 6 LSB) at mip 0;
15. a random-weight 256³ m3 artifact decoded through the CLI at mip 0 and
    held to the plain fold; K5 against its plain version timed, and the
    whole decode against ``fast_decode`` (GVox/s, peak memory);
16. K12 against its plain version at 8 crops of 32³ (f=4), 16³ (f=2),
    8³ (f=1) and 8³ at f=4 (slab blocks smaller than a cell in JAX), m3
    with triangular and m4 with sinusoidal PE, noise off and on,
    fp32·erf and bf16·poly (K11's tolerances, two runs bit-identical);
17. K9 likewise on the 3D gather, with dG0/dG1 after the unfold;
18. K6 at the 3D width F = 127 at 8×4³, 8×2³ and 8×1³ (partial tiles);
19. four 200-epoch 3D CLI runs: m3 flag-free (200 K12 launches, mip-0
    PSNR within 1.0 dB of the fixture's JAX run), m4 flag-free (200 K12),
    m3 mip mode (K12 and K6 as the replayed LOD sequence, K5 at mips 0,
    1, 2, 4) and m3 TRAIN_FORWARD=kernel2 (200 K9), the last three within
    1.0 dB of a gather run; then kernel3 (node noise) and kernel2 (shared
    feature noise) tracking gather from one seed over 10 steps;
20. the 3D LOD-0 step time for kernel3, kernel2, kernel and gather, as
    in phase 12.

The last line of standard output is one JSON object
``{"ok": true, "device": {...}}``; the line before it the card's name and
power limit, and before that the ``{"kernels": [...]}`` record: for each
kernel its launches on its main path (K1 the serve phase, K11 the
flagship training run, K6 path A, K7 path B, K5 the 3D serve, K12 the m3
flag-free run, K9 the kernel2 run), its time and its plain
version's at the path's shape and mode, and its bound, the larger of its
bytes (each input read once, each output written once) over 3.35 TB/s and
its dot operations (the JAX cost model's count) over the published peak
for their type (67 TFLOP/s fp32, 989 TFLOP/s bf16; H100 SXM, 700 W). No
single PyTorch call computes any of these fused functions, so
``library_ms`` is null.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

ART = os.path.join(ROOT, "tests", "fixtures", "ntc_sancho512_fp8.npz")
REF = os.path.join(ROOT, "tests", "fixtures", "ntc_sancho512_fp8_ref.npz")
KERNEL_SOURCE = "nic_torch/kernels/csrc/decode_fused_v2.cu"
REPLACES = "nic/kernels/decode_fused_v2.py:369"
K11_SOURCE = "nic_torch/kernels/csrc/train_fused_ff.cu"
K11_REPLACES = "nic/kernels/train_fused_ff.py:568"
K67_SOURCE = "nic_torch/kernels/csrc/train_fused.cu"
K6_REPLACES = "nic/kernels/train_fused.py:230"
K7_REPLACES = "nic/kernels/train_fused.py:510"
K5_SOURCE = KERNEL_SOURCE
K5_REPLACES = "nic/kernels/decode_fused_3d.py:144"
K12_SOURCE = "nic_torch/kernels/csrc/train_fused_ff3.cu"
K12_REPLACES = "nic/kernels/train_fused_ff3.py:462"
K9_REPLACES = "nic/kernels/train_fused.py:1171"
ART3 = os.path.join(ROOT, "tests", "fixtures", "ntc_misty64_m3_fp8.npz")
REF3 = os.path.join(ROOT, "tests", "fixtures", "ntc_misty64_m3_fp8_ref.npz")
CLIP = os.path.join(ROOT, "data", "misty_64_64.avi")
# published H100 SXM peaks at 700 W: memory bytes/s and dot FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}

# kernel vs plain tolerances on the [0, 1] output. fp32 planes and dots:
# only the summation order, FMA contraction and the libm of exp/tanh
# differ, so the JAX suite's 2e-5 holds. With bf16 dot inputs (bf16, i16,
# surgical), a last-bit fp32 difference in a GELU output can flip its bf16
# rounding (2^-9 relative), moving an output by up to |W|·|h|·2^-9: a few
# 1e-4 at H = 64; 2e-3 bounds that and is half an 8-bit step.
TOL = {"fp32": 2e-5, "bf16": 2e-3, "i16": 2e-3, "surgical": 2e-3}
# the u8 envelopes of the reduced modes against the JAX fold (ROADMAP.md)
ENVELOPE = {"bf16": ("exact", 8), "i16": ("tanherf", 3),
            "surgical": ("exact", 2)}
LSB_FP32, PSNR_DB = 2, 0.05  # main path: u8 LSB at every mip, mip-0 PSNR
# K11 vs plain, the JAX suite's tolerances for its fused train paths
# (tests/test_train_kernel.py): fp32 dots loss rel 1e-5, out 1e-5 abs,
# grads rel 1e-4; bf16 dot inputs loss rel 1e-4, out 1e-3 abs, grads rel
# 1e-2 (a last-bit difference can flip a bf16 rounding of a dot input)
K11_TOL = {"fp32": dict(loss=1e-5, out=1e-5, grad=1e-4),
           "bf16": dict(loss=1e-4, out=1e-3, grad=1e-2)}
K11_MODES = {"fp32·erf": ("fp32", "erf"), "bf16·poly": ("bf16", "poly")}
# training: the overrides of scripts/make_torch_port_fixture.py, whose JAX
# run the fixture's psnr[0] records; crop, noise and GELU streams differ
# by design, so the band is statistical
TRAIN_ARGS = ["NUM_EPOCHS=200", "SDC_GUARD_TRAIN=False"]
TRAIN_PSNR_DB = 1.0
PATH_A = TRAIN_ARGS + ["TF_NO_MIP=0"]        # mip-mode training
PATH_B = TRAIN_ARGS + ["TF_USE_TRI_PE=0"]    # sinusoidal-PE training
# the engine JAX's gates pick at each flagship LOD in mip mode (kernel3's
# gate refuses the step-2 LODs and LODs 6 and 8, kernel2's too)
KERNEL3_LODS = (0, 1, 2, 4)
# the 3D protocol (BASELINE.md §1.5): misty 64³, 8 crops of 32³; method 3
# unless a run says otherwise
MISTY = TRAIN_ARGS + ["IMAGE_PATH=data/misty_64_64.avi", "IMAGE_DIMENSION=3",
                      "COMPRESSION_METHOD=3", "IMAGE_SIZE=64",
                      "MAX_MIP_LEVEL=6", "CROP_MIP_LEVEL=5"]
# in 3D mip mode JAX's gates run kernel3 at LODs 0-2 and the dx kernel at
# 3-6 (the lattice gate, and at LOD 4 ff3_geometry)
KERNEL3_LODS_3D = (0, 1, 2)
# the 3D decode's envelopes at mip 0 against the JAX fold (BASELINE.md:94,
# :276-277); fp32·exact is held to LSB_FP32 at every mip
ENVELOPE_3D = {"bf16": ("exact", 8), "i16": ("tanherf", 6)}
# kernel2/kernel vs gather from one seed: the first step exactly (only the
# summation order differs), steps 1-10 at the JAX suite's rtol
TRACK_STEPS, TRACK_FIRST, TRACK_RTOL = 10, 1e-5, 2e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-ups."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, flops: float, dtype: str) -> tuple:
    """(least ms, "bytes" | "operations") on the card at its published
    peaks."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def u8(x):
    import numpy as np

    return np.floor(np.clip(x, 0, 1) * 255.0 + 0.5).astype(np.int64)


def phase_build() -> float:
    from nic_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    wall = time.perf_counter() - t0
    secs = _build.build_seconds if _build.build_seconds is not None else wall
    print(f"phase 2: kernels built in {secs:.1f} s "
          f"(nvcc, sm_90a; load {wall:.1f} s)", flush=True)
    return secs


def phase_parity(device) -> float:
    """Kernel vs plain on the fixture's column-stage outputs; returns the
    worst fp32·exact error."""
    import torch

    from nic_torch.grids.pyramid import pyramid_mip_levels
    from nic_torch.io.artifacts import load_compressed
    from nic_torch.kernels import decode_fused_v2 as k

    mlp, fp, meta = load_compressed(ART, device=device)
    m2l = pyramid_mip_levels(512, fp[0].shape[1] - 1, True)
    worst = {m: 0.0 for m in TOL}
    main_err = 0.0
    with torch.inference_mode():
        for mip in (0, 1, 2):
            for mode, dtype in (("fp32", None), ("bf16", torch.bfloat16),
                                ("i16", "i16"), ("surgical", "surgical")):
                pc, c1v, pe_u, w2, b2, w3, b3, s, geom = k._prepare_2d(
                    fp, mlp, mip, image_size=512, mip_to_level=m2l,
                    pe_channels=6, use_tri_pe=True, dtype=dtype)
                for gelu in k.GELUS:
                    kw = dict(f=geom["f"], f1=geom["f1"], gelu=gelu)
                    got = k.decode_kernel_2d(pc, c1v, pe_u, w2, b2, w3, b3,
                                             s, **kw)
                    torch.cuda.synchronize(device)
                    want = k.decode_kernel_2d_plain(pc, c1v, pe_u, w2, b2,
                                                    w3, b3, s, **kw)
                    if (got.shape != want.shape
                            or not torch.isfinite(got).all()):
                        fail(f"kernel output at mip {mip} {mode} {gelu}: "
                             f"shape {tuple(got.shape)} or non-finite")
                    err = float((got - want).abs().max())
                    worst[mode] = max(worst[mode], err)
                    if mode == "fp32" and gelu == "exact":
                        main_err = max(main_err, err)
                    if err > TOL[mode]:
                        fail(f"kernel vs plain at mip {mip} {mode}·{gelu}: "
                             f"max|Δ| {err:.3e} > {TOL[mode]:.0e}")
    print("phase 3: kernel vs plain, mips 0-2 x 6 GELUs, worst max|Δ| per "
          "plane mode: " + ", ".join(f"{m} {e:.3e} (tol {TOL[m]:.0e})"
                                     for m, e in worst.items()), flush=True)
    return main_err


def phase_serve(device) -> int:
    """The CLI on the fixture at mips 0-9; returns the kernel launches."""
    import numpy as np
    import torch

    from nic_torch.cli.decode import run
    from nic_torch.core.metrics import psnr
    from nic_torch.kernels.decode_fused_v2 import decode_kernel_2d

    ref = dict(np.load(REF))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        decode_kernel_2d.launches = 0
        recs = [run([ART, "--mip", str(mip), "--device", device]
                    + (["--out", os.path.join(tmp, "mip0.png")]
                       if mip == 0 else []))
                for mip in range(10)]
        launches = decode_kernel_2d.launches
        if not os.path.getsize(os.path.join(tmp, "mip0.png")):
            fail("the CLI wrote an empty PNG")
    lsb = []
    for mip, rec in enumerate(recs):
        want = ref[f"dec{mip}"].astype(np.int64)
        if rec.shape != want.shape or not np.isfinite(rec).all():
            fail(f"mip {mip}: shape {rec.shape} (want {want.shape}) or "
                 f"non-finite values")
        lsb.append(int(np.abs(u8(rec) - want).max()))
    p0 = float(psnr(torch.from_numpy(ref["orig0"]).double(),
                    torch.from_numpy(u8(recs[0])).double()))
    print(f"phase 4: fp32·exact u8 LSB vs the JAX fold, mips 0-9: {lsb}; "
          f"mip-0 PSNR {p0:.4f} dB (JAX fold {ref['psnr'][0]:.4f}); "
          f"kernel launches {launches}", flush=True)
    if max(lsb) > LSB_FP32:
        fail(f"u8 difference {max(lsb)} LSB > {LSB_FP32}")
    if abs(p0 - float(ref["psnr"][0])) > PSNR_DB:
        fail(f"mip-0 PSNR {p0:.4f} is not within {PSNR_DB} dB of "
             f"{float(ref['psnr'][0]):.4f}")
    if launches != 3:
        fail(f"the decode kernel launched {launches} times over mips 0-9; "
             f"expected 3 (mips 0, 1, 2)")
    for mode, (gelu, bar) in ENVELOPE.items():
        rec = run([ART, "--mip", "0", "--device", device, "--dtype", mode,
                   "--gelu", gelu])
        d = int(np.abs(u8(rec) - ref["dec0"].astype(np.int64)).max())
        print(f"phase 4: --dtype {mode} --gelu {gelu}: {d} LSB at mip 0 "
              f"(envelope {bar})", flush=True)
        if d > bar:
            fail(f"--dtype {mode} --gelu {gelu}: {d} LSB > {bar}")
    return launches


def _timings(fp, mlp, size, m2l, device, label) -> dict:
    """Kernel vs plain at mip 0 of a ``size``² model, per plane mode."""
    import torch

    from nic_torch.grids.fastdecode import fast_decode
    from nic_torch.kernels import decode_fused_v2 as k

    out = {}
    npix = size * size
    kw = dict(image_size=size, mip_to_level=m2l, pe_channels=6)
    with torch.inference_mode():
        for mode, dtype in (("fp32", None), ("bf16", torch.bfloat16),
                            ("i16", "i16"), ("surgical", "surgical")):
            pc, c1v, pe_u, w2, b2, w3, b3, s, geom = k._prepare_2d(
                fp, mlp, 0, use_tri_pe=True, dtype=dtype, **kw)
            args = (pc, c1v, pe_u, w2, b2, w3, b3, s)
            hidden = w2.shape[0]
            work = (nbytes(*args) + npix * 3 * 4,
                    2 * npix * (hidden * hidden + 3 * hidden))
            for gelu in (k.GELUS if mode == "fp32" else ("exact",)):
                g = dict(f=geom["f"], f1=geom["f1"], gelu=gelu)
                ms = cuda_ms(lambda: k.decode_kernel_2d(*args, **g))
                plain = cuda_ms(lambda: k.decode_kernel_2d_plain(*args, **g))
                out[(mode, gelu)] = (ms, plain, work)
                print(f"phase 5: {label} kernel {mode}·{gelu}: {ms:.4f} ms "
                      f"({npix / ms / 1e6:.3f} GPix/s) vs plain "
                      f"{plain:.4f} ms ({npix / plain / 1e6:.3f} GPix/s)",
                      flush=True)
        for name, fn in (
                ("decode_image_fused_v2 (column stage + kernel)",
                 lambda: k.decode_image_fused_v2(fp, mlp, 0, **kw)),
                ("fast_decode (plain fold)",
                 lambda: fast_decode(fp, mlp, 0, **kw))):
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            ms = cuda_ms(fn)
            peak = (torch.cuda.max_memory_allocated(device) - base) / 2**20
            out[name] = ms
            print(f"phase 5: {label} end to end, {name}: {ms:.4f} ms "
                  f"({npix / ms / 1e6:.3f} GPix/s), peak {peak:.0f} MiB "
                  f"above the model", flush=True)
    return out


def phase_scale(device, size: int = 2048) -> dict:
    import numpy as np
    import torch

    from nic_torch.cli.decode import run
    from nic_torch.grids.fastdecode import fast_decode
    from nic_torch.grids.pyramid import (create_pyramid, pyramid_mip_levels,
                                         pyramid_quantize_all)
    from nic_torch.io.artifacts import load_compressed, save_compressed
    from nic_torch.models.mlp import init_mlp

    base, bits = size // 4, 8
    gen = torch.Generator(device="cpu").manual_seed(size)
    fp, _ = create_pyramid(gen, base, 12, bits, device=device, no_mip=True)
    fp = pyramid_quantize_all(fp, bits)
    mlp = init_mlp(gen, 12 * 5 + 2 * 6 + 1, 64, 3, device=device)
    meta = {"save_name": f"chip_smoke_{size}", "config": {
        "image_size": size, "image_size_w": 0, "pe_channels": 6,
        "tf_use_tri_pe": True, "tf_no_mip": True, "compression_method": 1,
        "image_dimension": 2}}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, f"flagship_{size}.npz")
        save_compressed(path, mlp, fp, bits, meta)
        rec = run([path, "--mip", "0", "--device", device])
        mlp, fp, _ = load_compressed(path, device=device)
    m2l = pyramid_mip_levels(size, base, True)
    with torch.inference_mode():
        want = fast_decode(fp, mlp, 0, image_size=size, mip_to_level=m2l,
                           pe_channels=6).cpu().numpy()
    err = float(np.abs(rec - np.clip(want, 0, 1)).max())
    print(f"phase 5: {size}² CLI decode {rec.shape}, max|Δ| vs the plain fold "
          f"{err:.3e} (tol {TOL['fp32']:.0e})", flush=True)
    if rec.shape != (size, size, 3) or not np.isfinite(rec).all():
        fail(f"{size}² decode: shape {rec.shape} or non-finite values")
    if err > TOL["fp32"]:
        fail(f"{size}² decode differs from the plain fold by {err:.3e}")
    timings = _timings(fp, mlp, size, m2l, device, f"{size}²")
    mlp512, fp512, _ = load_compressed(ART, device=device)
    timings512 = _timings(fp512, mlp512, 512,
                          pyramid_mip_levels(512, 128, True), device, "512²")
    return {size: timings, 512: timings512}


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / (b.double().abs().max() + 1e-12))


def _compare(tag, names, got, want, tol) -> dict:
    """Per-output errors of a kernel against its plain version (out:
    max|Δ|; the rest: max|Δ|/max|want|), outputs the plain version leaves
    None skipped; fails past ``tol``."""
    import torch

    errs = {}
    for name, a, b in zip(names, got, want):
        if b is None:
            continue
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{tag}: {name} shape {tuple(a.shape)} (want "
                 f"{tuple(b.shape)}) or non-finite values")
        errs[name] = (float((a - b).abs().max()) if name == "out"
                      else _rel(a, b))
    bad = [nm for nm, e in errs.items()
           if e > tol["loss" if nm == "loss" else
                      "out" if nm == "out" else "grad"]]
    if bad:
        fail(f"{tag}: " + ", ".join(f"{nm} {errs[nm]:.3e}" for nm in bad))
    return errs


def _run_twice(tag, fn):
    """``fn()`` twice on the card: the results must be bit-identical (every
    reduction runs in a fixed order)."""
    import torch

    got, again = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)
               if a is not None):
        fail(f"{tag}: two runs differ (the reductions must be in a fixed "
             "order)")
    return got


def _k11_inputs(gen, device, n, f, crops=8, size=512):
    """Random flagship-width pyramid and MLP (torch.Generator), folded,
    with crops of n² on the LOD image of size·f/4."""
    import torch

    from nic_torch.grids.pyramid import create_pyramid
    from nic_torch.kernels.train_fused_ff import fold_planes
    from nic_torch.models.mlp import init_mlp

    fp, _ = create_pyramid(gen, size // 4, 12, 8, device=device, no_mip=True)
    mlp = init_mlp(gen, 12 * 5 + 2 * 6 + 1, 64, 3, device=device)
    img = size * f // 4
    origins = torch.randint(0, img - n + 1, (crops, 2), generator=gen)
    tgt = torch.rand(crops * n * n, 3, generator=gen).to(device)
    words = torch.randint(-2**31, 2**31, (2,), generator=gen)
    seed = torch.cat([words, torch.zeros(2, dtype=torch.int64)]).to(
        torch.int32)
    planes = {cd: fold_planes(fp[0], fp[1], mlp["w1"],
                              None if cd == "fp32" else torch.bfloat16)
              for cd in ("fp32", "bf16")}
    weights = [mlp[k].detach() for k in ("w1", "b1", "w2", "b2", "w3", "b3")]
    return planes, weights, tgt, origins, seed


def _k11_call(inputs, n, f, cd, gelu, nbits) -> tuple:
    """(args, kwargs) of ``fused_train_ff_kernel`` on ``_k11_inputs``'s
    ``inputs`` in the mode (cd, gelu, nbits)."""
    import torch

    planes, weights, tgt, origins, seed = inputs
    return ((*planes[cd], *weights, tgt, origins, seed),
            dict(n=n, f=f, npe=6, lodf=0.0, gelu=gelu,
                 cd=None if cd == "fp32" else torch.bfloat16, nbits=nbits))


def phase_k11(device) -> dict:
    """K11 vs plain at f = 4, 2, 1 in 4 modes; timings at the flagship."""
    import torch

    from nic_torch.kernels import train_fused_ff as k

    names = ("loss", "out", "dw2", "db2", "dw3", "db3", "dpe0", "dpe1",
             "db1", "P_acc", "C1_acc", "dw1e")
    gen = torch.Generator(device="cpu").manual_seed(11)
    timings = {}
    out_err = 0.0
    with torch.no_grad():  # the plain version takes autograd inside
        for n, f in ((256, 4), (128, 2), (64, 1)):
            inputs = _k11_inputs(gen, device, n, f)
            _, weights, tgt, origins, _ = inputs
            for label, (cd, gelu) in K11_MODES.items():
                tol = K11_TOL[cd]
                for nbits in (None, 8):
                    args, kw = _k11_call(inputs, n, f, cd, gelu, nbits)
                    cell = f"f={f} {label} noise={'on' if nbits else 'off'}"
                    got = _run_twice(f"K11 {cell}", lambda: (
                        k.fused_train_ff_kernel(*args, **kw)))
                    want = k.fused_train_ff_plain(*args, **kw)
                    errs = _compare(f"K11 vs plain {cell}", names, got, want,
                                    tol)
                    worst_grad = max(e for nm, e in errs.items()
                                     if nm not in ("loss", "out"))
                    print(f"phase 6: K11 vs plain {cell}: loss rel "
                          f"{errs['loss']:.2e}, out max|Δ| {errs['out']:.2e},"
                          f" worst grad/plane rel {worst_grad:.2e} "
                          f"(tol {tol['loss']:.0e}/{tol['out']:.0e}/"
                          f"{tol['grad']:.0e})", flush=True)
                    if n == 256 and cd == "bf16" and nbits:
                        out_err = errs["out"]
                    if n == 256 and ((cd, nbits) in (("bf16", 8),
                                                     ("fp32", None))):
                        ms = cuda_ms(lambda: k.fused_train_ff_kernel(*args,
                                                                     **kw))
                        plain = cuda_ms(lambda: k.fused_train_ff_plain(
                            *args, **kw))
                        # dots: z2, z3 and their backward (6·N·(H² + 3H)),
                        # with noise ε·W1 and εᵀ·dz1 (4·N·F·H)
                        npix, hid, feat = tgt.shape[0], 64, weights[0].shape[0]
                        flops = 6 * npix * (hid * hid + 3 * hid) + (
                            4 * npix * feat * hid if nbits else 0)
                        work = (nbytes(*args[:9], origins) + nbytes(*got),
                                flops)
                        timings[cell] = (ms, plain, work)
                        print(f"phase 6: K11 {cell} at 8×256²: kernel "
                              f"{ms:.4f} ms vs plain {plain:.4f} ms",
                              flush=True)
    return {"timings": timings, "out_err": out_err}


def _csv_losses(root: str):
    import csv
    import glob

    (path,) = glob.glob(os.path.join(root, "log", "*_scalars.csv"))
    with open(path) as fh:
        rows = [r for r in csv.DictReader(fh)
                if r["tag"] == "Loss/train_epoch_label"]
    return [float(r["value"]) for r in sorted(rows,
                                              key=lambda r: int(r["step"]))]


def phase_train(device) -> int:
    """The training CLI at the flagship configuration; returns K11's
    launches in that run."""
    import numpy as np

    ref = dict(np.load(REF))
    run = _cli_train(TRAIN_ARGS)
    res, losses, launches = run["res"], run["losses"], run["launches"]
    print(f"phase 9: training CLI, 200 epochs in {run['wall']:.1f} s of wall "
          f"time; gates: {run['gates']}; launches {launches}; loss first "
          f"{losses[0]:.5f} last {losses[-1]:.5f}; mip-0 PSNR "
          f"{res['psnr'][0]:.4f} dB (fixture's JAX run "
          f"{float(ref['psnr'][0]):.4f}), bpp {res['bpp']:.4f}; decode CLI "
          f"mips 0-9 shapes {[r.shape[0] for r in run['recs']]}, K1 launches "
          f"{run['k1']}", flush=True)
    if run["engine"] != {(0, False): "kernel3", (0, True): "kernel3"}:
        fail(f"the gate log does not name kernel3 in both phases: "
             f"{run['gates']}")
    if launches != {"K11": 200, "K6": 0, "K7": 0, "K12": 0, "K9": 0}:
        fail(f"launches {launches} in 200 epochs; want K11 200")
    if len(losses) != 200 or not np.isfinite(losses).all():
        fail(f"{len(losses)} losses, finite: {np.isfinite(losses).all()}")
    if not np.mean(losses[-20:]) < np.mean(losses[:20]):
        fail("the loss did not fall: mean of the last 20 "
             f"{np.mean(losses[-20:]):.5f} vs first 20 "
             f"{np.mean(losses[:20]):.5f}")
    if abs(res["psnr"][0] - float(ref["psnr"][0])) > TRAIN_PSNR_DB:
        fail(f"mip-0 PSNR {res['psnr'][0]:.4f} dB is not within "
             f"{TRAIN_PSNR_DB} dB of {float(ref['psnr'][0]):.4f}")
    _check_decodes("flagship", run, no_mip=True)
    return launches["K11"]


NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


def _gather_inputs(gen, device, n, step, tri_pe, crops=8, size=512):
    """Random flagship-width no-mip pyramid (G0 [12,129,129]) and MLP
    (torch.Generator), and the gather of crops of n² at ``step`` on G0:
    (fp, weights, x [crops·n², 73], tgt, origins)."""
    import torch

    from nic_torch.grids.pyramid import create_pyramid
    from nic_torch.grids.sample import decoder_input
    from nic_torch.models.mlp import init_mlp

    fp, _ = create_pyramid(gen, size // 4, 12, 8, device=device, no_mip=True)
    mlp = init_mlp(gen, 12 * 5 + 2 * 6 + 1, 64, 3, device=device)
    img = int(round((size // 4) / step))   # pixels G0 spans at this step
    origins = torch.randint(0, img - n + 1, (crops, 2), generator=gen)
    x = decoder_input(fp, 0, origins.to(device), step, n, pe_channels=6,
                      mip_level=0, use_tri_pe=tri_pe).reshape(crops * n * n,
                                                              -1)
    tgt = torch.rand(crops * n * n, 3, generator=gen).to(device)
    weights = [mlp[k].detach() for k in NAMES]
    return fp, weights, x.contiguous(), tgt, origins


def _fused_work(x, tgt, weights, got, origins=None, with_dx=True) -> tuple:
    """(bytes, dot FLOPs) of one K6/K7 call: inputs read once, outputs
    written once; 6·N·(F·H + H·H + 3H), the JAX cost model, less the
    2·N·F·H of dx = dz1·W1ᵀ for K7 (``with_dx`` False), which forms none."""
    npix, feat = x.shape
    hid = weights[2].shape[0]
    return (nbytes(x, tgt, origins, *weights) + nbytes(*got),
            (6 if with_dx else 4) * npix * feat * hid
            + 6 * npix * (hid * hid + 3 * hid))


def phase_k7(device) -> dict:
    """K7 vs plain at 8 crops of 256², 128², 64², 16²; timings at 8×256²."""
    import torch

    from nic_torch.kernels import train_fused as k

    names = ("loss", "out", "dw1", "db1", "dw2", "db2", "dw3", "db3", "dG0",
             "dG1")
    gen = torch.Generator(device="cpu").manual_seed(7)
    timings = {}
    with torch.no_grad():  # the plain version takes autograd inside
        for n, f in ((256, 4), (128, 2), (64, 1), (16, 1)):
            fp, weights, x, tgt, origins = _gather_inputs(gen, device, n,
                                                          1.0 / f, False)
            geo = dict(g0_nodes=tuple(fp[0].shape[1:]),
                       g1_nodes=tuple(fp[1].shape[1:]))

            def unfolded(res):
                dg = k._unfold_node_grads(res[8], res[9], weights[0],
                                          channels=12, **geo)
                return tuple(res[:8]) + dg

            for label, (cd, gelu) in K11_MODES.items():
                kw = dict(n=n, f=f, gelu=gelu,
                          cd=None if cd == "fp32" else torch.bfloat16, **geo)
                args = (x, tgt, origins, *weights)
                cell = f"8×{n}² f={f} {label}"
                got = _run_twice(f"K7 {cell}", lambda: (
                    k.fused_mlp_loss_ng_kernel(*args, **kw)))
                want = k.fused_mlp_loss_ng_plain(*args, **kw)
                tol = K11_TOL[cd]
                errs = _compare(f"K7 vs plain {cell}", names, unfolded(got),
                                unfolded(want), tol)
                print(f"phase 7: K7 vs plain {cell}: loss rel "
                      f"{errs['loss']:.2e}, out max|Δ| {errs['out']:.2e}, "
                      f"MLP grads rel ≤ "
                      f"{max(errs[m] for m in names[2:8]):.2e}, dG0 "
                      f"{errs['dG0']:.2e}, dG1 {errs['dG1']:.2e} (tol "
                      f"{tol['loss']:.0e}/{tol['out']:.0e}/"
                      f"{tol['grad']:.0e})", flush=True)
                if n == 256:
                    ms = cuda_ms(lambda: k.fused_mlp_loss_ng_kernel(*args,
                                                                    **kw))
                    plain = cuda_ms(lambda: k.fused_mlp_loss_ng_plain(*args,
                                                                      **kw))
                    work = _fused_work(x, tgt, weights, got, origins,
                                       with_dx=False)
                    timings[label] = (ms, plain, work, errs["out"])
                    b_ms, b_by = bound(*work, cd)
                    print(f"phase 7: K7 {cell}: kernel {ms:.4f} ms vs plain "
                          f"{plain:.4f} ms; bound {b_ms:.4f} ms ({b_by})",
                          flush=True)
    return timings


def phase_k6(device) -> dict:
    """K6 vs plain at 8 crops of 32² (LOD 3), 4² (LOD 6), 2² (LOD 7) and
    1² (LODs 8, 9), the last two partial 128-pixel tiles, and 256²;
    timings at 8×32² (path A's largest) and 8×256²."""
    import torch

    from nic_torch.kernels import train_fused as k

    names = ("loss", "out", "dx", "dw1", "db1", "dw2", "db2", "dw3", "db3")
    gen = torch.Generator(device="cpu").manual_seed(6)
    timings = {}
    with torch.no_grad():
        for n, step in ((32, 2.0), (4, 1.0), (2, 2.0), (1, 1.0),
                        (256, 0.25)):
            _, weights, x, tgt, origins = _gather_inputs(gen, device, n, step,
                                                         True)
            for label, (cd, gelu) in K11_MODES.items():
                kw = dict(gelu=gelu,
                          cd=None if cd == "fp32" else torch.bfloat16)
                cell = f"8×{n}² {label}"
                got = _run_twice(f"K6 {cell}", lambda: (
                    k.fused_mlp_loss_kernel(x, tgt, *weights, **kw)))
                want = k.fused_mlp_loss_plain(x, tgt, *weights, **kw)
                tol = K11_TOL[cd]
                errs = _compare(f"K6 vs plain {cell}", names, got, want, tol)
                print(f"phase 8: K6 vs plain {cell}: loss rel "
                      f"{errs['loss']:.2e}, out max|Δ| {errs['out']:.2e}, "
                      f"dx rel {errs['dx']:.2e}, MLP grads rel ≤ "
                      f"{max(errs[m] for m in names[3:]):.2e}", flush=True)
                if n in (32, 256):
                    ms = cuda_ms(lambda: k.fused_mlp_loss_kernel(x, tgt,
                                                                 *weights,
                                                                 **kw))
                    plain = cuda_ms(lambda: k.fused_mlp_loss_plain(
                        x, tgt, *weights, **kw))
                    work = _fused_work(x, tgt, weights, got)
                    timings[(n, label)] = (ms, plain, work, errs["out"])
                    b_ms, b_by = bound(*work, cd)
                    print(f"phase 8: K6 {cell}: kernel {ms:.4f} ms vs plain "
                          f"{plain:.4f} ms; bound {b_ms:.4f} ms ({b_by})",
                          flush=True)
    return timings


def _train_counters() -> dict:
    from nic_torch.kernels.train_fused import (fused_mlp_loss_kernel,
                                               fused_mlp_loss_ng3_kernel,
                                               fused_mlp_loss_ng_kernel)
    from nic_torch.kernels.train_fused_ff import fused_train_ff_kernel
    from nic_torch.kernels.train_fused_ff3 import fused_train_ff3_kernel

    return {"K11": fused_train_ff_kernel, "K6": fused_mlp_loss_kernel,
            "K7": fused_mlp_loss_ng_kernel, "K12": fused_train_ff3_kernel,
            "K9": fused_mlp_loss_ng3_kernel}


def _cli_train(args, decode: bool = True, mips=range(10)) -> dict:
    """The training CLI in a fresh output root, every train kernel's
    counter set to 0 just before it and read just after; then (``decode``)
    the decode CLI at ``mips`` with K1's and K5's counters likewise."""
    import glob
    import re

    from nic_torch.cli import decode as dcli
    from nic_torch.cli import image_compression as tcli
    from nic_torch.kernels.decode_fused_3d import decode_kernel_3d
    from nic_torch.kernels.decode_fused_v2 import decode_kernel_2d

    counters = _train_counters()
    run = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        run["res"] = tcli.run(args + [f"OUTPUT_ROOT={tmp}"])
        run["wall"] = time.perf_counter() - t0
        run["launches"] = {k: c.launches for k, c in counters.items()}
        run["losses"] = _csv_losses(tmp)
        (printlog,) = glob.glob(os.path.join(tmp, "printlog", "*.txt"))
        with open(printlog) as fh:
            run["gates"] = [ln.strip() for ln in fh
                            if "train forward gate" in ln]
        run["engine"] = {}
        for ln in run["gates"]:
            m = re.search(r"lod=(\d+), frozen=(\w+)\): (\w+)", ln)
            run["engine"][(int(m[1]), m[2] == "True")] = m[3]
        if decode:
            decode_kernel_2d.launches = decode_kernel_3d.launches = 0
            run["recs"] = [dcli.run([run["res"]["artifact"], "--mip",
                                     str(mip)]) for mip in mips]
            run["k1"] = decode_kernel_2d.launches
            run["k5"] = decode_kernel_3d.launches
    return run


def _check_decodes(tag, run, no_mip: bool) -> int:
    """Every mip decoded at its size; K1 launched once per mip it covers.
    Returns that count."""
    import numpy as np

    from nic_torch.grids.pyramid import pyramid_mip_levels
    from nic_torch.kernels.decode_fused_v2 import kernel_covers_2d

    m2l = pyramid_mip_levels(512, 128, no_mip)
    covered = sum(kernel_covers_2d(mip, 512, m2l, 64) for mip in range(10))
    for mip, rec in enumerate(run["recs"]):
        if rec.shape != (512 >> mip, 512 >> mip, 3) or \
                not np.isfinite(rec).all():
            fail(f"{tag}: decode at mip {mip}: shape {rec.shape} or "
                 "non-finite")
    if run["k1"] != covered:
        fail(f"{tag}: the decode CLI launched K1 {run['k1']} times over "
             f"mips 0-9; the kernel covers {covered}")
    return covered


def _lod_sequence(args) -> list:
    """The LODs a run of ``args`` draws, replayed from the trainer's
    stream (numpy default_rng(SEED + 1) and the uniform gate)."""
    import numpy as np

    from nic_torch.config import parse_overrides
    from nic_torch.train.ntc import UniformLodSchedule, sample_lod

    cfg = parse_overrides(args)
    rng = np.random.default_rng(cfg.seed + 1)
    gate = UniformLodSchedule(cfg.uniform_distribution_rate)
    return [sample_lod(rng, gate(), cfg.effective_max_mip_level)
            for _ in range(cfg.num_epochs)]


def _track(tag, args, forward) -> tuple:
    """``forward`` and gather from one seed (TRAIN_GELU=erf, the GELU the
    gather path runs) see the same LODs, origins and noise: their losses
    must agree at step 1 and track over TRACK_STEPS steps."""
    import numpy as np

    from nic_torch.cli.image_compression import load_asset
    from nic_torch.config import parse_overrides
    from nic_torch.train.ntc import NTCTrainer

    losses, engines = {}, {}
    for fwd in (forward, "gather"):
        cfg = parse_overrides(args + [f"TRAIN_FORWARD={fwd}",
                                      "TRAIN_GELU=erf"])
        tr = NTCTrainer(cfg, load_asset(cfg))
        losses[fwd] = np.asarray(tr.train_many(TRACK_STEPS)[0], np.float64)
        engines[fwd] = sorted({p.mode for p in tr._plans.values()})
    a, b = losses[forward], losses["gather"]
    first = abs(a[0] - b[0]) / abs(b[0])
    worst = float(np.max(np.abs(a - b) / np.abs(b)))
    print(f"{tag}: TRAIN_FORWARD={forward} (engines {engines[forward]}) vs "
          f"gather, {TRACK_STEPS} steps from one seed: step-1 loss rel "
          f"{first:.2e} (tol {TRACK_FIRST:.0e}), worst step rel {worst:.2e} "
          f"(rtol {TRACK_RTOL:.0e}); losses {a[0]:.6f} → {a[-1]:.6f}",
          flush=True)
    if not (first <= TRACK_FIRST and worst <= TRACK_RTOL):
        fail(f"{tag}: TRAIN_FORWARD={forward} does not track gather")
    return first, worst


def phase_path_a(device) -> int:
    """Mip-mode training; returns K6's launches in the auto run."""
    import numpy as np

    run = _cli_train(PATH_A)
    gather = _cli_train(PATH_A + ["TRAIN_FORWARD=gather"], decode=False)
    lods = _lod_sequence(PATH_A)
    want = {lod: "kernel3" if lod in KERNEL3_LODS else "kernel"
            for lod in set(lods)}
    want_k11 = sum(want[lod] == "kernel3" for lod in lods)
    want_k6 = len(lods) - want_k11
    got = run["launches"]
    drawn = {int(v): int(c) for v, c in zip(*np.unique(lods,
                                                      return_counts=True))}
    p0, g0 = run["res"]["psnr"][0], gather["res"]["psnr"][0]
    print(f"phase 10: path A (TF_NO_MIP=0), 200 epochs in {run['wall']:.1f} s"
          f" of wall time; LODs drawn {drawn}; "
          f"gates {sorted(run['engine'].items())}; launches {got} "
          f"(want K11 {want_k11}, K6 {want_k6}); loss {run['losses'][0]:.5f}"
          f" → {run['losses'][-1]:.5f}; mip-0 PSNR {p0:.4f} dB vs gather "
          f"{g0:.4f} dB ({gather['wall']:.1f} s); bpp {run['res']['bpp']:.4f}",
          flush=True)
    for (lod, _), engine in run["engine"].items():
        if engine != want[lod]:
            fail(f"path A: LOD {lod} ran {engine}, JAX runs {want[lod]}")
    if got != {"K11": want_k11, "K6": want_k6, "K7": 0, "K12": 0, "K9": 0}:
        fail(f"path A: launches {got}, want K11 {want_k11}, K6 {want_k6}")
    if len(run["losses"]) != 200 or not np.isfinite(run["losses"]).all():
        fail("path A: the losses are not 200 finite values")
    if abs(p0 - g0) > TRAIN_PSNR_DB:
        fail(f"path A: mip-0 PSNR {p0:.4f} dB is not within "
             f"{TRAIN_PSNR_DB} dB of the gather run's {g0:.4f}")
    covered = _check_decodes("path A", run, no_mip=False)
    print(f"phase 10: path A decode CLI mips 0-9: shapes "
          f"{[r.shape[0] for r in run['recs']]}, K1 launches {run['k1']} "
          f"(the mips it covers: {covered})", flush=True)
    for forward in ("kernel2", "kernel"):
        _track("phase 10: path A", PATH_A, forward)
    return got["K6"]


def phase_path_b(device) -> int:
    """Sinusoidal-PE training; returns K7's launches in the auto run."""
    import numpy as np

    run = _cli_train(PATH_B)
    gather = _cli_train(PATH_B + ["TRAIN_FORWARD=gather"], decode=False)
    got = run["launches"]
    r, g = run["res"], gather["res"]
    print(f"phase 11: path B (TF_USE_TRI_PE=0), 200 epochs in "
          f"{run['wall']:.1f} s of wall time (gather {gather['wall']:.1f} s);"
          f" gates {sorted(run['engine'].items())}; launches {got}; loss "
          f"{run['losses'][0]:.5f} → {run['losses'][-1]:.5f}; mip-0 PSNR "
          f"{r['psnr'][0]:.4f} dB, bpp {r['bpp']:.4f} (gather run: "
          f"{g['psnr'][0]:.4f} dB, bpp {g['bpp']:.4f})", flush=True)
    if run["engine"] != {(0, False): "kernel2", (0, True): "kernel2"}:
        fail(f"path B: gates {run['engine']}, want kernel2 in both phases")
    if got != {"K11": 0, "K6": 0, "K7": 200, "K12": 0, "K9": 0}:
        fail(f"path B: launches {got}, want K7 200")
    if len(run["losses"]) != 200 or not np.isfinite(run["losses"]).all():
        fail("path B: the losses are not 200 finite values")
    if abs(r["psnr"][0] - g["psnr"][0]) > TRAIN_PSNR_DB:
        fail(f"path B: mip-0 PSNR {r['psnr'][0]:.4f} dB is not within "
             f"{TRAIN_PSNR_DB} dB of the gather run's {g['psnr'][0]:.4f}")
    _check_decodes("path B", run, no_mip=True)
    _track("phase 11: path B", PATH_B, "kernel2")
    return got["K7"]


def step_timing(engine, args, device, label=None) -> tuple:
    """200 steps of a trainer of ``args`` with TRAIN_FORWARD=``engine`` →
    (median step ms by CUDA events over steps 50-199, a line with that,
    the host ms per step over the same steps and, by torch.profiler over
    steps 40-44, the device operations and device ms per step with the
    five largest kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nic_torch.cli.image_compression import load_asset
    from nic_torch.config import parse_overrides
    from nic_torch.train.ntc import NTCTrainer

    cfg = parse_overrides(args + [f"TRAIN_FORWARD={engine}"])
    tr = NTCTrainer(cfg, load_asset(cfg))
    events = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for i in range(200):
        if i == 40:
            prof.start()
        if i == 50:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tr.train_step()
        end.record()
        events.append((start, end))
        if i == 44:
            torch.cuda.synchronize(device)
            prof.stop()
    torch.cuda.synchronize(device)
    wall = (time.perf_counter() - t0) / 150 * 1e3
    if tr._forward_mode != engine:
        fail(f"TRAIN_FORWARD={engine} ran {tr._forward_mode}")
    ops = sum(e.device_type == torch.autograd.DeviceType.CUDA
              for e in prof.events()) / 5
    ms = statistics.median(s.elapsed_time(e) for s, e in events[50:])
    # device time per step: the sum, and the five largest kernels
    kernels = sorted(((a.self_device_time_total / 5e3, a.key)
                      for a in prof.key_averages()
                      if a.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    busy = sum(t for t, _ in kernels)
    label = label or " ".join(args[len(TRAIN_ARGS):]) or "flagship"
    return ms, (
        f"train step {engine} ({label}): median {ms:.4f} ms by CUDA events "
        f"over steps 50-199 ({1e3 / ms:.1f} steps/s); host clock "
        f"{wall:.4f} ms/step ({1e3 / wall:.1f} steps/s); "
        + (f"{ops:.0f} device operations and {busy:.4f} ms of device time "
           f"per step (idle share {1 - busy / ms:.3f} of the median step); "
           "largest: " + "; ".join(f"{t:.4f} {k[:60]}"
                                   for t, k in kernels[:5])
           if ops else "device operations per step: not measured (the "
           "profiler saw no device activity)"))


def phase_step_time(device) -> dict:
    """Train-step times per engine at LOD 0 (:func:`step_timing`)."""
    out = {}
    for engine, args in (("kernel3", TRAIN_ARGS), ("kernel2", PATH_B),
                         ("kernel", TRAIN_ARGS), ("gather", TRAIN_ARGS)):
        out[engine], line = step_timing(engine, args, device)
        print(f"phase 12: {line}", flush=True)
    return out


def phase_step_time3(device) -> dict:
    """3D (misty m3, 8 crops of 32³) train-step times per engine at LOD 0."""
    out = {}
    for engine in ("kernel3", "kernel2", "kernel", "gather"):
        out[engine], line = step_timing(engine, MISTY, device,
                                        label="3D m3 8×32³")
        print(f"phase 20: {line}", flush=True)
    return out


# ---- the 3D path (methods 3 and 4) ------------------------------------

def _pyramid3(gen, device, size, sparse, no_mip):
    """Random flagship-width 3D pyramid and MLP (torch.Generator): C=12,
    H=64, PE 6, G0 of size/4 cells per axis."""
    from nic_torch.grids.pyramid import create_pyramid, pyramid_quantize_all
    from nic_torch.models.mlp import init_mlp

    fp, _ = create_pyramid(gen, size // 4, 12, 8, 3, device=device,
                           no_mip=no_mip)
    fp = pyramid_quantize_all(fp, 8)
    mlp = init_mlp(gen, 12 * ((4 if sparse else 8) + 1) + 3 * 6 + 1, 64, 3,
                   device=device)
    return fp, mlp


def _k5_work(args, nvox) -> tuple:
    """(bytes, dot FLOPs) of one K5 call: the planes, the row-PE table and
    the weights read once, the RGB written once; 2·N·(H² + 3H)."""
    hidden = args[2].shape[1]
    return (nbytes(*args) + nvox * 3 * 4,
            2 * nvox * (hidden * hidden + 3 * hidden))


def phase_k5(device) -> float:
    """K5 vs plain on random m3 and m4 mip-mode pyramids at 64³, mips 0-2
    and 4, in fp32·exact, bf16·exact, bf16·poly and i16·tanherf; returns
    the worst fp32·exact error."""
    import torch

    from nic_torch.grids.pyramid import pyramid_mip_levels
    from nic_torch.kernels import decode_fused_3d as k

    gen = torch.Generator(device="cpu").manual_seed(5)
    m2l = pyramid_mip_levels(64, 16, False)
    modes = (("fp32", None, "exact"), ("bf16", torch.bfloat16, "exact"),
             ("bf16", torch.bfloat16, "poly"), ("i16", "i16", "tanherf"))
    worst = {}
    with torch.inference_mode():
        for method in (3, 4):
            sparse = method == 4
            fp, mlp = _pyramid3(gen, device, 64, sparse, no_mip=False)
            for mip in (0, 1, 2, 4):
                if not k.kernel_covers_3d(mip, 64, m2l, 64):
                    fail(f"K5 does not cover mip {mip} of a mip-mode 64³")
                for mode, dtype, gelu in modes:
                    pc, c1v, pe_u, w2, b2, w3, b3, sc, geom = k._prepare_3d(
                        fp, mlp, mip, image_size=64, mip_to_level=m2l,
                        pe_channels=6, use_tri_pe=not sparse,
                        sparse_g0=sparse, dtype=dtype)
                    kw = dict(f=geom["f"], f1=geom["f1"], gelu=gelu)
                    args = (pc, c1v, pe_u, w2, b2, w3, b3, sc)
                    got = k.decode_kernel_3d(*args, **kw)
                    want = k.decode_kernel_3d_plain(*args, **kw)
                    if got.shape != want.shape or \
                            not torch.isfinite(got).all():
                        fail(f"K5 m{method} mip {mip} {mode}·{gelu}: shape "
                             f"{tuple(got.shape)} or non-finite")
                    err = float((got - want).abs().max())
                    key = f"{mode}·{gelu}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    if err > TOL[mode]:
                        fail(f"K5 vs plain m{method} mip {mip} {key}: "
                             f"max|Δ| {err:.3e} > {TOL[mode]:.0e}")
    print("phase 13: K5 vs plain, m3 and m4 at 64³, mips 0, 1, 2, 4, worst "
          "max|Δ|: " + ", ".join(f"{m} {e:.3e} (tol "
                                  f"{TOL[m.split('·')[0]]:.0e})"
                                  for m, e in worst.items()), flush=True)
    return worst["fp32·exact"]


def _misty_orig():
    """The clip as the trainer scores it: [T, H, W, 3] of codes/256·255."""
    import numpy as np

    from nic_torch.data.assets import load_volume

    return load_volume(CLIP).astype(np.float64) / 256.0 * 255.0


def phase_serve3(device) -> int:
    """The decode CLI on the 3D fixture at mips 0-6 against the JAX fold;
    returns K5's launches."""
    import numpy as np
    import torch

    from nic_torch.cli.decode import run
    from nic_torch.core.metrics import psnr
    from nic_torch.data.assets import read_clip
    from nic_torch.kernels.decode_fused_3d import decode_kernel_3d

    ref = dict(np.load(REF3))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        out = os.path.join(tmp, "mip0.avi")
        decode_kernel_3d.launches = 0
        recs = [run([ART3, "--mip", str(mip), "--device", device]
                    + (["--out", out] if mip == 0 else []))
                for mip in range(7)]
        launches = decode_kernel_3d.launches
        clip = read_clip(out)
    lsb = []
    for mip, rec in enumerate(recs):
        want = ref[f"dec{mip}"].astype(np.int64)
        if rec.shape != want.shape or not np.isfinite(rec).all():
            fail(f"3D mip {mip}: shape {rec.shape} (want {want.shape}) or "
                 "non-finite values")
        lsb.append(int(np.abs(u8(rec) - want).max()))
    if not np.array_equal(clip, (recs[0] * 255 + 0.5).astype(np.uint8)):
        fail("the AVI the decode CLI wrote does not read back as the decode")
    p0 = float(psnr(torch.from_numpy(_misty_orig()),
                    torch.from_numpy(u8(recs[0])).double()))
    print(f"phase 14: 3D fixture, fp32·exact u8 LSB vs the JAX fold, mips "
          f"0-6: {lsb}; mip-0 PSNR {p0:.4f} dB (JAX fold "
          f"{ref['psnr'][0]:.4f}); K5 launches {launches}; the AVI reads "
          "back", flush=True)
    if max(lsb) > LSB_FP32:
        fail(f"3D: u8 difference {max(lsb)} LSB > {LSB_FP32}")
    if abs(p0 - float(ref["psnr"][0])) > PSNR_DB:
        fail(f"3D: mip-0 PSNR {p0:.4f} is not within {PSNR_DB} dB of "
             f"{float(ref['psnr'][0]):.4f}")
    if launches != 3:
        fail(f"K5 launched {launches} times over mips 0-6; expected 3 "
             "(mips 0, 1, 2)")
    for mode, (gelu, bar) in ENVELOPE_3D.items():
        rec = run([ART3, "--mip", "0", "--device", device, "--dtype", mode,
                   "--gelu", gelu])
        d = int(np.abs(u8(rec) - ref["dec0"].astype(np.int64)).max())
        print(f"phase 14: 3D --dtype {mode} --gelu {gelu}: {d} LSB at mip 0 "
              f"(envelope {bar})", flush=True)
        if d > bar:
            fail(f"3D --dtype {mode} --gelu {gelu}: {d} LSB > {bar}")
    return launches


def phase_scale3(device, size: int = 256) -> tuple:
    """A flagship-width size³ m3 artifact (random weights), decoded at mip
    0 through the CLI and held to the plain fold; then K5 vs plain and the
    end-to-end decode timed. Returns (kernel ms, plain ms, work)."""
    import numpy as np
    import torch

    from nic_torch.cli.decode import run
    from nic_torch.grids.fastdecode import fast_decode
    from nic_torch.grids.pyramid import pyramid_mip_levels
    from nic_torch.io.artifacts import load_compressed, save_compressed
    from nic_torch.kernels import decode_fused_3d as k

    gen = torch.Generator(device="cpu").manual_seed(size)
    fp, mlp = _pyramid3(gen, device, size, False, no_mip=True)
    meta = {"save_name": f"chip_smoke_{size}3", "config": {
        "image_size": size, "image_size_w": 0, "pe_channels": 6,
        "tf_use_tri_pe": True, "tf_no_mip": True, "compression_method": 3,
        "image_dimension": 3}}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, f"m3_{size}.npz")
        save_compressed(path, mlp, fp, 8, meta)
        rec = run([path, "--mip", "0", "--device", device])
        mlp, fp, _ = load_compressed(path, device=device)
    m2l = pyramid_mip_levels(size, size // 4, True)
    kw = dict(image_size=size, mip_to_level=m2l, pe_channels=6)
    nvox = size**3
    with torch.inference_mode():
        want = fast_decode(fp, mlp, 0, ndim=3, **kw).clamp(0, 1).cpu()
        err = float(np.abs(rec - want.numpy()).max())
        del want
        print(f"phase 15: {size}³ CLI decode {rec.shape}, max|Δ| vs the "
              f"plain fold {err:.3e} (tol {TOL['fp32']:.0e})", flush=True)
        if rec.shape != (size,) * 3 + (3,) or not np.isfinite(rec).all():
            fail(f"{size}³ decode: shape {rec.shape} or non-finite")
        if err > TOL["fp32"]:
            fail(f"{size}³ decode differs from the plain fold by {err:.3e}")
        pc, c1v, pe_u, w2, b2, w3, b3, sc, geom = k._prepare_3d(
            fp, mlp, 0, use_tri_pe=True, sparse_g0=False, dtype=None, **kw)
        args = (pc, c1v, pe_u, w2, b2, w3, b3, sc)
        g = dict(f=geom["f"], f1=geom["f1"], gelu="exact")
        ms = cuda_ms(lambda: k.decode_kernel_3d(*args, **g))
        plain = cuda_ms(lambda: k.decode_kernel_3d_plain(*args, **g),
                        warmup=1, reps=3)
        work = _k5_work(args, nvox)
        b_ms, b_by = bound(*work, "fp32")
        print(f"phase 15: {size}³ K5 fp32·exact: kernel {ms:.4f} ms "
              f"({nvox / ms / 1e6:.3f} GVox/s) vs plain {plain:.4f} ms; "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        del pc, c1v, args
        for name, fn in (
                ("decode_volume_fused (frame/column stage + K5)",
                 lambda: k.decode_volume_fused(fp, mlp, 0, **kw)),
                ("fast_decode (plain fold)",
                 lambda: fast_decode(fp, mlp, 0, ndim=3, **kw))):
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            t = cuda_ms(fn, warmup=1, reps=3)
            peak = (torch.cuda.max_memory_allocated(device) - base) / 2**20
            print(f"phase 15: {size}³ end to end, {name}: {t:.4f} ms "
                  f"({nvox / t / 1e6:.3f} GVox/s), peak {peak:.0f} MiB above "
                  "the model", flush=True)
    return ms, plain, work


def _inputs3(gen, device, n, f, sparse, crops=8, size=64):
    """Random flagship-width no-mip 3D pyramid (G0 [12, 17³]) and MLP, crops
    of n³ inside what G0 covers at period f, targets and seed words."""
    import torch

    fp, mlp = _pyramid3(gen, device, size, sparse, no_mip=True)
    cover = (size // 4) * f
    origins = torch.randint(0, cover - n + 1, (crops, 3), generator=gen)
    tgt = torch.rand(crops * n**3, 3, generator=gen).to(device)
    words = torch.randint(-2**31, 2**31, (2,), generator=gen)
    seed = torch.cat([words, torch.zeros(2, dtype=torch.int64)]).to(
        torch.int32)
    weights = [mlp[k].detach() for k in NAMES]
    return fp, weights, tgt, origins, seed


# the K12/K9 shapes: 8 crops of 32³ (f=4, LOD 0), 16³ (f=2, LOD 1), 8³ (f=1,
# LOD 2), and 8³ at f=4 (JAX's rowsb < f class: slab blocks straddle cells)
SHAPES3 = ((32, 4), (16, 2), (8, 1), (8, 4))


def phase_k12(device) -> dict:
    """K12 vs plain at SHAPES3, m3 (triangular PE) and m4 (sinusoidal PE),
    noise off and on, fp32·erf and bf16·poly; timings at 8×32³."""
    import torch

    from nic_torch.kernels import train_fused_ff3 as k

    names = ("loss", "out", "dw2", "db2", "dw3", "db3", "dpe0", "dpe1",
             "dpe2", "db1", "P_acc", "C1_acc", "dw1e")
    gen = torch.Generator(device="cpu").manual_seed(12)
    timings, worst = {}, {}
    with torch.no_grad():
        for n, f in SHAPES3:
            for method in (3, 4):
                sparse = method == 4
                fp, weights, tgt, origins, seed = _inputs3(gen, device, n, f,
                                                           sparse)
                for label, (cd, gelu) in K11_MODES.items():
                    cdt = None if cd == "fp32" else torch.bfloat16
                    vols = k.fold_volumes(fp[0], fp[1], weights[0], sparse,
                                          cdt)
                    for nbits in (None, 8):
                        args = (*vols, *weights, tgt, origins, seed)
                        kw = dict(n=n, f=f, npe=6, lodf=0.0, sparse_g0=sparse,
                                  use_tri_pe=not sparse, cd=cdt, gelu=gelu,
                                  nbits=nbits)
                        cell = (f"8×{n}³ f={f} m{method} {label} noise="
                                f"{'on' if nbits else 'off'}")
                        got = _run_twice(f"K12 {cell}", lambda: (
                            k.fused_train_ff3_kernel(*args, **kw)))
                        want = k.fused_train_ff3_plain(*args, **kw)
                        tol = K11_TOL[cd]
                        errs = _compare(f"K12 vs plain {cell}", names, got,
                                        want, tol)
                        for nm, e in errs.items():
                            key = (label, nm)
                            worst[key] = max(worst.get(key, 0.0), e)
                        if n == 32 and method == 3 and (
                                (cd, nbits) in (("bf16", 8), ("fp32", None))):
                            ms = cuda_ms(lambda: k.fused_train_ff3_kernel(
                                *args, **kw))
                            plain = cuda_ms(lambda: k.fused_train_ff3_plain(
                                *args, **kw))
                            npix, hid = tgt.shape[0], 64
                            feat = weights[0].shape[0]
                            flops = 6 * npix * (hid * hid + 3 * hid) + (
                                4 * npix * feat * hid if nbits else 0)
                            work = (nbytes(*args[:9], origins)
                                    + nbytes(*got), flops)
                            timings[cell] = (ms, plain, work, errs["out"])
                            b_ms, b_by = bound(*work, cd)
                            print(f"phase 16: K12 {cell}: kernel {ms:.4f} ms "
                                  f"vs plain {plain:.4f} ms; bound "
                                  f"{b_ms:.4f} ms ({b_by})", flush=True)
    for label in K11_MODES:
        tol = K11_TOL[K11_MODES[label][0]]
        errs = {nm: e for (lb, nm), e in worst.items() if lb == label}
        print(f"phase 16: K12 vs plain {label}, worst over {len(SHAPES3)} "
              f"shapes × m3/m4 × noise off/on: loss rel {errs['loss']:.2e}, "
              f"out max|Δ| {errs['out']:.2e}, worst grad/volume rel "
              f"{max(e for nm, e in errs.items() if nm not in ('loss', 'out')):.2e}"
              f" (tol {tol['loss']:.0e}/{tol['out']:.0e}/{tol['grad']:.0e});"
              " reruns bit-identical", flush=True)
    return timings


def _gather3(fp, origins, n, f, sparse, device):
    from nic_torch.grids.sample import decoder_input

    x = decoder_input(fp, 0, origins, 1.0 / f, n, pe_channels=6, mip_level=0,
                      ndim=3, use_tri_pe=not sparse, sparse_g0=sparse)
    return x.reshape(origins.shape[0] * n**3, -1).contiguous()


def phase_k9(device) -> dict:
    """K9 vs plain at SHAPES3, m3 and m4, fp32·erf and bf16·poly, on the 3D
    gather: loss, out, every MLP grad, dG0/dG1 after the unfold; timings at
    8×32³."""
    import torch

    from nic_torch.kernels import train_fused as k

    names = ("loss", "out", "dw1", "db1", "dw2", "db2", "dw3", "db3", "dG0",
             "dG1")
    gen = torch.Generator(device="cpu").manual_seed(9)
    timings = {}
    with torch.no_grad():
        for n, f in SHAPES3:
            for method in (3, 4):
                sparse = method == 4
                corners = (k._CORNERS_3D_SPARSE if sparse
                           else k._CORNERS_3D_DENSE)
                fp, weights, tgt, origins, _ = _inputs3(gen, device, n, f,
                                                        sparse)
                x = _gather3(fp, origins, n, f, sparse, device)
                geo = dict(g0_nodes=tuple(fp[0].shape[1:]),
                           g1_nodes=tuple(fp[1].shape[1:]))

                def unfolded(res):
                    dg = k._unfold_node_grads(res[8], res[9], weights[0],
                                              channels=12, corners=corners,
                                              **geo)
                    return tuple(res[:8]) + dg

                for label, (cd, gelu) in K11_MODES.items():
                    kw = dict(n=n, f=f, gelu=gelu,
                              cd=None if cd == "fp32" else torch.bfloat16,
                              **geo)
                    args = (x, tgt, origins, *weights)
                    cell = f"8×{n}³ f={f} m{method} {label}"
                    got = _run_twice(f"K9 {cell}", lambda: (
                        k.fused_mlp_loss_ng3_kernel(*args, **kw)))
                    want = k.fused_mlp_loss_ng_plain(*args, **kw)
                    tol = K11_TOL[cd]
                    errs = _compare(f"K9 vs plain {cell}", names,
                                    unfolded(got), unfolded(want), tol)
                    print(f"phase 17: K9 vs plain {cell}: loss rel "
                          f"{errs['loss']:.2e}, out max|Δ| {errs['out']:.2e},"
                          f" MLP grads rel ≤ "
                          f"{max(errs[m] for m in names[2:8]):.2e}, dG0 "
                          f"{errs['dG0']:.2e}, dG1 {errs['dG1']:.2e}",
                          flush=True)
                    if n == 32 and method == 3:
                        ms = cuda_ms(lambda: k.fused_mlp_loss_ng3_kernel(
                            *args, **kw))
                        plain = cuda_ms(lambda: k.fused_mlp_loss_ng_plain(
                            *args, **kw))
                        work = _fused_work(x, tgt, weights, got, origins,
                                           with_dx=False)
                        timings[label] = (ms, plain, work, errs["out"])
                        b_ms, b_by = bound(*work, cd)
                        print(f"phase 17: K9 {cell}: kernel {ms:.4f} ms vs "
                              f"plain {plain:.4f} ms; bound {b_ms:.4f} ms "
                              f"({b_by})", flush=True)
    return timings


def phase_k6_3d(device) -> dict:
    """K6 at the 3D F = 127 on the 3D gather of 8 crops of 4³, 2³ and 1³
    (N = 512, 64, 8: partial tiles), fp32·erf and bf16·poly; timings at
    8×4³ (3D mip mode's LOD 3)."""
    import torch

    from nic_torch.kernels import train_fused as k

    names = ("loss", "out", "dx", "dw1", "db1", "dw2", "db2", "dw3", "db3")
    gen = torch.Generator(device="cpu").manual_seed(61)
    timings = {}
    with torch.no_grad():
        for n in (4, 2, 1):
            fp, weights, tgt, origins, _ = _inputs3(gen, device, n, 1, False)
            x = _gather3(fp, origins, n, 1, False, device)
            if x.shape[1] != 127:
                fail(f"the 3D gather has {x.shape[1]} features, not 127")
            for label, (cd, gelu) in K11_MODES.items():
                kw = dict(gelu=gelu,
                          cd=None if cd == "fp32" else torch.bfloat16)
                cell = f"8×{n}³ F=127 {label}"
                got = _run_twice(f"K6 {cell}", lambda: (
                    k.fused_mlp_loss_kernel(x, tgt, *weights, **kw)))
                want = k.fused_mlp_loss_plain(x, tgt, *weights, **kw)
                errs = _compare(f"K6 vs plain {cell}", names, got, want,
                                K11_TOL[cd])
                print(f"phase 18: K6 vs plain {cell}: loss rel "
                      f"{errs['loss']:.2e}, out max|Δ| {errs['out']:.2e}, dx "
                      f"rel {errs['dx']:.2e}, MLP grads rel ≤ "
                      f"{max(errs[m] for m in names[3:]):.2e}", flush=True)
                if n == 4:
                    ms = cuda_ms(lambda: k.fused_mlp_loss_kernel(
                        x, tgt, *weights, **kw))
                    plain = cuda_ms(lambda: k.fused_mlp_loss_plain(
                        x, tgt, *weights, **kw))
                    work = _fused_work(x, tgt, weights, got)
                    timings[label] = (ms, plain, work, errs["out"])
                    b_ms, b_by = bound(*work, cd)
                    print(f"phase 18: K6 {cell}: kernel {ms:.4f} ms vs plain "
                          f"{plain:.4f} ms; bound {b_ms:.4f} ms ({b_by})",
                          flush=True)
    return timings


def _check_decodes3(tag, run, no_mip: bool) -> int:
    """Every mip of the 64³ volume decoded at its size; K5 launched once
    per mip it covers. Returns that count."""
    import numpy as np

    from nic_torch.grids.pyramid import pyramid_mip_levels
    from nic_torch.kernels.decode_fused_3d import kernel_covers_3d

    m2l = pyramid_mip_levels(64, 16, no_mip)
    covered = sum(kernel_covers_3d(mip, 64, m2l, 64) for mip in range(7))
    for mip, rec in enumerate(run["recs"]):
        if rec.shape != (64 >> mip,) * 3 + (3,) or \
                not np.isfinite(rec).all():
            fail(f"{tag}: decode at mip {mip}: shape {rec.shape} or "
                 "non-finite")
    if run["k5"] != covered:
        fail(f"{tag}: the decode CLI launched K5 {run['k5']} times over "
             f"mips 0-6; the kernel covers {covered}")
    return covered


def _run3(tag, args, engine, kernel):
    """A 200-epoch 3D CLI run whose gates must name ``engine`` at LOD 0 in
    both phases and whose ``kernel`` launches on every step; checks the
    losses and the decodes."""
    import numpy as np

    run = _cli_train(args, mips=range(7))
    want = {k: 0 for k in run["launches"]}
    want[kernel] = 200
    if run["engine"] != {(0, False): engine, (0, True): engine}:
        fail(f"{tag}: gates {run['gates']}, want {engine} in both phases")
    if run["launches"] != want:
        fail(f"{tag}: launches {run['launches']}, want {kernel} 200")
    if len(run["losses"]) != 200 or not np.isfinite(run["losses"]).all():
        fail(f"{tag}: the losses are not 200 finite values")
    _check_decodes3(tag, run, no_mip=True)
    return run


def phase_train3(device) -> dict:
    """The 3D CLI runs: m3 and m4 flag-free (K12 on every step), m3 mip mode
    (K12 and K6 by LOD), m3 TRAIN_FORWARD=kernel2 (K9 on every step), the
    last three beside gather runs; then kernel3 and kernel2 tracking gather
    from one seed. Returns the launches of K12 (m3) and K9."""
    import numpy as np

    ref = dict(np.load(REF3))
    jax_psnr = float(ref["run_psnr"][0])
    out = {}
    m3 = _run3("phase 19: m3", MISTY, "kernel3", "K12")
    p3 = m3["res"]["psnr"][0]
    print(f"phase 19: 3D m3 flag-free, 200 epochs in {m3['wall']:.1f} s of "
          f"wall time; gates {sorted(m3['engine'].items())}; launches "
          f"{m3['launches']}; loss {m3['losses'][0]:.5f} → "
          f"{m3['losses'][-1]:.5f}; mip-0 PSNR {p3:.4f} dB (fixture's JAX "
          f"run {jax_psnr:.4f}), average PSNR {m3['res']['average_psnr']:.4f}"
          f", bpp {m3['res']['bpp']:.4f}; K5 launches {m3['k5']}",
          flush=True)
    if abs(p3 - jax_psnr) > TRAIN_PSNR_DB:
        fail(f"3D m3: mip-0 PSNR {p3:.4f} dB is not within {TRAIN_PSNR_DB} "
             f"dB of the JAX run's {jax_psnr:.4f}")
    out["K12"] = m3["launches"]["K12"]

    gather = {}
    for tag, args in (("m4", MISTY + ["COMPRESSION_METHOD=4"]),
                      ("m3 mip mode", MISTY + ["TF_NO_MIP=0"]),
                      ("m3", MISTY)):
        g = _cli_train(args + ["TRAIN_FORWARD=gather"], decode=False)
        gather[tag] = g["res"]["psnr"][0]
        print(f"phase 19: 3D {tag} TRAIN_FORWARD=gather, 200 epochs in "
              f"{g['wall']:.1f} s: mip-0 PSNR {gather[tag]:.4f} dB", flush=True)

    def beside(tag, run, ref_tag):
        p = run["res"]["psnr"][0]
        if abs(p - gather[ref_tag]) > TRAIN_PSNR_DB:
            fail(f"3D {tag}: mip-0 PSNR {p:.4f} dB is not within "
                 f"{TRAIN_PSNR_DB} dB of the gather run's "
                 f"{gather[ref_tag]:.4f}")

    m4 = _run3("phase 19: m4", MISTY + ["COMPRESSION_METHOD=4"], "kernel3",
               "K12")
    print(f"phase 19: 3D m4 flag-free, 200 epochs in {m4['wall']:.1f} s; "
          f"launches {m4['launches']}; mip-0 PSNR "
          f"{m4['res']['psnr'][0]:.4f} dB vs gather {gather['m4']:.4f}, bpp "
          f"{m4['res']['bpp']:.4f}; K5 launches {m4['k5']}", flush=True)
    beside("m4", m4, "m4")

    args = MISTY + ["TF_NO_MIP=0"]
    mm = _cli_train(args, mips=range(7))
    lods = _lod_sequence(args)
    want = {lod: "kernel3" if lod in KERNEL3_LODS_3D else "kernel"
            for lod in set(lods)}
    want_k12 = sum(want[lod] == "kernel3" for lod in lods)
    got = mm["launches"]
    drawn = {int(v): int(c) for v, c in zip(*np.unique(lods,
                                                      return_counts=True))}
    print(f"phase 19: 3D m3 mip mode (TF_NO_MIP=0), 200 epochs in "
          f"{mm['wall']:.1f} s; LODs drawn {drawn}; gates "
          f"{sorted(mm['engine'].items())}; launches {got} (want K12 "
          f"{want_k12}, K6 {200 - want_k12}); mip-0 PSNR "
          f"{mm['res']['psnr'][0]:.4f} dB vs gather "
          f"{gather['m3 mip mode']:.4f}; K5 launches {mm['k5']}", flush=True)
    for (lod, _), engine in mm["engine"].items():
        if engine != want[lod]:
            fail(f"3D mip mode: LOD {lod} ran {engine}, JAX runs {want[lod]}")
    if got != {**{k: 0 for k in got}, "K12": want_k12,
               "K6": 200 - want_k12}:
        fail(f"3D mip mode: launches {got}, want K12 {want_k12}, K6 "
             f"{200 - want_k12}")
    if not np.isfinite(mm["losses"]).all():
        fail("3D mip mode: non-finite losses")
    if _check_decodes3("3D mip mode", mm, no_mip=False) != 4:
        fail("3D mip mode: K5 should cover mips 0, 1, 2 and 4")
    beside("m3 mip mode", mm, "m3 mip mode")

    k2 = _run3("phase 19: kernel2", MISTY + ["TRAIN_FORWARD=kernel2"],
               "kernel2", "K9")
    print(f"phase 19: 3D m3 TRAIN_FORWARD=kernel2, 200 epochs in "
          f"{k2['wall']:.1f} s; launches {k2['launches']}; mip-0 PSNR "
          f"{k2['res']['psnr'][0]:.4f} dB vs gather {gather['m3']:.4f}",
          flush=True)
    beside("kernel2", k2, "m3")
    out["K9"] = k2["launches"]["K9"]

    _track("phase 19: 3D m3", MISTY + ["QAT_NOISE_WHERE=node"], "kernel3")
    _track("phase 19: 3D m3", MISTY, "kernel2")
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an "
             "NVIDIA GPU")
    try:
        import nic_torch  # noqa: F401
    except ImportError as e:
        fail(f"nic_torch is not importable next to chip_smoke.py: {e}")
    # state the float32 precision: full fp32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    print(f"phase 1: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    t0 = time.perf_counter()
    phase_build()
    main_err = phase_parity("cuda")
    k1_launches = phase_serve("cuda")
    timings = phase_scale("cuda")
    k11 = phase_k11("cuda")
    k7 = phase_k7("cuda")
    k6 = phase_k6("cuda")
    k11_launches = phase_train("cuda")
    k6_launches = phase_path_a("cuda")
    k7_launches = phase_path_b("cuda")
    steps = phase_step_time("cuda")
    k5_err = phase_k5("cuda")
    k5_launches = phase_serve3("cuda")
    k5_ms, k5_plain, k5_work = phase_scale3("cuda")
    k12 = phase_k12("cuda")
    k9 = phase_k9("cuda")
    phase_k6_3d("cuda")
    launches3 = phase_train3("cuda")
    steps3 = phase_step_time3("cuda")
    k11_ms, k11_plain, k11_work = k11["timings"]["f=4 bf16·poly noise=on"]
    print(f"K11 share of the kernel3 step: {k11_ms / steps['kernel3']:.3f} "
          f"({k11_ms:.4f} of {steps['kernel3']:.4f} ms); K7 share of the "
          f"kernel2 step: {k7['bf16·poly'][0] / steps['kernel2']:.3f}; K6 "
          f"share of the kernel step: "
          f"{k6[(256, 'bf16·poly')][0] / steps['kernel']:.3f}", flush=True)
    k12_cell = "8×32³ f=4 m3 bf16·poly noise=on"
    print(f"K12 share of the 3D kernel3 step: "
          f"{k12[k12_cell][0] / steps3['kernel3']:.3f}; K9 share of the 3D "
          f"kernel2 step: {k9['bf16·poly'][0] / steps3['kernel2']:.3f}",
          flush=True)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def entry(name, source, replaces, launches, err, ms, plain, work, dtype):
        b_ms, b_by = bound(*work, dtype)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    # each at its path's shape and mode: K1 2048² fp32·exact; K11 8×256²
    # bf16·poly with noise; K6 8×32² (path A's largest launch) and K7
    # 8×256² (path B), bf16·poly; K5 256³ fp32·exact (its max|Δ| the worst
    # fp32·exact of phase 13); K12 8×32³ bf16·poly with noise and K9 8×32³
    # bf16·poly (the 3D protocol's LOD 0)
    print(json.dumps({"kernels": [
        entry("decode_fused_v2", KERNEL_SOURCE, REPLACES, k1_launches,
              main_err, *timings[2048][("fp32", "exact")], "fp32"),
        entry("train_fused_ff", K11_SOURCE, K11_REPLACES, k11_launches,
              k11["out_err"], k11_ms, k11_plain, k11_work, "bf16"),
        entry("train_fused_dx", K67_SOURCE, K6_REPLACES, k6_launches,
              k6[(32, "bf16·poly")][3], *k6[(32, "bf16·poly")][:3], "bf16"),
        entry("train_fused_ng", K67_SOURCE, K7_REPLACES, k7_launches,
              k7["bf16·poly"][3], *k7["bf16·poly"][:3], "bf16"),
        entry("decode_fused_3d", K5_SOURCE, K5_REPLACES, k5_launches,
              k5_err, k5_ms, k5_plain, k5_work, "fp32"),
        entry("train_fused_ff3", K12_SOURCE, K12_REPLACES, launches3["K12"],
              k12[k12_cell][3], *k12[k12_cell][:3], "bf16"),
        entry("train_fused_ng3", K67_SOURCE, K9_REPLACES, launches3["K9"],
              k9["bf16·poly"][3], *k9["bf16·poly"][:3], "bf16")]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
