#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``nic_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. a CUDA device is present; print ``nvidia-smi`` name and power limit;
2. build every CUDA kernel from ``nic_torch/kernels/csrc`` (the decode
   kernel K1 and the kernel3 train step K11; one nvcc per source, all
   started together) for sm_90a, and print the build time;
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
7. train: the training CLI (``nic_torch.cli.image_compression.run``) at
   the flagship configuration for 200 epochs (the overrides that made the
   committed fixture). The gate log must name kernel3 in both phases, K11
   must launch exactly 200 times, every loss be finite and the last 20
   lower than the first 20 on average, mip-0 PSNR within 1.0 dB of the
   fixture's JAX run; then the decode CLI decodes the artifact at mips
   0-9 with exactly 3 K1 launches;
8. train-step time (CUDA events, median over steps 50-199) for
   TRAIN_FORWARD=kernel3 and for gather (plain autograd) on the same
   configuration.

The last line of standard output is one JSON object
``{"ok": true, "device": {...}}``; the line before it the card's name and
power limit, and before that the ``{"kernels": [...]}`` record.
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
            for gelu in (k.GELUS if mode == "fp32" else ("exact",)):
                g = dict(f=geom["f"], f1=geom["f1"], gelu=gelu)
                ms = cuda_ms(lambda: k.decode_kernel_2d(*args, **g))
                plain = cuda_ms(lambda: k.decode_kernel_2d_plain(*args, **g))
                out[(mode, gelu)] = (ms, plain)
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


def phase_k11(device) -> dict:
    """K11 vs plain at f = 4, 2, 1 in 4 modes; timings at the flagship."""
    import torch

    from nic_torch.kernels import train_fused_ff as k

    names = ("loss", "out", "dw2", "db2", "dw3", "db3", "dpe0", "dpe1",
             "db1", "P_acc", "C1_acc", "dw1e")
    gen = torch.Generator(device="cpu").manual_seed(11)
    worst = {}
    timings = {}
    out_err = 0.0
    with torch.no_grad():  # the plain version takes autograd inside
        for n, f in ((256, 4), (128, 2), (64, 1)):
            planes, weights, tgt, origins, seed = _k11_inputs(gen, device,
                                                              n, f)
            for label, (cd, gelu) in K11_MODES.items():
                tol = K11_TOL[cd]
                for nbits in (None, 8):
                    args = (*planes[cd], *weights, tgt, origins, seed)
                    kw = dict(n=n, f=f, npe=6, lodf=0.0, gelu=gelu,
                              cd=None if cd == "fp32" else torch.bfloat16,
                              nbits=nbits)
                    got = k.fused_train_ff_kernel(*args, **kw)
                    again = k.fused_train_ff_kernel(*args, **kw)
                    torch.cuda.synchronize(device)
                    if not all(torch.equal(a, b) for a, b in zip(got, again)
                               if a is not None):
                        fail(f"K11 f={f} {label}: two runs differ (the "
                             "reductions must be in a fixed order)")
                    want = k.fused_train_ff_plain(*args, **kw)
                    cell = f"f={f} {label} noise={'on' if nbits else 'off'}"
                    errs = {}
                    for name, a, b in zip(names, got, want):
                        if b is None:
                            continue
                        if a.shape != b.shape or not torch.isfinite(a).all():
                            fail(f"K11 {cell}: {name} shape "
                                 f"{tuple(a.shape)} (want {tuple(b.shape)})"
                                 " or non-finite values")
                        errs[name] = (float((a - b).abs().max())
                                      if name == "out" else _rel(a, b))
                    bad = [nm for nm, e in errs.items()
                           if e > tol["loss" if nm == "loss" else
                                      "out" if nm == "out" else "grad"]]
                    worst_grad = max(e for nm, e in errs.items()
                                     if nm not in ("loss", "out"))
                    print(f"phase 6: K11 vs plain {cell}: loss rel "
                          f"{errs['loss']:.2e}, out max|Δ| {errs['out']:.2e},"
                          f" worst grad/plane rel {worst_grad:.2e} "
                          f"(tol {tol['loss']:.0e}/{tol['out']:.0e}/"
                          f"{tol['grad']:.0e})", flush=True)
                    if bad:
                        fail(f"K11 vs plain {cell}: "
                             + ", ".join(f"{nm} {errs[nm]:.3e}" for nm in bad))
                    worst[cell] = errs
                    if n == 256 and cd == "bf16" and nbits:
                        out_err = errs["out"]
                    if n == 256 and ((cd, nbits) in (("bf16", 8),
                                                     ("fp32", None))):
                        ms = cuda_ms(lambda: k.fused_train_ff_kernel(*args,
                                                                     **kw))
                        plain = cuda_ms(lambda: k.fused_train_ff_plain(
                            *args, **kw))
                        timings[cell] = (ms, plain)
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
    import glob

    import numpy as np

    from nic_torch.cli import decode as dcli
    from nic_torch.cli import image_compression as tcli
    from nic_torch.kernels.decode_fused_v2 import decode_kernel_2d
    from nic_torch.kernels.train_fused_ff import fused_train_ff_kernel

    ref = dict(np.load(REF))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        fused_train_ff_kernel.launches = 0
        t0 = time.perf_counter()
        res = tcli.run(TRAIN_ARGS + [f"OUTPUT_ROOT={tmp}"])
        wall = time.perf_counter() - t0
        launches = fused_train_ff_kernel.launches
        losses = _csv_losses(tmp)
        (printlog,) = glob.glob(os.path.join(tmp, "printlog", "*.txt"))
        with open(printlog) as fh:
            gates = [ln.strip() for ln in fh if "train forward gate" in ln]
        decode_kernel_2d.launches = 0
        recs = [dcli.run([res["artifact"], "--mip", str(mip)])
                for mip in range(10)]
        k1 = decode_kernel_2d.launches
    print(f"phase 7: training CLI, 200 epochs in {wall:.1f} s of wall time; "
          f"gates: {gates}; K11 launches {launches}; loss first "
          f"{losses[0]:.5f} last {losses[-1]:.5f}; mip-0 PSNR "
          f"{res['psnr'][0]:.4f} dB (fixture's JAX run "
          f"{float(ref['psnr'][0]):.4f}), bpp {res['bpp']:.4f}; decode CLI "
          f"mips 0-9 shapes {[r.shape[0] for r in recs]}, K1 launches {k1}",
          flush=True)
    for frozen in (False, True):
        if not any(f"frozen={frozen}): kernel3" in g for g in gates):
            fail(f"the gate log does not name kernel3 for frozen={frozen}: "
                 f"{gates}")
    if launches != 200:
        fail(f"K11 launched {launches} times in 200 epochs")
    if len(losses) != 200 or not np.isfinite(losses).all():
        fail(f"{len(losses)} losses, finite: {np.isfinite(losses).all()}")
    if not np.mean(losses[-20:]) < np.mean(losses[:20]):
        fail("the loss did not fall: mean of the last 20 "
             f"{np.mean(losses[-20:]):.5f} vs first 20 "
             f"{np.mean(losses[:20]):.5f}")
    if abs(res["psnr"][0] - float(ref["psnr"][0])) > TRAIN_PSNR_DB:
        fail(f"mip-0 PSNR {res['psnr'][0]:.4f} dB is not within "
             f"{TRAIN_PSNR_DB} dB of {float(ref['psnr'][0]):.4f}")
    for mip, rec in enumerate(recs):
        if rec.shape != (512 >> mip, 512 >> mip, 3) or \
                not np.isfinite(rec).all():
            fail(f"decode of the trained artifact at mip {mip}: shape "
                 f"{rec.shape} or non-finite")
    if k1 != 3:
        fail(f"the decode CLI launched K1 {k1} times over mips 0-9; "
             "expected 3")
    return launches


def phase_step_time(device) -> dict:
    """Median train-step ms (CUDA events, steps 50-199) per forward."""
    import torch

    from nic_torch.cli.image_compression import load_asset
    from nic_torch.config import parse_overrides
    from nic_torch.train.ntc import NTCTrainer

    out = {}
    for forward in ("kernel3", "gather"):
        cfg = parse_overrides(TRAIN_ARGS + [f"TRAIN_FORWARD={forward}"])
        tr = NTCTrainer(cfg, load_asset(cfg))
        events = []
        for i in range(200):
            if i == 50:
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tr.train_step()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) / 150 * 1e3
        if tr._forward_mode != forward:
            fail(f"TRAIN_FORWARD={forward} ran {tr._forward_mode}")
        ms = statistics.median(s.elapsed_time(e) for s, e in events[50:])
        out[forward] = ms
        print(f"phase 8: train step TRAIN_FORWARD={forward}: median "
              f"{ms:.4f} ms by CUDA events over steps 50-199 "
              f"({1e3 / ms:.1f} steps/s); host clock {wall:.4f} ms/step "
              f"({1e3 / wall:.1f} steps/s)", flush=True)
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
    launches = phase_serve("cuda")
    timings = phase_scale("cuda")
    ms, plain_ms = timings[2048][("fp32", "exact")]
    k11 = phase_k11("cuda")
    k11_launches = phase_train("cuda")
    steps = phase_step_time("cuda")
    k11_ms, k11_plain = k11["timings"]["f=4 bf16·poly noise=on"]
    print(f"K11 share of the kernel3 step: {k11_ms / steps['kernel3']:.3f} "
          f"({k11_ms:.4f} of {steps['kernel3']:.4f} ms)", flush=True)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [{
        "name": "decode_fused_v2", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": main_err,
        "ms": ms, "plain_ms": plain_ms}, {
        "name": "train_fused_ff", "route": "cuda", "source": K11_SOURCE,
        "replaces": K11_REPLACES, "launches": k11_launches,
        "max_abs_err": k11["out_err"], "ms": k11_ms,
        "plain_ms": k11_plain}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
