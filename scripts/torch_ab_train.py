#!/usr/bin/env python3
"""Time the train kernels (K11, K7, K6; K12, K9) and the train steps of
one checkout of the port, for A/B comparisons of two checkouts on one
card.

    python3 scripts/torch_ab_train.py ROOT [PARTS]

imports ``nic_torch`` from the checkout at ROOT (which builds its own
kernels under ROOT/build) and times it with the helpers of the
``chip_smoke.py`` beside this script, so that both checkouts are measured
by the same code. On a machine with one NVIDIA GPU it prints:

- K11 (``fused_train_ff_kernel``) at the flagship shape (8 crops of 256²,
  f=4, C=12, H=64, PE 6, random pyramid and MLP from torch.Generator seed
  11) in bf16·poly with noise and fp32·erf without; K7
  (``fused_mlp_loss_ng_kernel``) at 8×256² on the sinusoidal gather and
  K6 (``fused_mlp_loss_kernel``) at 8×32² (step 2) and 8×256², bf16·poly
  and fp32·erf (seeds 7 and 6); K12 (``fused_train_ff3_kernel``) at 8
  crops of 32³ (f=4, method 3, seed 12) in bf16·poly with noise and K9
  (``fused_mlp_loss_ng3_kernel``) on the 3D gather of 8×32³ (seed 9) in
  bf16·poly, the misty protocol's LOD 0: each the median of 50 CUDA-event
  timings of the wrapper and, by ``torch.profiler``, the device time per
  call of all the kernels it launches and of each by name, longest first
  (so host time and device time separate, and the per-pixel body, e.g.
  ``mlp_pixel`` or ``mlp_pixel_mma``, and the back half, ``node_windows``,
  ``ff_rowcol``, ``ff_pe``, ``ff_epsgrad``, show on their own);
- the train step (``chip_smoke.step_timing``) of TRAIN_FORWARD=kernel3
  and gather at the flagship configuration, kernel2 on path B
  (TF_USE_TRI_PE=0), and kernel3 and kernel2 on the 3D misty m3 protocol.

PARTS (comma-separated, default all of them) picks what is timed: k11,
k7, k6, k12, k9, steps.

Compare two checkouts only inside one call, in turns (parent, change,
change, parent): step times differ by up to 2x between machines.
"""

import importlib.util
import os
import sys

import torch

ROOT = os.path.abspath(sys.argv[1])
PARTS = set((sys.argv[2] if len(sys.argv) > 2
             else "k11,k7,k6,k12,k9,steps").split(","))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               os.pardir, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
sys.path.insert(0, ROOT)    # ahead of the directory chip_smoke adds

import nic_torch  # noqa: E402
from nic_torch.kernels import (train_fused, train_fused_ff,  # noqa: E402
                               train_fused_ff3)


def short(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = name.removeprefix("void ").removeprefix("(anonymous namespace)::")
    return name.split("(")[0][:40]


def report(tag: str, fn) -> None:
    ms = chip_smoke.cuda_ms(fn, reps=50)
    total, per = chip_smoke.device_ms(fn)
    top = sorted(per.items(), key=lambda kv: -kv[1])
    print(f"AB {sys.argv[1]}: {tag}: {ms:.4f} ms (device {total:.4f} ms: "
          + "; ".join(f"{short(name)} {t:.4f}" for name, t in top) + ")",
          flush=True)


def time_k11() -> None:
    inputs = chip_smoke._k11_inputs(torch.Generator().manual_seed(11),
                                    "cuda", 256, 4)
    for cd, gelu, nbits in (("bf16", "poly", 8), ("fp32", "erf", None)):
        args, kw = chip_smoke._k11_call(inputs, 256, 4, cd, gelu, nbits)
        report(f"K11 8×256² {cd}·{gelu} noise={nbits}",
               lambda: train_fused_ff.fused_train_ff_kernel(*args, **kw))


def time_k7() -> None:
    fp, weights, x, tgt, origins = chip_smoke._gather_inputs(
        torch.Generator().manual_seed(7), "cuda", 256, 0.25, False)
    geo = dict(g0_nodes=tuple(fp[0].shape[1:]),
               g1_nodes=tuple(fp[1].shape[1:]))
    for label, (cd, gelu) in chip_smoke.K11_MODES.items():
        kw = dict(n=256, f=4, gelu=gelu,
                  cd=None if cd == "fp32" else torch.bfloat16, **geo)
        report(f"K7 8×256² {label}",
               lambda: train_fused.fused_mlp_loss_ng_kernel(
                   x, tgt, origins, *weights, **kw))


def time_k6() -> None:
    gen = torch.Generator().manual_seed(6)
    for n, step in ((32, 2.0), (256, 0.25)):
        _, weights, x, tgt, _ = chip_smoke._gather_inputs(
            gen, "cuda", n, step, True)
        for label, (cd, gelu) in chip_smoke.K11_MODES.items():
            kw = dict(gelu=gelu, cd=None if cd == "fp32" else torch.bfloat16)
            report(f"K6 8×{n}² {label}",
                   lambda: train_fused.fused_mlp_loss_kernel(
                       x, tgt, *weights, **kw))


def time_k12() -> None:
    fp, weights, tgt, origins, seed = chip_smoke._inputs3(
        torch.Generator().manual_seed(12), "cuda", 32, 4, False)
    vols = train_fused_ff3.fold_volumes(fp[0], fp[1], weights[0], False,
                                        torch.bfloat16)
    kw = dict(n=32, f=4, npe=6, lodf=0.0, sparse_g0=False, use_tri_pe=True,
              cd=torch.bfloat16, gelu="poly", nbits=8)
    report("K12 8×32³ m3 bf16·poly noise=8",
           lambda: train_fused_ff3.fused_train_ff3_kernel(
               *vols, *weights, tgt, origins, seed, **kw))


def time_k9() -> None:
    fp, weights, tgt, origins, _ = chip_smoke._inputs3(
        torch.Generator().manual_seed(9), "cuda", 32, 4, False)
    x = chip_smoke._gather3(fp, origins, 32, 4, False, "cuda")
    kw = dict(n=32, f=4, gelu="poly", cd=torch.bfloat16,
              g0_nodes=tuple(fp[0].shape[1:]),
              g1_nodes=tuple(fp[1].shape[1:]))
    report("K9 8×32³ m3 bf16·poly",
           lambda: train_fused.fused_mlp_loss_ng3_kernel(
               x, tgt, origins, *weights, **kw))


def time_steps() -> None:
    for engine, args, label in (
            ("kernel3", chip_smoke.TRAIN_ARGS, None),
            ("gather", chip_smoke.TRAIN_ARGS, None),
            ("kernel2", chip_smoke.PATH_B, None),
            ("kernel3", chip_smoke.MISTY, "3D m3 8×32³"),
            ("kernel2", chip_smoke.MISTY, "3D m3 8×32³")):
        _, line = chip_smoke.step_timing(engine, args, "cuda", label)
        print(f"AB {sys.argv[1]}: {line}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    if not nic_torch.__file__.startswith(ROOT):
        sys.exit(f"nic_torch came from {nic_torch.__file__}, not {ROOT}")
    print(f"AB {sys.argv[1]}: {chip_smoke.smi_line()}", flush=True)
    parts = {"k11": time_k11, "k7": time_k7, "k6": time_k6, "k12": time_k12,
             "k9": time_k9, "steps": time_steps}
    if PARTS - set(parts):
        sys.exit(f"unknown parts {sorted(PARTS - set(parts))}")
    for name, fn in parts.items():
        if name == "steps" and name in PARTS:
            fn()  # the trainer's steps take autograd
        elif name in PARTS:
            with torch.no_grad():
                fn()


if __name__ == "__main__":
    main()
