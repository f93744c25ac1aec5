#!/usr/bin/env python3
"""Time the 2D train kernels (K11, K7, K6) and the train step of one
checkout of the port, for A/B comparisons of two checkouts on one card.

    python3 scripts/torch_ab_train.py ROOT

imports ``nic_torch`` from the checkout at ROOT (which builds its own
kernels under ROOT/build) and times it with the helpers of the
``chip_smoke.py`` beside this script, so that both checkouts are measured
by the same code. On a machine with one NVIDIA GPU it prints:

- K11 (``fused_train_ff_kernel``) at the flagship shape (8 crops of 256²,
  f=4, C=12, H=64, PE 6, random pyramid and MLP from torch.Generator seed
  11) in bf16·poly with noise and fp32·erf without; K7
  (``fused_mlp_loss_ng_kernel``) at 8×256² on the sinusoidal gather and
  K6 (``fused_mlp_loss_kernel``) at 8×32² (step 2) and 8×256², bf16·poly
  and fp32·erf (seeds 7 and 6): each the median of 50 CUDA-event timings
  of the wrapper and, by ``torch.profiler``, the device time per call of
  all the kernels it launches and of the four longest by name (so host
  time and device time separate, and ``ff_pixel`` shows on its own);
- the train step of TRAIN_FORWARD=kernel3 and gather at the flagship
  configuration: ``chip_smoke.step_timing``.

Compare two checkouts only inside one call, in turns (parent, change,
change, parent): step times differ by up to 2x between machines.
"""

import importlib.util
import os
import sys

import torch

ROOT = os.path.abspath(sys.argv[1])
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               os.pardir, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
sys.path.insert(0, ROOT)    # ahead of the directory chip_smoke adds

import nic_torch  # noqa: E402
from nic_torch.kernels import train_fused, train_fused_ff  # noqa: E402


def device_ms(fn, reps: int = 20) -> tuple:
    """Device time per call of ``fn`` by torch.profiler over ``reps``
    calls, after a warm-up: (the sum over its CUDA kernels, {kernel name:
    ms per call})."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {a.key: a.self_device_time_total / reps / 1e3
           for a in prof.key_averages()
           if a.device_type == torch.autograd.DeviceType.CUDA}
    return sum(per.values()), per


def report(tag: str, fn) -> None:
    ms = chip_smoke.cuda_ms(fn, reps=50)
    total, per = device_ms(fn)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:4]
    print(f"AB {sys.argv[1]}: {tag}: {ms:.4f} ms (device {total:.4f} ms: "
          + "; ".join(f"{name[:40]} {t:.4f}" for name, t in top) + ")",
          flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    if not nic_torch.__file__.startswith(ROOT):
        sys.exit(f"nic_torch came from {nic_torch.__file__}, not {ROOT}")
    print(f"AB {sys.argv[1]}: {chip_smoke.smi_line()}", flush=True)
    inputs = chip_smoke._k11_inputs(torch.Generator().manual_seed(11),
                                    "cuda", 256, 4)
    for cd, gelu, nbits in (("bf16", "poly", 8), ("fp32", "erf", None)):
        args, kw = chip_smoke._k11_call(inputs, 256, 4, cd, gelu, nbits)
        report(f"K11 8×256² {cd}·{gelu} noise={nbits}",
               lambda: train_fused_ff.fused_train_ff_kernel(*args, **kw))
    with torch.no_grad():
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
        gen = torch.Generator().manual_seed(6)
        for n, step in ((32, 2.0), (256, 0.25)):
            _, weights, x, tgt, _ = chip_smoke._gather_inputs(
                gen, "cuda", n, step, True)
            for label, (cd, gelu) in chip_smoke.K11_MODES.items():
                kw = dict(gelu=gelu,
                          cd=None if cd == "fp32" else torch.bfloat16)
                report(f"K6 8×{n}² {label}",
                       lambda: train_fused.fused_mlp_loss_kernel(
                           x, tgt, *weights, **kw))
    for engine in ("kernel3", "gather"):
        _, line = chip_smoke.step_timing(engine, chip_smoke.TRAIN_ARGS,
                                         "cuda")
        print(f"AB {sys.argv[1]}: {line}", flush=True)


if __name__ == "__main__":
    main()
