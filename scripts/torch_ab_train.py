#!/usr/bin/env python3
"""Time kernel3 (K11) and the train step of one checkout of the port, for
A/B comparisons of two checkouts on one card.

    python3 scripts/torch_ab_train.py ROOT

imports ``nic_torch`` from the checkout at ROOT (which builds its own
kernels under ROOT/build) and times it with the helpers of the
``chip_smoke.py`` beside this script, so that both checkouts are measured
by the same code. On a machine with one NVIDIA GPU it prints:

- K11 (``fused_train_ff_kernel``) at the flagship shape (8 crops of 256²,
  f=4, C=12, H=64, PE 6, random pyramid and MLP from torch.Generator seed
  11) in bf16·poly with noise and fp32·erf without: median of 50
  CUDA-event timings;
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
from nic_torch.kernels import train_fused_ff  # noqa: E402


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
        ms = chip_smoke.cuda_ms(
            lambda: train_fused_ff.fused_train_ff_kernel(*args, **kw),
            reps=50)
        print(f"AB {sys.argv[1]}: K11 8×256² {cd}·{gelu} noise={nbits}: "
              f"{ms:.4f} ms", flush=True)
    for engine in ("kernel3", "gather"):
        _, line = chip_smoke.step_timing(engine, chip_smoke.TRAIN_ARGS,
                                         "cuda")
        print(f"AB {sys.argv[1]}: {line}", flush=True)


if __name__ == "__main__":
    main()
