"""The port's PSNR spread over seeds at the conv-AE fixtures' settings: each
workload's CLI (``nic_torch.cli.<workload>``) runs the fixture's flags
and epochs from the port's own initial weights for each seed, on the
device given, and prints the PSNR of each run beside the fixture's JAX
run (``tests/fixtures/convae_<workload>.npz``), then per workload the
mean, the standard deviation (ddof 1), the spread (max − min), the
largest distance from JAX's and the band: |mean − JAX| + 3·std, rounded
up to 0.05 dB, the distance from the JAX run that a further run of the
port (the card's, in ``chip_smoke.py`` phase 30) may take (PERF.md §2).

``--package nic`` runs the JAX CLIs (``nic.cli.<workload>``, on the CPU
with ``JAX_PLATFORMS=cpu``) instead, for the JAX package's own spread.

Run:
  python scripts/torch_convae_seed_band.py [--device cpu] [--seeds 0,1,2]
      [--package nic_torch|nic] [WORKLOAD ...]
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WORKLOADS = ("image_comp", "pixel_comp", "movie_3d_comp")


def fixture_meta(workload: str) -> dict:
    path = os.path.join(ROOT, "tests", "fixtures", f"convae_{workload}.npz")
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def run_seed(workload: str, seed: int, device: str,
             package: str = "nic_torch") -> tuple:
    """(PSNR, seconds) of one CLI run at the fixture's flags."""
    meta = fixture_meta(workload)
    argv = [a for a in meta["argv"]]
    i = argv.index("--seed")
    argv[i + 1] = str(seed)
    if package == "nic_torch":
        argv += ["--device", device]
    mod = importlib.import_module(f"{package}.cli.{workload}")
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            p = float(mod.run(argv + ["--output_root", tmp]))
            return p, time.perf_counter() - t0
    finally:
        os.chdir(cwd)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--package", default="nic_torch",
                    choices=("nic_torch", "nic"))
    ap.add_argument("workloads", nargs="*", default=list(WORKLOADS))
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = {}
    for w in args.workloads:
        jax_psnr = fixture_meta(w)["psnr"]
        ps = []
        for s in seeds:
            p, sec = run_seed(w, s, args.device, args.package)
            ps.append(p)
            where = "JAX, cpu" if args.package == "nic" else args.device
            print(f"{w} seed {s} ({where}): {p:.4f} dB "
                  f"({sec:.1f} s); JAX fixture {jax_psnr:.4f} dB",
                  flush=True)
        ps = np.asarray(ps)
        std = float(ps.std(ddof=1)) if len(ps) > 1 else float("nan")
        band = float(np.ceil((abs(ps.mean() - jax_psnr) + 3 * std) / 0.05)
                     * 0.05)
        out[w] = dict(psnr=ps.tolist(), jax=jax_psnr,
                      mean=float(ps.mean()), std=std,
                      spread=float(ps.max() - ps.min()),
                      max_dist=float(np.abs(ps - jax_psnr).max()),
                      band=band)
        print(f"{w}: mean {ps.mean():.4f} dB, std {std:.4f} dB, spread "
              f"{ps.max() - ps.min():.4f} dB, largest distance from JAX "
              f"{out[w]['max_dist']:.4f} dB; band {band:.2f} dB", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
