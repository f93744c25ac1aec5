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

``--init jax`` starts each of the port's runs from the JAX trainer's
initial params at that seed (``nic.train.conv_ae.ConvAETrainer``, written
as a step-0 checkpoint and passed as ``--resume``; a fresh Adam; for
movie_3d_comp only), while the noise stays the port's own (``qat_noise``
from the trainer's generator): it tells a gap in the initial draw from
one in the noise.

Run:
  python scripts/torch_convae_seed_band.py [--device cpu] [--seeds 0,1,2]
      [--package nic_torch|nic] [--init port|jax] [WORKLOAD ...]
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


def jax_init_checkpoint(argv: list, path: str) -> None:
    """A step-0 checkpoint of the JAX trainer's initial params for
    movie_3d_comp's CLI flags ``argv`` (the clip, widths, bits, seed)."""
    from nic.io.artifacts import _flatten_tree
    from nic.train.conv_ae import ConvAETrainer
    from nic_torch.cli.common import standard_parser
    from nic_torch.data.assets import read_clip
    from nic_torch.io.artifacts import save_checkpoint

    args, _ = standard_parser("", image_path="", num_bits=8,
                              num_epochs=1, latent_channels=16,
                              hidden_channels=32).parse_known_args(argv)
    asset = read_clip(os.path.join(ROOT, args.image_path)).astype(
        np.float32) / 255.0
    jt = ConvAETrainer(asset, num_bits=args.num_bits,
                       latent_channels=args.latent_channels,
                       hidden_channels=args.hidden_channels,
                       num_epochs=args.num_epochs, seed=args.seed)
    save_checkpoint(path, 0, _flatten_tree(jt.params, "params"))


def run_seed(workload: str, seed: int, device: str,
             package: str = "nic_torch", init: str = "port") -> tuple:
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
            if init == "jax":
                ckpt = os.path.join(tmp, "jax_init.ckpt.npz")
                jax_init_checkpoint(argv, ckpt)
                argv = argv + ["--resume", ckpt]
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
    ap.add_argument("--init", default="port", choices=("port", "jax"),
                    help="the port's runs start from its own initial "
                    "weights or from the JAX trainer's")
    ap.add_argument("workloads", nargs="*", default=list(WORKLOADS))
    args = ap.parse_args(argv)
    if args.init == "jax" and (args.package != "nic_torch"
                               or args.workloads != ["movie_3d_comp"]):
        ap.error("--init jax starts the port's movie_3d_comp runs")
    seeds = [int(s) for s in args.seeds.split(",")]
    out = {}
    for w in args.workloads:
        jax_psnr = fixture_meta(w)["psnr"]
        ps = []
        for s in seeds:
            p, sec = run_seed(w, s, args.device, args.package, args.init)
            ps.append(p)
            where = "JAX, cpu" if args.package == "nic" else args.device
            if args.init == "jax":
                where += ", JAX's initial params"
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
