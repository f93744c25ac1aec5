"""Write the trained conv-AE and pixel fixtures that hold ``nic_torch`` to
the JAX package.

Each workload runs its JAX CLI (``nic.cli.<workload>``) on the CPU in a
scratch output root, at the CLI's own widths and the epochs below, and
writes ``tests/fixtures/convae_<workload>.npz`` (compressed) holding

- the trained parameters under the JAX checkpoint's keys
  (``params/enc/params/MatmulConv_0/kernel`` …; the CLIs' default
  ``conv_impl="matmul"`` trees);
- ``latent``: the uint8 latent the CLI saved (``comp/<name>.npy``);
- ``losses``: the loss of every epoch (the CLI's scalars CSV);
- ``__meta__``: JSON of the workload, its flags, the epochs, the seed,
  the CLI's own PSNR of its decode (``report_image``/``report_video``:
  256-max, of the u8 reconstruction) and the command.

The decoded planes are not stored: a test decodes ``latent`` with JAX and
with the port. Workloads:

- ``image_comp``: ``data/sancho_512.png`` at 512², 4-bit latent [1, 128,
  128, 8], 1500 epochs;
- ``pixel_comp``: sancho 512², 8-bit latent [129, 129, 8], MLP 32→64→64→3,
  256 pixels a step, 2000 epochs;
- ``movie_3d_comp``: ``data/misty_64_64.avi`` (64 frames of 64²), 8-bit
  latent [1, 16, 16, 16, 16], 250 epochs.

Run (about ten minutes for all three on an 8-core CPU):
  JAX_PLATFORMS=cpu python scripts/make_torch_convae_fixture.py [WORKLOAD ...]
"""

from __future__ import annotations

import csv
import glob
import importlib
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED = 0
WORKLOADS = {
    "image_comp": ["--image_path", "data/sancho_512.png", "--num_epochs",
                   "1500", "--num_bits", "4"],
    "pixel_comp": ["--image_path", "data/sancho_512.png", "--num_epochs",
                   "2000", "--num_bits", "8", "--hidden", "64",
                   "--batch_pixels", "256"],
    "movie_3d_comp": ["--image_path", "data/misty_64_64.avi",
                      "--num_epochs", "250", "--num_bits", "8"],
}


def fixture_path(workload: str) -> str:
    return os.path.join(ROOT, "tests", "fixtures", f"convae_{workload}.npz")


def _losses(csv_path: str) -> np.ndarray:
    with open(csv_path) as f:
        rows = [r for r in csv.DictReader(f)
                if r["tag"] == "Loss/train_epoch_label"]
    return np.asarray([float(r["value"]) for r in rows], np.float32)


def make(workload: str) -> dict:
    from nic.cli import common

    argv = WORKLOADS[workload] + ["--seed", str(SEED),
                                  "--interval_print", "250"]
    mod = importlib.import_module(f"nic.cli.{workload}")
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            full = argv + ["--output_root", tmp]
            t0 = time.perf_counter()
            psnr = float(mod.run(full))
            seconds = time.perf_counter() - t0
            parser = common.standard_parser("")
            parser.add_argument("--hidden")
            parser.add_argument("--batch_pixels")
            args = parser.parse_known_args(full)[0]
            project = workload.replace("_comp", "")
            name = common.save_name(project, args)
            latent = np.load(os.path.join(tmp, "comp", f"{name}.npy"))
            with np.load(os.path.join(tmp, "model",
                                      f"{name}.ckpt.npz")) as z:
                params = {k: np.asarray(z[k]) for k in z.files
                          if k.startswith("params/")}
            (scalars,) = glob.glob(os.path.join(tmp, "log",
                                                f"{name}_scalars.csv"))
            losses = _losses(scalars)
    finally:
        os.chdir(cwd)
    meta = {"workload": workload, "argv": argv, "seed": SEED,
            "epochs": int(args.num_epochs), "num_bits": args.num_bits,
            "psnr": psnr, "cpu_seconds": seconds,
            "command": "JAX_PLATFORMS=cpu python "
                       "scripts/make_torch_convae_fixture.py " + workload}
    path = fixture_path(workload)
    np.savez_compressed(
        path, latent=latent, losses=losses,
        __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
        **params)
    print(f"{workload}: {os.path.relpath(path, ROOT)} "
          f"({os.path.getsize(path)} B): psnr {psnr:.4f} dB after "
          f"{meta['epochs']} epochs in {seconds:.1f} s; latent "
          f"{latent.shape} {latent.dtype}; loss {losses[0]:.5f} → "
          f"{losses[-1]:.5f}", flush=True)
    return meta


if __name__ == "__main__":
    for w in sys.argv[1:] or list(WORKLOADS):
        make(w)
