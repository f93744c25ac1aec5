"""Write the trained-model fixtures that hold ``nic_torch`` to the JAX fold.

``sancho`` trains the flagship 2D NTC workload (var2 defaults: 512² sancho, no-mip,
G0 [12,129,129] + G1 [12,65,65], MLP 73→64→64→3, FP_BITS 8) for 200 epochs
with JAX on the CPU, then writes

- ``tests/fixtures/ntc_sancho512_fp8.npz``: the bit-packed artifact;
- ``tests/fixtures/ntc_sancho512_fp8_ref.npz``: for mips 0–9, the JAX
  folded decode (``nic.grids.fastdecode.fast_decode``) of the artifact as
  ``load_compressed`` returns it, as u8 codes ``floor(x·255 + 0.5)``
  (``dec{mip}``); the original image mips as u8 (``orig{mip}``); the
  per-mip PSNR of those codes (256-max ``psnr``, 255-max ``psnr_255``), the
  artifact's bpp, the training run's own mip-0 PSNR, and the command.

``misty`` trains the 3D protocol (``data/misty_64_64.avi``, method 3,
no-mip, 8 crops of 32³, G0 [12,17,17,17] + G1 [12,9,9,9], MLP 127→64→64→3,
FP_BITS 8) for 200 epochs the same way and writes

- ``tests/fixtures/ntc_misty64_m3_fp8.npz``: the bit-packed artifact;
- ``tests/fixtures/ntc_misty64_m3_fp8_ref.npz``: the JAX folded decode at
  mips 0–6 as u8 codes (``dec{mip}``, [n, n, n, 3]), the per-mip PSNR of
  those codes against the clip sampled at stride 2^mip (``psnr``), the
  bpp, the training run's own per-mip PSNR and the command. The clip
  itself is in ``data/``.

The fixtures are the reference the port is held to where JAX is absent
(the CUDA machine): the folded path, not the Pallas kernel, so the two
kernels' rounding floors do not stack.

Run (about five minutes each on a CPU):
  JAX_PLATFORMS=cpu python scripts/make_torch_port_fixture.py [sancho|misty]
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OVERRIDES = ["NUM_EPOCHS=200", "SDC_GUARD_TRAIN=False"]
MIPS = range(10)
MISTY = OVERRIDES + ["IMAGE_PATH=data/misty_64_64.avi", "IMAGE_DIMENSION=3",
                     "COMPRESSION_METHOD=3", "IMAGE_SIZE=64",
                     "MAX_MIP_LEVEL=6", "CROP_MIP_LEVEL=5"]


def _train(argv_base, art_path):
    """The JAX CLI run in a scratch output root; copies its artifact to
    ``art_path`` and returns (cfg, results)."""
    from nic.cli import image_compression
    from nic.config import parse_overrides

    with tempfile.TemporaryDirectory() as tmp:
        argv = argv_base + [f"OUTPUT_ROOT={tmp}"]
        cfg = parse_overrides(argv)
        results = image_compression.run(argv)
        shutil.copyfile(os.path.join(tmp, "artifacts", f"{cfg.save_name}.npz"),
                        art_path)
    return cfg, results


def _u8(rec) -> np.ndarray:
    return np.floor(np.clip(np.asarray(rec), 0, 1) * 255.0 + 0.5).astype(
        np.uint8)


def misty() -> None:
    from nic.cli.image_compression import load_asset
    from nic.core.metrics import psnr
    from nic.grids.fastdecode import fast_decode
    from nic.grids.pyramid import pyramid_mip_levels
    from nic.io.artifacts import compressed_num_bits, load_compressed

    out_dir = os.path.join(ROOT, "tests", "fixtures")
    os.makedirs(out_dir, exist_ok=True)
    art_path = os.path.join(out_dir, "ntc_misty64_m3_fp8.npz")
    ref_path = os.path.join(out_dir, "ntc_misty64_m3_fp8_ref.npz")
    cfg, results = _train(MISTY, art_path)
    mlp, fp, meta = load_compressed(art_path)
    c = meta["config"]
    size = c["image_size"]
    m2l = pyramid_mip_levels(size, fp[0].shape[1] - 1, c["tf_no_mip"])
    vol = np.moveaxis(np.asarray(load_asset(cfg)[0]), 0, -1) * 255.0
    ref: dict = {}
    psnrs = []
    for mip in range(7):
        codes = _u8(fast_decode(
            fp, mlp, mip, image_size=size, mip_to_level=m2l,
            pe_channels=c["pe_channels"], use_tri_pe=True, ndim=3))
        ref[f"dec{mip}"] = codes
        orig = vol[::2**mip, ::2**mip, ::2**mip]
        psnrs.append(float(psnr(orig, codes.astype(np.float32))))
    bpp = compressed_num_bits(art_path) / size**3
    cmd = ("JAX_PLATFORMS=cpu python scripts/make_torch_port_fixture.py "
           "misty  # python -m nic.cli.image_compression " + " ".join(MISTY))
    np.savez_compressed(
        ref_path, psnr=np.asarray(psnrs), bpp=np.float64(bpp),
        run_psnr=np.asarray(results["psnr"]),
        run_bpp=np.float64(results["bpp"]),
        command=np.frombuffer(cmd.encode(), np.uint8), **ref)
    print(json.dumps({"psnr": psnrs, "bpp": bpp, "run_psnr": results["psnr"],
                      "run_bpp": results["bpp"]}))


def sancho() -> None:
    from nic.core.metrics import psnr
    from nic.data.assets import load_image_mips
    from nic.grids.fastdecode import fast_decode
    from nic.grids.pyramid import pyramid_mip_levels
    from nic.io.artifacts import compressed_num_bits, load_compressed

    out_dir = os.path.join(ROOT, "tests", "fixtures")
    os.makedirs(out_dir, exist_ok=True)
    art_path = os.path.join(out_dir, "ntc_sancho512_fp8.npz")
    ref_path = os.path.join(out_dir, "ntc_sancho512_fp8_ref.npz")
    cfg, results = _train(OVERRIDES, art_path)

    mlp, fp, meta = load_compressed(art_path)
    c = meta["config"]
    size = c["image_size"]
    m2l = pyramid_mip_levels(size, fp[0].shape[1] - 1, c["tf_no_mip"])
    origs = load_image_mips(os.path.join(ROOT, cfg.image_path), size,
                            max(MIPS))
    ref: dict = {}
    psnrs, psnrs_255 = [], []
    for mip in MIPS:
        rec = np.asarray(fast_decode(
            fp, mlp, mip, image_size=size, mip_to_level=m2l,
            pe_channels=c["pe_channels"], use_tri_pe=c["tf_use_tri_pe"],
            ndim=2,
        ))
        codes = np.floor(np.clip(rec, 0, 1) * 255.0 + 0.5).astype(np.uint8)
        orig = np.round(np.moveaxis(origs[mip], 0, -1) * 255.0).astype(
            np.uint8)
        ref[f"dec{mip}"] = codes
        ref[f"orig{mip}"] = orig
        o, r = orig.astype(np.float32), codes.astype(np.float32)
        psnrs.append(float(psnr(o, r)))
        psnrs_255.append(float(psnr(o, r, max_value=255.0)))
    bpp = compressed_num_bits(art_path) / (size * size)
    cmd = ("JAX_PLATFORMS=cpu python scripts/make_torch_port_fixture.py  "
           "# python -m nic.cli.image_compression " + " ".join(OVERRIDES))
    np.savez_compressed(
        ref_path, psnr=np.asarray(psnrs), psnr_255=np.asarray(psnrs_255),
        bpp=np.float64(bpp), run_psnr=np.asarray(results["psnr"]),
        run_bpp=np.float64(results["bpp"]),
        command=np.frombuffer(cmd.encode(), np.uint8), **ref,
    )
    print(json.dumps({"psnr": psnrs, "psnr_255": psnrs_255, "bpp": bpp,
                      "run_psnr": results["psnr"], "run_bpp": results["bpp"]}))


def main(argv) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in argv or ("sancho", "misty"):
        {"sancho": sancho, "misty": misty}[name]()


if __name__ == "__main__":
    main(sys.argv[1:])
