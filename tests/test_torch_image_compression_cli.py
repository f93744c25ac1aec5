"""The port's training CLI end to end on the CPU (64², crops of 32, 20
epochs; and 3D volumes cut from the bundled clip), held to the JAX
package: the artifact it writes decodes in JAX (``load_compressed`` +
``fast_decode``) to within 2 u8 LSB of the port's own mip-0 decode (the
PNG, or the AVI of a volume, the CLI wrote), the fp32-planes envelope of
ROADMAP.md."""

import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)

from nic.grids.fastdecode import fast_decode
from nic.grids.pyramid import pyramid_mip_levels
from nic.io.artifacts import load_compressed
from nic_torch.cli import image_compression as tcli
from nic_torch.data import assets as tassets

ARGS = ["DEVICE=cpu", "IMAGE_SIZE=64", "CROP_MIP_LEVEL=5", "NUM_EPOCHS=20"]


def test_artifact_decodes_in_jax(tmp_path):
    from PIL import Image

    res = tcli.run(ARGS + [f"OUTPUT_ROOT={tmp_path}", "INTERVAL_PRINT=10"])
    assert len(res["psnr"]) == 1 and np.isfinite(res["psnr"][0])
    assert res["psnr"][0] > 12.0 and res["bpp"] > 0
    mlp, fp, meta = load_compressed(res["artifact"])
    m2l = pyramid_mip_levels(64, fp[0].shape[1] - 1, meta["config"]
                             ["tf_no_mip"])
    jax_rec = np.asarray(fast_decode(fp, mlp, 0, image_size=64,
                                     mip_to_level=m2l, pe_channels=6))
    jax_u8 = np.floor(np.clip(jax_rec, 0, 1) * 255.0 + 0.5).astype(int)
    image_dir = os.path.join(tmp_path, "image")
    (png,) = [os.path.join(root, f) for root, _, files in os.walk(image_dir)
              for f in files if f.endswith("_0_000.png")]
    port_u8 = np.asarray(Image.open(png)).astype(int)
    assert port_u8.shape == jax_u8.shape == (64, 64, 3)
    assert np.abs(port_u8 - jax_u8).max() <= 2
    # the interval checkpoints and the scalar log are there
    assert os.listdir(os.path.join(tmp_path, "ckpt"))
    assert any(f.endswith("_scalars.csv")
               for f in os.listdir(os.path.join(tmp_path, "log")))
    # TF_TRAIN_MODEL=False decodes the saved artifact instead of training
    again = tcli.run(ARGS + [f"OUTPUT_ROOT={tmp_path}", "TF_TRAIN_MODEL=False"])
    assert again["psnr"] == res["psnr"] and again["bpp"] == res["bpp"]


def test_cuda_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="DEVICE=cpu"):
        tcli.run(ARGS[1:] + [f"OUTPUT_ROOT={tmp_path}"])  # DEVICE=cuda default


@pytest.mark.parametrize("extra,item", [
    ("DATA_PARALLEL=True", "item 13"),
])
def test_unported_options_refuse(tmp_path, extra, item):
    """The options ROADMAP.md listed as unported now run: DATA_PARALLEL
    (queue 1, item 13) without a launcher trains one rank and says so."""
    res = tcli.run(ARGS + [extra, "NUM_EPOCHS=2", "MAX_MIP_LEVEL=1",
                           f"OUTPUT_ROOT={tmp_path}"])
    assert np.isfinite(res["psnr"]).all(), item
    (log,) = os.listdir(os.path.join(tmp_path, "printlog"))
    with open(os.path.join(tmp_path, "printlog", log)) as f:
        assert "no launcher: one rank" in f.read(), item


def test_entropy_code_grids_decodes_as_fixed_length(tmp_path):
    """ENTROPY_CODE_GRIDS=True runs: the CLI writes a rANS-coded artifact,
    its bpp is that artifact's, and the decode CLI reads it at every mip
    to the decode of the same codes saved fixed-length."""
    from nic.io.artifacts import compressed_num_bits as jax_bits
    from nic_torch.cli import decode as dcli
    from nic_torch.io import artifacts as tart

    res = tcli.run(ARGS + ["ENTROPY_CODE_GRIDS=True", "MAX_MIP_LEVEL=3",
                           f"OUTPUT_ROOT={tmp_path}"])
    art = res["artifact"]
    mlp, fp, meta = tart.load_compressed(art, device="cpu")
    assert meta["entropy_coded"] and meta["rans_format"] in (2, 3)
    assert res["bpp"] == tart.compressed_num_bits(art) / 64**2
    assert jax_bits(art) == tart.compressed_num_bits(art)
    fixed = str(tmp_path / "fixed.npz")
    tart.save_compressed(fixed, mlp, fp, meta["fp_bits"],
                         {"save_name": "fixed", "config": meta["config"]})
    for mip in range(4):
        got = dcli.run([art, "--mip", str(mip), "--device", "cpu"])
        want = dcli.run([fixed, "--mip", str(mip), "--device", "cpu"])
        assert got.shape == want.shape == (64 >> mip, 64 >> mip, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("forward,extra", [
    ("kernel2", "TF_USE_TRI_PE=False"), ("kernel", "TF_NO_MIP=False")])
def test_kernel_engines_train_on_cpu(tmp_path, forward, extra):
    """TRAIN_FORWARD=kernel2 (sinusoidal PE) and kernel (mip mode) run
    through the CLI on the CPU, on their kernels' plain versions: the gate
    log names the engine, the losses are finite and every mip decodes."""
    res = tcli.run(ARGS[:3] + ["NUM_EPOCHS=6", "MAX_MIP_LEVEL=3", extra,
                               f"TRAIN_FORWARD={forward}",
                               f"OUTPUT_ROOT={tmp_path}"])
    (log,) = os.listdir(os.path.join(tmp_path, "printlog"))
    with open(os.path.join(tmp_path, "printlog", log)) as fh:
        gates = [ln for ln in fh if "train forward gate" in ln]
    assert gates and all(f"): {forward} [" in ln for ln in gates
                         if "lod=0," in ln)
    assert np.isfinite(res["psnr"]).all() and res["bpp"] > 0


@pytest.mark.parametrize("extra,gate", [
    (["TRAIN_FORWARD=folded"], "train forward gate (lod=0, frozen=False): "
                               "folded [TRAIN_FORWARD=folded]"),
    (["DECODE_BACKEND=xla", "DIV_SIZE=1"],
     "decode backend gate (mip=0): tiled (16 tiles, xla gather) "
     "[DECODE_BACKEND=xla -> xla]")], ids=["folded", "xla-tiled"])
def test_folded_forward_and_xla_decode_run(tmp_path, extra, gate):
    """TRAIN_FORWARD=folded, and DECODE_BACKEND=xla with the tiled decode
    (2^(3 − 0 − 1) = 4 tiles per axis at mip 0), through the CLI: the gate
    log names them, the losses are finite and every mip decodes."""
    res = tcli.run(ARGS[:3] + ["NUM_EPOCHS=6", "MAX_MIP_LEVEL=3",
                               "TF_NO_MIP=False", *extra,
                               f"OUTPUT_ROOT={tmp_path}"])
    (log,) = os.listdir(os.path.join(tmp_path, "printlog"))
    with open(os.path.join(tmp_path, "printlog", log)) as fh:
        assert gate in fh.read()
    assert np.isfinite(res["psnr"]).all() and res["bpp"] > 0


def test_2d_image_takes_method_1_only(tmp_path):
    """Methods 2-4 are volume methods; a 2D image refuses them as the JAX
    CLI does."""
    with pytest.raises(ValueError, match="must be 1 for 2d image"):
        tcli.run(ARGS + ["COMPRESSION_METHOD=3", f"OUTPUT_ROOT={tmp_path}"])


@pytest.fixture(scope="module")
def clip16(tmp_path_factory):
    """16 frames of 16² cut from the bundled clip, as an AVI."""
    path = str(tmp_path_factory.mktemp("clip") / "misty16.avi")
    tassets.write_timelaps(tassets.read_clip("data/misty_64_64.avi")
                           [:16, :16, :16], path)
    return path


def _one(root, suffix):
    (path,) = [os.path.join(r, f) for r, _, files in os.walk(root)
               for f in files if f.endswith(suffix)]
    return path


def _u8(rec):
    return np.floor(np.clip(np.asarray(rec), 0, 1) * 255.0 + 0.5).astype(int)


@pytest.mark.parametrize("method", [3, 4])
def test_3d_cli_artifact_decodes_in_jax(tmp_path, clip16, method):
    """IMAGE_DIMENSION=3 at IMAGE_SIZE=16 (crops of 8³): the targets are
    JAX's, the mip-0 volume the CLI wrote as an AVI is within 2 u8 LSB of
    JAX's fold of the artifact, every mip is scored, the frame-averaged
    PSNR is logged and SAVE_LUT_CSV writes each mip's LUT in the JAX
    package's layout."""
    from nic.cli.image_compression import load_asset as j_load_asset
    from nic.config import parse_overrides as j_parse
    from nic.data.assets import save_lut_csv as j_save_lut_csv

    argv = ["DEVICE=cpu", f"IMAGE_PATH={clip16}", "IMAGE_DIMENSION=3",
            f"COMPRESSION_METHOD={method}", "IMAGE_SIZE=16", "MAX_MIP_LEVEL=4",
            "CROP_MIP_LEVEL=3", "NUM_CROPS=2", "NUM_EPOCHS=6",
            "SAVE_LUT_CSV=True"]
    jcfg = j_parse(argv[1:])
    for a, b in zip(tcli.load_asset(tcli.parse_overrides(argv)),
                    j_load_asset(jcfg)):
        np.testing.assert_array_equal(a, np.asarray(b))
    res = tcli.run(argv + [f"OUTPUT_ROOT={tmp_path}"])
    mips = jcfg.effective_max_mip_level + 1
    assert len(res["psnr"]) == mips and np.isfinite(res["psnr"]).all()
    assert np.isfinite(res["average_psnr"]) and res["bpp"] > 0

    mlp, fp, meta = load_compressed(res["artifact"])
    c = meta["config"]
    assert c["image_dimension"] == 3 and c["compression_method"] == method
    m2l = pyramid_mip_levels(16, fp[0].shape[1] - 1, c["tf_no_mip"])
    jax_u8 = _u8(fast_decode(fp, mlp, 0, image_size=16, mip_to_level=m2l,
                             pe_channels=6, ndim=3, use_tri_pe=method == 3,
                             sparse_g0=method == 4))
    port_u8 = tassets.read_clip(_one(tmp_path / "image", "_0_000.avi"))
    assert port_u8.shape == jax_u8.shape == (16, 16, 16, 3)
    assert np.abs(port_u8.astype(int) - jax_u8).max() <= 2
    lut = _one(tmp_path / "LUT", "_0_000.csv")
    j_save_lut_csv(port_u8.astype(np.float32), str(tmp_path / "j.csv"))
    with open(lut) as a, open(tmp_path / "j.csv") as b:
        assert a.read() == b.read()


def test_3d_cli_method_2_tile_sheet(tmp_path, clip16):
    """Method 2 trains the 2D path on the frames' tile sheet (64² of 16
    tiles) and writes the mip-0 decode back as the clip's frames."""
    from nic.cli.image_compression import load_asset as j_load_asset
    from nic.config import parse_overrides as j_parse

    argv = ["DEVICE=cpu", f"IMAGE_PATH={clip16}", "IMAGE_DIMENSION=3",
            "COMPRESSION_METHOD=2", "IMAGE_SIZE=64", "IMAGE_3D_SIZE=16",
            "CROP_MIP_LEVEL=5", "NUM_CROPS=2", "NUM_EPOCHS=6"]
    for a, b in zip(tcli.load_asset(tcli.parse_overrides(argv)),
                    j_load_asset(j_parse(argv[1:]))):
        np.testing.assert_array_equal(a, np.asarray(b))
    res = tcli.run(argv + [f"OUTPUT_ROOT={tmp_path}"])
    assert np.isfinite(res["psnr"]).all()
    mlp, fp, meta = load_compressed(res["artifact"])
    assert fp[0].ndim == 3  # 2D grids
    m2l = pyramid_mip_levels(64, fp[0].shape[1] - 1,
                             meta["config"]["tf_no_mip"])
    sheet = _u8(fast_decode(fp, mlp, 0, image_size=64, mip_to_level=m2l,
                            pe_channels=6))
    frames = tassets.read_clip(_one(tmp_path / "image", "_0_000.avi"))
    assert frames.shape == (16, 16, 16, 3)
    want = tassets.unflatten_2d_to_3d(sheet, 16, 16)
    assert np.abs(frames.astype(int) - want).max() <= 2
