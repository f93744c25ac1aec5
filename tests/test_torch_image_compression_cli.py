"""The port's training CLI end to end on the CPU (64², crops of 32, 20
epochs), held to the JAX package: the artifact it writes decodes in JAX
(``load_compressed`` + ``fast_decode``) to within 2 u8 LSB of the port's
own mip-0 decode (the PNG the CLI wrote), the fp32-planes envelope of
ROADMAP.md."""

import os

import numpy as np
import pytest
import torch

from nic.grids.fastdecode import fast_decode
from nic.grids.pyramid import pyramid_mip_levels
from nic.io.artifacts import load_compressed
from nic_torch.cli import image_compression as tcli

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
    ("COMPRESSION_METHOD=3", "item 10"),
    ("IMAGE_SIZE_W=96", "item 9"),
    ("ENTROPY_CODE_GRIDS=True", "item 12"),
    ("DATA_PARALLEL=True", "item 13"),
    ("PROFILE_DIR=prof", "item 14"),
    ("TRAIN_FORWARD=kernel2", "items 3-4"),
    ("TRAIN_FORWARD=kernel", "items 3-4"),
    ("TRAIN_FORWARD=folded", "item 15"),
    ("DECODE_BACKEND=xla", "item 15"),
])
def test_unported_options_refuse(tmp_path, extra, item):
    with pytest.raises(NotImplementedError, match=item):
        tcli.run(ARGS + [extra, f"OUTPUT_ROOT={tmp_path}"])
