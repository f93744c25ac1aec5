"""nic_torch.data.assets and the 3D pieces of nic_torch.core against the
JAX package: the bundled clip read bit for bit, the volume's codes, the
AVI writer (the port's stdlib codec) read back unchanged, method 2's tile
sheet, the LUT CSV text, and the frame-averaged PSNR."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)

from nic.core import metrics as jmet
from nic.core import quant as jq
from nic.data import assets as jassets
from nic_torch.core import metrics as tmet
from nic_torch.core import quant as tq
from nic_torch.data import assets as tassets

CLIP = "data/misty_64_64.avi"


def test_read_clip_and_load_volume_bit_equal():
    path = CLIP
    want = jassets.read_clip(path)
    got = tassets.read_clip(path)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    for bits in (8, 6):
        wv = np.asarray(jassets.load_volume(path, bits))
        gv = tassets.load_volume(path, bits)
        assert gv.shape == wv.shape
        np.testing.assert_array_equal(gv, wv.astype(gv.dtype))


def test_read_clip_refuses_other_video(tmp_path):
    path = tmp_path / "x.avi"
    path.write_bytes(b"RIFF\0\0\0\0AVI LIST")
    with pytest.raises(ValueError, match="DIB"):
        tassets.read_clip(str(path))
    assert tassets.asset_kind("a.NPZ") == jassets.asset_kind("a.NPZ")
    for name in ("a.avi", "b.mp4", "c.png", "d.jpeg"):
        assert tassets.asset_kind(name) == jassets.asset_kind(name)


@pytest.mark.parametrize("shape", [(5, 16, 16, 3), (3, 6, 10, 3)])
def test_avi_writer_round_trips(tmp_path, shape):
    """The stdlib AVI writer's frames read back unchanged through both
    packages' raw-DIB readers (odd widths exercise the 4-byte row pad)."""
    movie = np.random.default_rng(sum(shape)).integers(
        0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "sub" / "m.avi")
    tassets.write_timelaps(movie, path)
    np.testing.assert_array_equal(tassets.read_clip(path), movie)
    np.testing.assert_array_equal(jassets.read_clip(path), movie)
    with pytest.raises(ValueError):
        tassets.write_timelaps(movie.astype(np.float32), path)


def test_tile_sheet_matches_jax():
    vol = np.random.default_rng(2).integers(0, 256, (16, 8, 8, 3)).astype(
        np.uint8)
    sheet = tassets.flatten_3d_to_2d(vol, 32)
    np.testing.assert_array_equal(sheet, jassets.flatten_3d_to_2d(vol, 32))
    np.testing.assert_array_equal(tassets.unflatten_2d_to_3d(sheet, 8, 16),
                                  vol)


def test_lut_csv_text_matches_jax(tmp_path):
    lut = np.random.default_rng(5).uniform(0, 255, (4, 4, 4, 3)).astype(
        np.float32)
    tassets.save_lut_csv(lut, str(tmp_path / "t" / "lut.csv"))
    jassets.save_lut_csv(lut, str(tmp_path / "j" / "lut.csv"))
    assert (tmp_path / "t" / "lut.csv").read_text() == \
        (tmp_path / "j" / "lut.csv").read_text()


@pytest.mark.parametrize("bits", [4, 8])
def test_bit_code_helpers_match_jax(bits):
    codes = np.random.default_rng(bits).uniform(
        0, 2.0**bits - 1, 4096).astype(np.float32)
    np.testing.assert_array_equal(
        tq.normalize_from_bit(torch.from_numpy(codes), bits).numpy(),
        np.asarray(jq.normalize_from_bit(jnp.asarray(codes), bits)))
    np.testing.assert_array_equal(
        tq.quantize_from_bit_to_bit(torch.from_numpy(codes), bits).numpy(),
        np.asarray(jq.quantize_from_bit_to_bit(jnp.asarray(codes), bits)))


@pytest.mark.parametrize("max_value", [None, 255.0])
def test_average_psnr(max_value):
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, (6, 16, 16, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 3, a.shape), 0, 255).astype(np.float32)
    want = float(jmet.average_psnr(a, b, max_value=max_value))
    got = float(tmet.average_psnr(torch.from_numpy(a), torch.from_numpy(b),
                                  max_value=max_value))
    assert abs(got - want) < 1e-4
