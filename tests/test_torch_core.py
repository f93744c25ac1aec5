"""nic_torch.core against nic.core: quantizer codes and packed bytes
bit-exact, PE tables and PSNR to float rounding. Inputs are made with
numpy from a seed and handed to both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)

from nic.core import encodings as jenc
from nic.core import metrics as jmet
from nic.core import quant as jq
from nic_torch.core import encodings as tenc
from nic_torch.core import metrics as tmet
from nic_torch.core import quant as tq


def _grid_values(bits: int, n: int = 4096, seed: int = 0) -> np.ndarray:
    """Random grid values plus every exact half-code tie (k + ½)/s."""
    q_min, q_max = jq.quant_range(bits)
    rng = np.random.default_rng(seed)
    s = 2.0**bits - 1.0
    k = np.arange(int(q_min * s) - 1, int(q_max * s) + 1)
    ties = ((k + 0.5) / s).astype(np.float32)
    ties = ties[(ties >= q_min) & (ties <= q_max)]
    rand = rng.uniform(q_min, q_max, n).astype(np.float32)
    return np.concatenate([rand, ties, np.float32([q_min, q_max, 0.0])])


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pack_grid_bit_exact_with_half_up_ties(bits):
    x = _grid_values(bits, seed=bits)
    want = np.asarray(jq.pack_grid(jnp.asarray(x), bits))
    got = tq.pack_grid(torch.from_numpy(x), bits).numpy()
    np.testing.assert_array_equal(got, want)
    # the set holds real ties (x·s + ½ an integer in fp32), where
    # half-to-even rounding would give another code
    xs = torch.from_numpy(x) * (2.0**bits - 1.0)
    tie = (xs - torch.floor(xs)) == 0.5
    assert int(tie.sum()) > 0
    assert not torch.equal(torch.round(xs[tie]), torch.floor(xs[tie] + 0.5))
    back = tq.unpack_grid(torch.from_numpy(got), bits).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jq.unpack_grid(jnp.asarray(want), bits)))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_bit_exact(bits):
    x = np.random.default_rng(bits).uniform(0, 1, 2048).astype(np.float32)
    for jf, tf in ((jq.quantize, tq.quantize),
                   (jq.quantize_to_bit, tq.quantize_to_bit)):
        np.testing.assert_array_equal(
            tf(torch.from_numpy(x), bits).numpy(),
            np.asarray(jf(jnp.asarray(x), bits)))
    assert tq.quant_range(bits) == jq.quant_range(bits)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_bits_bytes(bits):
    rng = np.random.default_rng(10 + bits)
    codes = rng.integers(0, 2**bits, size=(3, 17, 17), dtype=np.uint8)
    packed = tq.pack_bits(codes, bits)
    np.testing.assert_array_equal(packed, jq.pack_bits(codes, bits))
    assert packed.size == -(-codes.size * bits // 8)
    np.testing.assert_array_equal(
        tq.unpack_bits(packed, bits, codes.size), codes.reshape(-1))


@pytest.mark.parametrize("channels", [6, 5])
@pytest.mark.parametrize("kind", ["sinusoidal", "triangular"])
def test_pe_tables(kind, channels):
    coords = np.random.default_rng(3).uniform(-3, 70, (2, 257)).astype(
        np.float32)
    want = np.asarray(getattr(jenc, f"{kind}_pe")(jnp.asarray(coords),
                                                  channels))
    got = getattr(tenc, f"{kind}_pe")(torch.from_numpy(coords), channels)
    assert got.shape == want.shape == (2 * channels, 257)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert tenc.pe_dim(channels, 2) == jenc.pe_dim(channels, 2)
    if kind == "triangular":  # the reference's zero row (j == 0)
        assert not got[channels - 1].any() and not got[-1].any()


@pytest.mark.parametrize("max_value", [None, 255.0])
def test_psnr(max_value):
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (32, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 4, a.shape), 0, 255).astype(np.float32)
    want = float(jmet.psnr(a, b, max_value=max_value))
    got = float(tmet.psnr(torch.from_numpy(a), torch.from_numpy(b),
                          max_value=max_value))
    assert abs(got - want) < 1e-4
    assert float(tmet.mse(a, b)) == pytest.approx(float(jmet.mse(a, b)),
                                                  rel=1e-6)
    assert float(tmet.psnr(a, a)) == float("inf")
