"""K13 (nic_torch.kernels.hs_bins) on the CPU: its plain version against
JAX's ``h_s_bins`` at the kernel's edge shapes (a ẑ of one pixel, ragged
tiles, a batch, odd widths), and the kernel's launch plan (the tiles,
grids and shared memory ``csrc/hs_bins.cu`` picks) for every width the
CLIs and the model admit. The kernel itself runs only on a card
(``chip_smoke.py`` phase 29 holds it to this plain version bit for
bit)."""

import functools
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nic.models.hyperprior import HyperpriorModel as JaxModel
from nic.train.hyperprior import HyperpriorCodec as JaxCodec
from nic_torch.io.convert import hyperprior_from_jax
from nic_torch.kernels import hs_bins as k13
from nic_torch.models.hyperprior import HyperpriorModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "nic_torch", "kernels", "csrc", "hs_bins.cu")


@functools.lru_cache(maxsize=None)
def _models(n: int, m: int):
    """(JAX codec, the port's rows-layout weights, JAX's jitted
    hyper-synthesis) of one flax init with seeded biases."""
    model = JaxModel(n, m)
    params = jax.jit(lambda k, x: model.init({"params": k}, x, None))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(1)
    flat = {"/".join(str(q.key) for q in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params["params"])[0]}
    flat = {k: (v if k.endswith("kernel") else
                v + rng.normal(0, 0.05, v.shape).astype(np.float32))
            for k, v in flat.items()}
    from nic_torch.io import bitstream as tbits

    params = {"params": jax.tree.map(jnp.asarray, tbits.nest(flat))}
    port = HyperpriorModel(n, m)
    hyperprior_from_jax(port, flat)
    codec = JaxCodec(types.SimpleNamespace(model=model, params=params))
    synth = jax.jit(lambda z: model.apply(params, z,
                                          method=model.hyper_synthesis))
    return codec, k13.hs_weights(port.h_s), synth


# (n, m, B, ẑ rows, ẑ columns): one pixel, ragged 16-column tiles, a
# batch, odd widths (the kernel's 4-byte copy path)
EDGE_CASES = [(8, 12, 1, 1, 1), (8, 12, 1, 3, 5), (8, 12, 2, 2, 3),
              (5, 7, 1, 3, 5)]


@pytest.mark.parametrize("n,m,b,h4,w4", EDGE_CASES)
def test_hs_bins_plain_against_jax_at_edge_shapes(n, m, b, h4, w4):
    """σ rel 1e-5 against JAX's hyper-synthesis and the share of bins that
    differ from JAX's ``h_s_bins`` ≤ 1e-3, as at 16×16."""
    codec, wt, synth = _models(n, m)
    rng = np.random.default_rng(100 * h4 + w4)
    z = np.round(rng.normal(0, 2.5, (b, h4, w4, n))).astype(np.float32)
    sigma, bins = k13.hs_bins_plain(
        torch.from_numpy(np.ascontiguousarray(z.transpose(0, 3, 1, 2))), wt)
    assert sigma.shape == (b, m, 4 * h4, 4 * w4) and bins.dtype == torch.int32
    np.testing.assert_allclose(sigma.permute(0, 2, 3, 1).numpy(),
                               np.asarray(synth(z)), rtol=1e-5)
    got = bins.permute(0, 2, 3, 1).numpy()
    want = np.asarray(codec._h_s_bins(jnp.asarray(z)))
    assert ((got >= 0) & (got <= 63)).all()
    assert (got != want).sum() / got.size <= 1e-3


def test_hs_bins_kernel_on_cpu_is_the_plain_version():
    """A CPU tensor runs the plain version (same bits) and counts no
    launch."""
    _, wt, _ = _models(8, 12)
    gen = torch.Generator().manual_seed(4)
    z = torch.round(torch.randn(2, 8, 3, 5, generator=gen) * 3)
    before = k13.hs_bins_kernel.launches
    s_k, b_k = k13.hs_bins_kernel(z, wt)
    s_p, b_p = k13.hs_bins_plain(z, wt)
    assert k13.hs_bins_kernel.launches == before
    assert torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
    assert torch.equal(b_k, b_p)


# every width the CLIs and the model admit by default, the CPU tests'
# widths, and the kernel's other paths (odd widths, 8-column tiles)
WIDTHS = [(96, 128), (128, 192), (8, 12), (5, 7), (13, 20), (700, 24),
          (932, 1)]


@pytest.mark.parametrize("n,m", WIDTHS)
def test_launch_plan_fits_every_admitted_width(n, m):
    """Each layer's tile fits a block's 232,448 B of shared memory, and
    its grid covers the layer's outputs, at 512×768, 2048², a one-pixel ẑ
    and a batch of two."""
    for b, h4, w4 in ((1, 8, 12), (1, 32, 32), (1, 1, 1), (2, 3, 5)):
        plan = k13.launch_plan(n, m, h4, w4, b)
        assert len(plan) == 3
        for layer, (h, w, co, phases) in zip(plan, (
                (h4, w4, n, 4), (2 * h4, 2 * w4, n, 4),
                (4 * h4, 4 * w4, m, 1))):
            assert layer["smem"] <= k13.SMEM_LIMIT
            assert layer["threads"] == 4 * layer["tw"]
            gx, gy, gz = layer["grid"]
            assert gx * layer["tw"] * layer["tr"] >= h * w
            assert gy * 16 >= co and gz == b * phases


def test_launch_plan_tiles_by_shape():
    """1-row tiles where a layer's 4-row grid would give fewer than 2
    blocks an SM (512×768 at the CLIs' widths), 4-row tiles at 2048², and
    8-column tiles past n = 668."""
    small = k13.launch_plan(96, 128, 8, 12)
    assert [(p["tw"], p["tr"]) for p in small] == [(16, 1)] * 3
    assert [p["grid"] for p in small] == [(8, 6, 4), (32, 6, 4), (96, 8, 1)]
    assert small[2]["smem"] == 34704
    assert [(p["tw"], p["tr"]) for p in k13.launch_plan(96, 128, 32, 32)] \
        == [(16, 4)] * 3
    assert {p["tw"] for p in k13.launch_plan(700, 24, 2, 3)} == {8}


def test_launch_plan_refuses_a_width_with_no_tile():
    for n in range(1, 933):
        k13.launch_plan(n, 1, 1, 1)
    with pytest.raises(ValueError, match="n = 933"):
        k13.launch_plan(933, 1, 1, 1)


def test_launch_plan_mirrors_the_source():
    """The Python plan's constants are the CUDA source's."""
    src = open(SOURCE).read()

    def const(name):
        return eval(re.search(rf"constexpr \w+ {name} = ([^;]+);",
                              src).group(1))

    assert const("kTC") == k13._TC
    assert const("kMaxSmem") == k13.SMEM_LIMIT
    assert const("kFillBlocks") == k13._FILL_BLOCKS
    for n in (1, 5, 8, 13, 96, 128, 700):
        assert k13._chan_stride(n) % 4 == 0 and (k13._chan_stride(n) // 4) % 2
        assert n <= k13._chan_stride(n) <= n + 7
