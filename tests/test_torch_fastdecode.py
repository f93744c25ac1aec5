"""nic_torch.grids.fastdecode against nic.grids.fastdecode: the W1 fold and
the folded decode on the same numpy-seeded pyramid and MLP (64², base 16,
C=4, H=16), at atol 2e-5 — the bound the JAX suite holds its own
decode paths to."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)

from nic.core.quant import quant_range
from nic.grids import fastdecode as jfd
from nic.grids.pyramid import pyramid_levels, pyramid_mip_levels
from nic_torch.grids import fastdecode as tfd
from nic_torch.grids import pyramid as tpyr
from nic_torch.io.convert import params_from_jax

SIZE, BASE, C, PE, HIDDEN = 64, 16, 4, 4, 16


def make_model(seed, base=BASE, c=C, pe=PE, hidden=HIDDEN, no_mip=False):
    """Numpy pyramid (values in the 8-bit quantizer range) and MLP."""
    rng = np.random.default_rng(seed)
    sizes = (base, base) if isinstance(base, int) else base
    levels = 1 if no_mip else pyramid_levels(min(sizes))
    q_min, q_max = quant_range(8)
    fp = tuple(
        rng.uniform(q_min, q_max, (c,) + tuple(s // 2**i + 1 for s in sizes))
        .astype(np.float32) for i in range(2 * levels))
    dims = [c * 5 + 2 * pe + 1, hidden, hidden, 3]
    mlp = {}
    for i in range(3):
        bound = 2.0 / np.sqrt(dims[i])  # 2× the init bound: real curvature
        mlp[f"w{i + 1}"] = rng.uniform(-bound, bound, dims[i:i + 2]).astype(
            np.float32)
        mlp[f"b{i + 1}"] = rng.uniform(-bound, bound, dims[i + 1]).astype(
            np.float32)
    return fp, mlp


def both(fp, mlp):
    """The same parameters for the JAX package and for the port (CPU)."""
    jfp = tuple(jnp.asarray(g) for g in fp)
    jmlp = {k: jnp.asarray(v) for k, v in mlp.items()}
    return (jfp, jmlp), params_from_jax(fp, mlp, device="cpu")


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("use_tri_pe", [True, False])
@pytest.mark.parametrize("mip", [0, 1, 2, 3, 4])
def test_fast_decode_matches_jax(mip, use_tri_pe, quirk):
    """e = mip − (fl+1)·2 covers −2, −1, 0, 1 (the step == 2 quirk) and 0
    again at pyramid level 1."""
    fp, mlp = make_model(100 + mip)
    (jfp, jmlp), (tfp, tmlp) = both(fp, mlp)
    m2l = pyramid_mip_levels(SIZE, BASE)
    assert tpyr.pyramid_mip_levels(SIZE, BASE) == m2l
    kw = dict(image_size=SIZE, mip_to_level=m2l, pe_channels=PE,
              use_tri_pe=use_tri_pe, ndim=2, g1_quirk=quirk)
    want = np.asarray(jfd.fast_decode(jfp, jmlp, mip, **kw))
    with torch.inference_mode():
        got = tfd.fast_decode(tfp, tmlp, mip, **kw).numpy()
    assert got.shape == want.shape == (SIZE >> mip, SIZE >> mip, 3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("fl", [0, 1])
def test_precompute_first_layer_matches_jax(fl):
    fp, mlp = make_model(7)
    (jfp, jmlp), (tfp, tmlp) = both(fp, mlp)
    kw = dict(ndim=2, channels=C, pe_channels=PE)
    want = jfd.precompute_first_layer(jfp, fl, jmlp, **kw)
    got = tfd.precompute_first_layer(tfp, fl, tmlp, **kw)
    for w, g in zip(want[:2], got[:2]):  # P, C1
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=2e-6, rtol=0)
    for w, g in zip(want[2] + [want[3], want[4]], got[2] + [got[3], got[4]]):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))


def test_fast_decode_rectangular_matches_jax():
    """Native rectangular geometry: 64×128 image on a 16×32 base."""
    fp, mlp = make_model(11, base=(16, 32), no_mip=True)
    (jfp, jmlp), (tfp, tmlp) = both(fp, mlp)
    m2l = pyramid_mip_levels(64, 16, no_mip=True)
    for mip in (0, 1):
        kw = dict(image_size=64, mip_to_level=m2l, pe_channels=PE, ndim=2,
                  n=(64 >> mip, 128 >> mip))
        want = np.asarray(jfd.fast_decode(jfp, jmlp, mip, **kw))
        with torch.inference_mode():
            got = tfd.fast_decode(tfp, tmlp, mip, **kw).numpy()
        assert got.shape == (64 >> mip, 128 >> mip, 3)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("e", [-2, -1, 0, 1, 2])
def test_axis_take_up(e):
    plane = np.random.default_rng(5).normal(size=(9, 9, 3)).astype(np.float32)
    n = 9 if e <= 0 else 3
    want = np.asarray(jfd._axis_take_up(jnp.asarray(plane), e, n, 0, axis=1))
    got = tfd._axis_take_up(torch.from_numpy(plane), e, n, axis=1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("matmul_dtype", [None, "bf16"])
def test_mlp_matches_jax(matmul_dtype):
    from nic.models.mlp import apply_mlp, apply_mlp_tail, mlp_param_bits
    from nic_torch.models import mlp as tm

    fp, mlp = make_model(81)
    (_, jmlp), (_, tmlp) = both(fp, mlp)
    x = np.random.default_rng(1).normal(size=(257, mlp["w1"].shape[0]))
    x = x.astype(np.float32)
    jdt = None if matmul_dtype is None else jnp.bfloat16
    tdt = None if matmul_dtype is None else torch.bfloat16
    want = np.asarray(apply_mlp(jmlp, jnp.asarray(x), jdt))
    got = tm.apply_mlp(tmlp, torch.from_numpy(x), tdt).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    acc = x[:, :HIDDEN]
    want = np.asarray(apply_mlp_tail(jmlp, jnp.asarray(acc), jdt))
    got = tm.apply_mlp_tail(tmlp, torch.from_numpy(acc), tdt).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    assert tm.mlp_param_bits(tmlp) == mlp_param_bits(jmlp)


def test_create_pyramid_and_init_mlp():
    from nic.grids.pyramid import create_pyramid, pyramid_quantize_all
    import jax

    from nic_torch.models.mlp import init_mlp

    gen = torch.Generator().manual_seed(0)
    tfp, levels = tpyr.create_pyramid(gen, (16, 32), 4, 4, device="cpu")
    jfp, jlevels = create_pyramid(jax.random.PRNGKey(0), (16, 32), 4, 4)
    assert levels == jlevels
    assert [tuple(g.shape) for g in tfp] == [g.shape for g in jfp]
    q_min, q_max = quant_range(4)
    assert all(float(g.min()) >= q_min and float(g.max()) <= q_max
               for g in tfp)
    # the same seed gives the same grids on any device it is moved to
    again, _ = tpyr.create_pyramid(torch.Generator().manual_seed(0), (16, 32),
                                   4, 4, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tfp, again))
    q = tpyr.pyramid_quantize_all(tfp, 4)
    want = pyramid_quantize_all(tuple(jnp.asarray(g.numpy()) for g in tfp), 4)
    for a, b in zip(q, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with torch.no_grad():
        mlp = init_mlp(gen, 33, 16, 3, device="cpu")
    assert mlp.w1.requires_grad  # a fresh decoder is trainable
    mlp.requires_grad_(False)
    assert mlp.w1.shape == (33, 16) and mlp.w3.shape == (16, 3)
    assert float(mlp.w1.abs().max()) <= 1 / np.sqrt(33)
    assert float(mlp.b3.abs().max()) <= 1 / np.sqrt(16)
