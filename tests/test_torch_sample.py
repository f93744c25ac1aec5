"""nic_torch.grids.sample.decoder_input against nic.grids.sample: the
[N, F] decoder input and its gradient with respect to both grids, for the
crop lattices of steps 0.25, 0.5, 1 and 2 (the step == 2 raw-sum G1
quirk on and off), triangular and sinusoidal PE, in 2D and in 3D (method
3's eight G0 corners with triangular PE, method 4's four even-parity ones
with sinusoidal PE). Inputs are numpy-seeded (C=4, PE 4; in 2D a 17-node
G0 and 9-node G1, in 3D 9 and 5 nodes per axis; two crops of half the
data size). The values are gathers and fp32 interpolations of the same
numbers (atol 1e-6); the gradients are scatter-added sums whose order
differs (2D atol 1e-5; 3D, with ~10³ terms per node, 1e-5 of the largest
gradient)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)

from nic.grids import sample as jsample
from nic_torch.grids import sample as tsample

C, PE = 4, 4


def _setup(seed, step):
    rng = np.random.default_rng(seed)
    data = int(round(16 / step))  # the G0 lattice spans 16 cells
    n = data // 2
    g0 = rng.uniform(-0.4, 0.5, (C, 17, 17)).astype(np.float32)
    g1 = rng.uniform(-0.4, 0.5, (C, 9, 9)).astype(np.float32)
    origins = rng.integers(0, data - n + 1, (2, 2)).astype(np.int32)
    w = rng.normal(size=(2, n * n, 5 * C + 2 * PE + 1)).astype(np.float32)
    return g0, g1, origins, w, n


# the quirk only acts at step == 2, so it is switched off there alone
@pytest.mark.parametrize("use_tri_pe", [True, False])
@pytest.mark.parametrize("step,quirk", [(0.25, True), (0.5, True),
                                        (1.0, True), (2.0, True),
                                        (2.0, False)])
def test_decoder_input_and_grad_match_jax(step, quirk, use_tri_pe):
    g0, g1, origins, w, n = _setup(int(step * 8) + 3, step)
    kw = dict(pe_channels=PE, mip_level=2, ndim=2, use_tri_pe=use_tri_pe,
              g1_quirk=quirk)

    def jax_loss(grids):
        x = jax.vmap(lambda o: jsample.decoder_input(
            grids, 0, o, step, n, **kw))(jnp.asarray(origins))
        return jnp.sum(x * w), x

    (_, jx), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        (jnp.asarray(g0), jnp.asarray(g1)))

    tg = (torch.tensor(g0, requires_grad=True),
          torch.tensor(g1, requires_grad=True))
    x = tsample.decoder_input(tg, 0, torch.tensor(origins), step, n, **kw)
    assert x.shape == jx.shape
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), atol=1e-6,
                               rtol=0)
    torch.sum(x * torch.tensor(w)).backward()
    for t, j in zip(tg, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=0)
    # one origin gives one crop's rows
    one = tsample.decoder_input(tg, 0, torch.tensor(origins[1]), step, n,
                                **kw)
    np.testing.assert_array_equal(one.detach().numpy(),
                                  x[1].detach().numpy())


def _setup3(seed, step, sparse):
    rng = np.random.default_rng(seed)
    data = int(round(8 / step))  # the G0 lattice spans 8 cells per axis
    n = data // 2
    g0 = rng.uniform(-0.4, 0.5, (C, 9, 9, 9)).astype(np.float32)
    g1 = rng.uniform(-0.4, 0.5, (C, 5, 5, 5)).astype(np.float32)
    origins = rng.integers(0, data - n + 1, (2, 3)).astype(np.int32)
    feat = C * ((4 if sparse else 8) + 1) + 3 * PE + 1
    w = rng.normal(size=(2, n**3, feat)).astype(np.float32)
    return g0, g1, origins, w, n


def _jax_rows(grids, origins, step, n, kw):
    return jax.vmap(lambda o: jsample.decoder_input(
        grids, 0, o, step, n, **kw))(jnp.asarray(origins))


@pytest.mark.parametrize("method", [3, 4])
@pytest.mark.parametrize("step", [0.25, 0.5, 1.0, 2.0])
def test_decoder_input_3d_and_grad_match_jax(step, method):
    """3D rows [G0 corners | ΣG1 | PE·3 | lod] and both grid gradients; at
    step 2 the G1 corners are summed raw (the quirk)."""
    sparse = method == 4
    use_tri_pe, sparse_g0 = tsample.effective_pe_flags(method, 3, True)
    assert sparse_g0 == sparse and use_tri_pe == (not sparse)
    g0, g1, origins, w, n = _setup3(int(step * 8) + method, step, sparse)
    kw = dict(pe_channels=PE, mip_level=1, ndim=3, use_tri_pe=use_tri_pe,
              sparse_g0=sparse)

    def jax_loss(grids):
        x = _jax_rows(grids, origins, step, n, kw)
        return jnp.sum(x * w), x

    (_, jx), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        (jnp.asarray(g0), jnp.asarray(g1)))
    tg = (torch.tensor(g0, requires_grad=True),
          torch.tensor(g1, requires_grad=True))
    x = tsample.decoder_input(tg, 0, torch.tensor(origins), step, n, **kw)
    assert x.shape == jx.shape
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), atol=1e-6,
                               rtol=0)
    torch.sum(x * torch.tensor(w)).backward()
    for t, j in zip(tg, jgrads):
        # a node of a 16³ crop's grids sums up to ~10³ scattered terms in
        # an order that differs between the packages (and with the thread
        # count): held relative to the gradient's largest value
        j = np.asarray(j, np.float64)
        err = np.abs(t.grad.numpy() - j).max() / np.abs(j).max()
        assert err < 1e-5, err


@pytest.mark.parametrize("ndim", [2, 3])
def test_decoder_input_past_the_grid_raises(ndim):
    """A corner past a grid's last node is an error, where the JAX gather
    reads NaN (2D crops never reach there; 3D mip-mode crops are padded
    for by the trainer, below)."""
    g0 = torch.zeros((C,) + (5,) * ndim)
    g1 = torch.zeros((C,) + (3,) * ndim)
    with pytest.raises(IndexError):
        tsample.decoder_input((g0, g1), 0, torch.full((ndim,), 3), 1.0, 4,
                              pe_channels=PE, mip_level=0, ndim=ndim)


def test_padded_grids_read_zero_past_the_grid():
    """Crops reaching past the grids (3D mip mode cuts every LOD's crops
    from the full-resolution volume): through the trainer's zero padding
    the port reads 0 for a corner past a grid's last node, where the JAX
    gather reads NaN; every row JAX can build is equal, and the padding's
    gradient is cut off."""
    from nic_torch.train.ntc import pad_to_reach

    g0, g1, _, _, _ = _setup3(9, 1.0, False)
    origins = np.array([[0, 0, 0], [6, 2, 7]], np.int32)  # 4³ crops at step 1
    kw = dict(pe_channels=PE, mip_level=0, ndim=3)
    jx = np.asarray(_jax_rows((jnp.asarray(g0), jnp.asarray(g1)), origins,
                              1.0, 4, kw))
    tg = (torch.tensor(g0, requires_grad=True),
          torch.tensor(g1, requires_grad=True))
    padded = pad_to_reach(*tg, torch.tensor(origins), 4, 1.0)
    assert [tuple(g.shape[1:]) for g in padded] == [(12, 12, 12), (7, 7, 7)]
    x = tsample.decoder_input(padded, 0, torch.tensor(origins), 1.0, 4, **kw)
    assert np.isfinite(x.detach().numpy()).all() and np.isnan(jx).any()
    ok = np.isfinite(jx)
    np.testing.assert_allclose(x.detach().numpy()[ok], jx[ok], atol=1e-6,
                               rtol=0)
    assert (x.detach().numpy()[~ok] == 0).any()
    x.sum().backward()
    assert tg[0].grad.shape == g0.shape and tg[1].grad.shape == g1.shape
    # inside the grids the padding changes nothing
    inside = pad_to_reach(*tg, torch.zeros(1, 3, dtype=torch.long), 4, 1.0)
    assert inside[0] is tg[0] and inside[1] is tg[1]


def test_decoder_input_refuses_3d():
    """3D is ported (above); what stays refused is a 3D-only layout in 2D
    (method 4's sparse G0) and other ranks."""
    g = torch.zeros(C, 5, 5, 5)
    x = tsample.decoder_input((g, g), 0, torch.zeros(3, dtype=torch.long),
                              1.0, 4, pe_channels=PE, mip_level=0, ndim=3)
    assert x.shape == (64, 9 * C + 3 * PE + 1)
    g2 = torch.zeros(C, 5, 5)
    with pytest.raises(ValueError, match="3D only"):
        tsample.decoder_input((g2, g2), 0, torch.zeros(2, dtype=torch.long),
                              1.0, 4, pe_channels=PE, mip_level=0,
                              sparse_g0=True)
    with pytest.raises(ValueError, match="ndim"):
        tsample.decoder_input((g, g), 0, torch.zeros(4, dtype=torch.long),
                              1.0, 4, pe_channels=PE, mip_level=0, ndim=4)
