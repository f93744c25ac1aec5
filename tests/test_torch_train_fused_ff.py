"""nic_torch.kernels.train_fused_ff (kernel3, K11) against
nic.kernels.train_fused_ff.

The JAX kernel runs in Pallas interpret mode on the CPU, as the JAX suite
runs it; the port runs the plain version of its CUDA kernel, which a CPU
tensor takes. Sizes are the JAX suite's (C=4, H=16, PE 2, 2-3 crops of
n = 16) on the three lattice classes f = 4, 2, 1. Tolerances are the
JAX suite's own for its fused paths (tests/test_train_kernel.py): fp32
dots loss rel 1e-5, ``out`` 1e-5 abs, grads rel 1e-4; bf16 dot inputs
loss rel 1e-4, ``out`` 1e-3 abs, grads rel 1e-2 (a last-bit difference
can flip a bf16 rounding of a dot input).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nic.kernels import train_fused_ff as jff
from nic.kernels.train_fused import _accumulate_node_planes as j_accumulate
from nic_torch.kernels import train_fused_ff as tff
from nic_torch.kernels.train_fused import (_accumulate_node_planes,
                                           _window_extents)

# (n, step, data_size, crops, rowsb): f = 4, 2, 1
LATTICES = [(16, 0.25, 64, 2, 8), (16, 0.5, 32, 3, 8), (16, 1.0, 32, 2, 8)]
MODES = {"fp32-erf": (None, "erf"), "bf16-poly": ("bf16", "poly")}
TOL = {None: dict(loss=1e-5, out=1e-5, grad=1e-4),
       "bf16": dict(loss=1e-4, out=1e-3, grad=1e-2)}
C, PE, H = 4, 2, 16
SEED = np.array([12345, -987654321, 0, 0], np.int32)


def _setup(seed, n, step, data, crops, hidden=H, c=C, pe=PE):
    rng = np.random.default_rng(seed)
    f = int(round(1.0 / step))
    g0n, g1n = int(data * step) + 1, int(data * step / 2) + 1
    g0 = rng.uniform(-0.4, 0.5, (c, g0n, g0n)).astype(np.float32)
    g1 = rng.uniform(-0.4, 0.5, (c, g1n, g1n)).astype(np.float32)
    dims = (5 * c + 2 * pe + 1, hidden, hidden, 3)
    mlp = {}
    for i in range(3):
        b = 1.0 / np.sqrt(dims[i])
        mlp[f"w{i + 1}"] = rng.uniform(-b, b, dims[i:i + 2]).astype(np.float32)
        mlp[f"b{i + 1}"] = rng.uniform(-b, b, dims[i + 1]).astype(np.float32)
    origins = rng.integers(0, data - n + 1, (crops, 2)).astype(np.int32)
    tgt = rng.uniform(0, 1, (crops * n * n, 3)).astype(np.float32)
    return g0, g1, mlp, origins, tgt, f


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.mark.parametrize("ctr_base", [0, 2**31 - 4096, 2**32 - 2048])
def test_eps_uniform_bit_exact(ctr_base):
    """The counter hash, bit for bit, for negative stream words and for
    counters on both sides of 2^31 (int32 wrap-around)."""
    rng = np.random.default_rng(ctr_base % 97)
    ctr = (ctr_base + np.arange(8192, dtype=np.int64)) % 2**32
    ctr32 = ctr.astype(np.uint32).view(np.int32)
    for s0, s1 in ((12345, -987654321), (-1, -2**31),
                   tuple(int(v) for v in rng.integers(-2**31, 2**31, 2))):
        for bits in (8, 2):
            want = np.asarray(jff.eps_uniform(
                jnp.asarray(ctr32), jnp.int32(s0), jnp.int32(s1), bits))
            got = tff.eps_uniform(torch.from_numpy(ctr), s0, s1, bits).numpy()
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


def test_ff_geometry_matches_jax():
    for crops in (1, 2, 8):
        for n in (8, 16, 32, 64, 128, 256):
            for rowsb in (2, 4, 8, 16, 32, 64):
                for f in (1, 2, 4, 8):
                    for hidden, pe in ((16, 2), (64, 6), (128, 6), (64, 10)):
                        kw = dict(crops=crops, n=n, rowsb=rowsb, f=f,
                                  hidden=hidden, pe_channels=pe)
                        assert tff.ff_geometry(**kw) == jff.ff_geometry(**kw)


def _jax_impl(g0, g1, mlp, tgt, origins, *, n, rowsb, f, lodf, cd, gelu,
              nbits):
    """The JAX kernel's raw outputs plus its custom-VJP grads (the unfold of
    the same node tiles), from one interpret-mode call."""
    crops = origins.shape[0]
    jm = {k: jnp.asarray(v) for k, v in mlp.items()}
    with pltpu.force_tpu_interpret_mode():
        res = jff._impl_ff(
            jnp.asarray(g0), jnp.asarray(g1), jm["w1"], jm["b1"], jm["w2"],
            jm["b2"], jm["w3"], jm["b3"], jnp.asarray(tgt),
            jnp.asarray(origins), jnp.asarray(SEED), crops=crops, n=n,
            rowsb=rowsb, f=f, npe=PE, lodf=lodf,
            matmul_dtype=jnp.bfloat16 if cd else None, gelu=gelu,
            nbits=nbits)
    (loss, out, dw2, db2, dw3, db3, dpe0, dpe1, db1, dp, dc1, dw1e) = res
    dg0, dg1, dw1 = jff._unfold_ff(
        dp, dc1, jnp.asarray(origins), jnp.asarray(g0), jnp.asarray(g1),
        jm["w1"], db1, dpe0, dpe1, crops=crops, n=n, rowsb=rowsb, f=f,
        npe=PE, lodf=lodf, channels=C)
    if dw1e is not None:
        dw1 = dw1 + dw1e
    planes = j_accumulate(
        dp, dc1, jnp.asarray(origins), crops=crops, ncols=n, rowsb=rowsb,
        f=f, g0_nodes=g0.shape[1], g1_nodes=g1.shape[1], hidden=H)
    grads = {"g0": dg0, "g1": dg1, "w1": dw1, "b1": db1, "w2": dw2,
             "b2": db2, "w3": dw3, "b3": db3}
    return (float(loss), np.asarray(out), {k: np.asarray(v)
                                           for k, v in grads.items()},
            [np.asarray(p) for p in planes], (dp, dc1))


def _jax_windows(tiles, *, crops, n, rowsb, f, g0_nodes, g1_nodes):
    """Each crop's node windows, of the port's extents, from the JAX
    kernel's row-block tiles: JAX's _accumulate_node_planes of one crop's
    tiles placed at origin 0, cut to the window."""
    dp, dc1 = (np.asarray(t) for t in tiles)
    nb = n // rowsb
    rows0, cols0, rows1, cols1 = _window_extents(n, f)
    wins = ([], [])
    for i in range(crops):
        planes = j_accumulate(
            dp[i * nb:(i + 1) * nb], dc1[i * nb:(i + 1) * nb],
            jnp.zeros((1, 2), jnp.int32), crops=1, ncols=n, rowsb=rowsb,
            f=f, g0_nodes=g0_nodes, g1_nodes=g1_nodes, hidden=H)
        wins[0].append(np.asarray(planes[0])[:rows0, :cols0])
        wins[1].append(np.asarray(planes[1])[:rows1, :cols1])
    return tuple(torch.tensor(np.stack(w)) for w in wins)


@pytest.mark.parametrize("noise", [None, 8])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("lattice", LATTICES, ids=["f4", "f2", "f1"])
def test_fused_train_ff_matches_jax(lattice, mode, noise):
    """Loss, out, dG0, dG1 and every MLP grad of the port's autograd
    function (its plain path) against the JAX kernel; then the accumulated
    node planes of the port's plain version against the JAX kernel's
    tiles through JAX's _accumulate_node_planes, and the port's
    _accumulate_node_planes on the per-crop windows of the same tiles."""
    n, step, data, crops, rowsb = lattice
    cd, gelu = MODES[mode]
    tol = TOL[cd]
    g0, g1, mlp, origins, tgt, f = _setup(11, n, step, data, crops)
    assert tff.ff_geometry(crops=crops, n=n, rowsb=rowsb, f=f, hidden=H,
                           pe_channels=PE)
    kw = dict(n=n, rowsb=rowsb, f=f, lodf=1.0, cd=cd, gelu=gelu, nbits=noise)
    j_loss, j_out, j_grads, j_planes, j_tiles = _jax_impl(
        g0, g1, mlp, tgt, origins, **kw)

    tcd = torch.bfloat16 if cd else None
    tg0 = torch.tensor(g0, requires_grad=True)
    tg1 = torch.tensor(g1, requires_grad=True)
    tm = {k: torch.tensor(v, requires_grad=True) for k, v in mlp.items()}
    loss, out = tff.fused_train_ff(
        tg0, tg1, tm, torch.tensor(tgt), torch.tensor(origins),
        torch.tensor(SEED), n, f, PE, 1.0, tcd, gelu, noise)
    loss.backward()
    assert abs(float(loss.detach()) - j_loss) / j_loss < tol["loss"]
    assert float(np.abs(out.numpy() - j_out).max()) < tol["out"]
    got = {"g0": tg0.grad, "g1": tg1.grad, **{k: v.grad for k, v in tm.items()}}
    for k, want in j_grads.items():
        assert _rel(got[k].numpy(), want) < tol["grad"], (k, mode, noise)

    # the node planes: plain version vs JAX tiles accumulated by both
    # packages' _accumulate_node_planes
    p_plane, c1_plane = tff.fold_planes(torch.tensor(g0), torch.tensor(g1),
                                        torch.tensor(mlp["w1"]), tcd)
    res = tff.fused_train_ff_plain(
        p_plane, c1_plane, *(torch.tensor(mlp[k]) for k in
                             ("w1", "b1", "w2", "b2", "w3", "b3")),
        torch.tensor(tgt), torch.tensor(origins), torch.tensor(SEED), n=n,
        f=f, npe=PE, lodf=1.0, cd=tcd, gelu=gelu, nbits=noise)
    windows = _jax_windows(j_tiles, crops=crops, n=n, rowsb=rowsb, f=f,
                           g0_nodes=g0.shape[1], g1_nodes=g1.shape[1])
    ported = _accumulate_node_planes(*windows, torch.tensor(origins), f=f,
                                     g0_nodes=g0.shape[1],
                                     g1_nodes=g1.shape[1])
    for mine, acc, want in zip(res[9:11], ported, j_planes):
        assert mine.shape == want.shape
        np.testing.assert_allclose(acc.numpy(), want, rtol=0, atol=1e-7)
        assert _rel(mine.numpy(), want) < tol["grad"]


def test_fused_train_ff_feature_noise_stream():
    """Same seed → identical loss; another seed → another loss; frozen
    grids (no grad) still give every MLP grad."""
    n, step, data, crops, _ = LATTICES[0]
    g0, g1, mlp, origins, tgt, f = _setup(3, n, step, data, crops)
    args = (torch.tensor(g0), torch.tensor(g1),
            {k: torch.tensor(v, requires_grad=True) for k, v in mlp.items()},
            torch.tensor(tgt), torch.tensor(origins))
    losses = [float(tff.fused_train_ff(*args, torch.tensor(s), n, f, PE, 0.0,
                                       None, "poly", 8)[0].detach())
              for s in (SEED, SEED, np.array([7, 8, 0, 0], np.int32))]
    assert losses[0] == losses[1] != losses[2]
    loss, _ = tff.fused_train_ff(*args, torch.tensor(SEED), n, f, PE, 0.0,
                                 None, "poly", 8)
    loss.backward()
    assert all(torch.isfinite(v.grad).all() for v in args[2].values())


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """The CUDA kernel against its plain version on the card, at the
    kernel's width H = 64 (chip_smoke.py holds it at the flagship shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, step, data, crops, _ = LATTICES[0]
    g0, g1, mlp, origins, tgt, f = _setup(5, n, step, data, crops,
                                          hidden=64, c=12, pe=6)
    dev = "cuda"
    p, c1 = tff.fold_planes(torch.tensor(g0, device=dev),
                            torch.tensor(g1, device=dev),
                            torch.tensor(mlp["w1"], device=dev))
    args = [p, c1] + [torch.tensor(mlp[k], device=dev) for k in
                      ("w1", "b1", "w2", "b2", "w3", "b3")]
    args += [torch.tensor(tgt, device=dev), torch.tensor(origins),
             torch.tensor(SEED)]
    for cd, gelu, noise in ((None, "erf", None), (torch.bfloat16, "poly", 8)):
        kw = dict(n=n, f=f, npe=6, lodf=0.0, cd=cd, gelu=gelu, nbits=noise)
        got = tff.fused_train_ff_kernel(*args, **kw)
        torch.cuda.synchronize()
        want = tff.fused_train_ff_plain(*args, **kw)
        tol = TOL[None if cd is None else "bf16"]["grad"]
        for a, b in zip(got, want):
            if b is not None:
                assert _rel(a.cpu().numpy(), b.cpu().numpy()) < tol
