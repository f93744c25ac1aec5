"""nic_torch.kernels.train_fused in 3D (kernel2, K9; K10 is the same
kernel in the port) and the dx and node-gradient kernels widened to the 3D
decoder-input width F = 127, against nic.kernels.train_fused.

The JAX kernels run in Pallas interpret mode on the CPU, one call per
case: K9 (``_impl_ng3``) in fp32·erf and its lane-packed twin K10
(``_impl_ng3_2``) in bf16·poly, whose node tiles JAX's own unfold and
accumulation turn into dG0/dG1 and node volumes; the port runs its
autograd function ``fused_mlp_loss_ng3`` and its plain version, which a
CPU tensor takes. Inputs are numpy-seeded at the JAX suite's kernel2-3D
geometries (C=2, PE 2, H=16, two crops of 8³: f = 2, 4 with method 4's
sparse G0, 4 with one-voxel slab blocks, and 1); the decoder-input rows
are the port's 3D gather (held to JAX's in test_torch_sample.py).
Tolerances as in test_torch_train_fused.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)
from jax.experimental.pallas import tpu as pltpu

from nic.kernels import train_fused as jtf
from nic_torch.grids.sample import decoder_input
from nic_torch.kernels import train_fused as ttf

# (n, step, data_size, crops, rowsb, sparse)
GEOMETRIES = [(8, 0.5, 32, 2, 2, False), (8, 0.25, 32, 2, 4, True),
              (8, 0.25, 32, 2, 1, False), (8, 1.0, 16, 2, 4, False)]
IDS = ["f2", "f4-m4", "f4-rowsb1", "f1"]
MODES = {"fp32-erf": (None, "erf"), "bf16-poly": ("bf16", "poly")}
TOL = {None: dict(loss=1e-6, out=1e-5, grad=1e-5),
       "bf16": dict(loss=1e-4, out=1e-3, grad=1e-2)}
CUDA_TOL = {None: 1e-4, "bf16": 1e-2}
C, PE, H = 2, 2, 16
NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


def _mlp(rng, feat, hidden):
    dims = (feat, hidden, hidden, 3)
    mlp = {}
    for i in range(3):
        b = 1.0 / np.sqrt(dims[i])
        mlp[f"w{i + 1}"] = rng.uniform(-b, b, dims[i:i + 2]).astype(np.float32)
        mlp[f"b{i + 1}"] = rng.uniform(-b, b, dims[i + 1]).astype(np.float32)
    return mlp


def _setup3(seed, n, step, data, crops, sparse, hidden=H, c=C, pe=PE):
    """numpy 3D grids, MLP, origins and targets; x = the port's gather."""
    rng = np.random.default_rng(seed)
    f = int(round(1.0 / step))
    g0n, g1n = int(data * step) + 1, int(data * step / 2) + 1
    g0 = rng.uniform(-0.4, 0.5, (c,) + (g0n,) * 3).astype(np.float32)
    g1 = rng.uniform(-0.4, 0.5, (c,) + (g1n,) * 3).astype(np.float32)
    mlp = _mlp(rng, c * ((4 if sparse else 8) + 1) + 3 * pe + 1, hidden)
    origins = rng.integers(0, data - n + 1, (crops, 3)).astype(np.int32)
    tgt = rng.uniform(0, 1, (crops * n**3, 3)).astype(np.float32)
    x = decoder_input((torch.tensor(g0), torch.tensor(g1)), 0,
                      torch.tensor(origins), step, n, pe_channels=pe,
                      mip_level=0, ndim=3, use_tri_pe=not sparse,
                      sparse_g0=sparse).reshape(crops * n**3, -1).numpy()
    return g0, g1, mlp, origins, tgt, x, f


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _tmd(cd):
    return torch.bfloat16 if cd else None


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_fused_mlp_loss_ng3_matches_jax(geometry, mode):
    """Loss, out, dG0, dG1 and every MLP grad of the port's autograd
    function against JAX's K9 (fp32) or K10 (bf16) through JAX's 3D
    unfold; the port's plain node volumes against JAX's accumulation of
    the same tiles."""
    n, step, data, crops, rowsb, sparse = geometry
    cd, gelu = MODES[mode]
    tol = TOL[cd]
    g0, g1, mlp, origins, tgt, x, f = _setup3(9, n, step, data, crops,
                                              sparse)
    impl = jtf._impl_ng3 if cd is None else jtf._impl_ng3_2
    if cd is not None:
        assert jtf._ng3_packable(n, rowsb, H, x.shape[1], 3)
    jm = {k: jnp.asarray(v) for k, v in mlp.items()}
    jorg = jnp.asarray(origins)
    kw = dict(crops=crops, n=n, rowsb=rowsb, f=f)
    with pltpu.force_tpu_interpret_mode():
        j_loss, j_out, j_gm, dp, dc1 = impl(
            jnp.asarray(x), jnp.asarray(tgt), jorg, *(jm[k] for k in NAMES),
            sparse_g0=sparse, matmul_dtype=jnp.bfloat16 if cd else None,
            gelu=gelu, interpret=True, **kw)
    j_dg0, j_dg1 = jtf._unfold_node_grads_3d(
        dp, dc1, jorg, jm["w1"], sparse_g0=sparse, g0_nodes=g0.shape[1],
        g1_nodes=g1.shape[1], channels=C, **kw)
    j_vols = jtf._accumulate_node_volumes(
        dp, dc1, jorg, g0_nodes=g0.shape[1], g1_nodes=g1.shape[1], hidden=H,
        **kw)

    tg0 = torch.tensor(g0, requires_grad=True)
    tg1 = torch.tensor(g1, requires_grad=True)
    tm = {k: torch.tensor(v, requires_grad=True) for k, v in mlp.items()}
    before = ttf.fused_mlp_loss_ng3_kernel.launches
    loss, out = ttf.fused_mlp_loss_ng3(tg0, tg1, tm, torch.tensor(x),
                                       torch.tensor(tgt),
                                       torch.tensor(origins), n, f, sparse,
                                       _tmd(cd), gelu)
    loss.backward()
    assert ttf.fused_mlp_loss_ng3_kernel.launches == before  # CPU: no launch
    assert abs(float(loss.detach()) - float(j_loss)) / float(j_loss) \
        < tol["loss"]
    assert float(np.abs(out.numpy() - np.asarray(j_out)).max()) < tol["out"]
    assert _rel(tg0.grad, j_dg0) < tol["grad"]
    assert _rel(tg1.grad, j_dg1) < tol["grad"]
    for k in NAMES:
        assert _rel(tm[k].grad, j_gm[k]) < tol["grad"], (k, mode)

    res = ttf.fused_mlp_loss_ng_plain(
        torch.tensor(x), torch.tensor(tgt), torch.tensor(origins),
        *(torch.tensor(mlp[k]) for k in NAMES), n=n, f=f,
        g0_nodes=g0.shape[1], g1_nodes=g1.shape[1], cd=_tmd(cd), gelu=gelu)
    for mine, want in zip(res[8:], j_vols):
        assert mine.shape == want.shape
        assert _rel(mine, np.asarray(want)) < tol["grad"]


def test_node_volume_sums_are_the_formula():
    """The plain node volumes against a voxel-by-voxel loop of the formula
    (cell sums at period f, trilinear node weights at period 2f at the
    absolute coordinate's phase), on origins of every phase."""
    rng = np.random.default_rng(4)
    n, f, crops = 5, 2, 3
    origins = np.array([[0, 0, 0], [1, 3, 2], [6, 5, 7]], np.int32)
    dz1 = rng.normal(size=(crops * n**3, 2)).astype(np.float32)
    g0n, g1n = 8, 5
    pacc, c1acc = ttf._node_sums(torch.tensor(dz1), torch.tensor(origins),
                                 n=n, f=f, g0_nodes=g0n, g1_nodes=g1n)
    want_p = np.zeros((g0n + 1,) * 3 + (2,))
    want_c = np.zeros((g1n + 2,) * 3 + (2,))
    f1 = 2 * f
    for i, org in enumerate(origins):
        for s in range(n):
            for a in range(n):
                for b in range(n):
                    pos = org + (s, a, b)
                    d = dz1[((i * n + s) * n + a) * n + b].astype(np.float64)
                    want_p[tuple(pos // f)] += d
                    u = (pos % f1) / f1
                    for off in np.ndindex(2, 2, 2):
                        w = np.prod([u[k] if off[k] else 1 - u[k]
                                     for k in range(3)])
                        want_c[tuple(pos // f1 + off)] += w * d
    np.testing.assert_allclose(pacc.numpy(), want_p, rtol=0, atol=1e-5)
    np.testing.assert_allclose(c1acc.numpy(), want_c, rtol=0, atol=1e-5)


def test_accumulate_node_volumes_places_windows():
    """Per-crop windows of the CUDA kernel's extents placed into full-grid
    volumes by the port's _accumulate_node_planes equal the plain node
    sums (the wrapper's path on the card, here on the CPU)."""
    rng = np.random.default_rng(8)
    n, f, crops = 8, 2, 3
    origins = np.array([[0, 4, 1], [3, 0, 6], [8, 7, 2]], np.int32)
    dz1 = torch.tensor(rng.normal(size=(crops * n**3, 2)).astype(np.float32))
    g0n, g1n = 9, 5
    ext0, ext1 = ttf._window_extents_3d(n, f)
    want = ttf._node_sums(dz1, torch.tensor(origins), n=n, f=f,
                          g0_nodes=g0n, g1_nodes=g1n)
    # windows cut from each crop's own sums at its anchor
    wp, wc = [], []
    for i in range(crops):
        p, c = ttf._node_sums(dz1[i * n**3:(i + 1) * n**3],
                              torch.tensor(origins[i:i + 1]), n=n, f=f,
                              g0_nodes=g0n, g1_nodes=g1n)
        a0 = origins[i] // f
        a1 = origins[i] // (2 * f)
        wp.append(p[a0[0]:a0[0] + ext0[0], a0[1]:a0[1] + ext0[1],
                    a0[2]:a0[2] + ext0[2]])
        wc.append(c[a1[0]:a1[0] + ext1[0], a1[1]:a1[1] + ext1[1],
                    a1[2]:a1[2] + ext1[2]])
        assert float(p.abs().sum()) == pytest.approx(
            float(wp[-1].abs().sum()), rel=1e-6)  # nothing outside
    got = ttf._accumulate_node_planes(torch.stack(wp), torch.stack(wc),
                                      torch.tensor(origins), f=f,
                                      g0_nodes=g0n, g1_nodes=g1n)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def _wide_mlp_case(seed):
    """A 3D method-3 gather at the protocol's F = 127 (C = 12, PE 6; H=16,
    two crops of 4³ at step 1) → (mlp, x, tgt)."""
    g0, g1, mlp, origins, tgt, x, f = _setup3(seed, 4, 1.0, 8, 2, False,
                                              c=12, pe=6)
    assert x.shape[1] == 127
    return g0, g1, mlp, origins, tgt, x, f


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_mlp_loss_at_f127_matches_jax(mode):
    """K6's plain version at the 3D width F = 127: loss, out, dx and every
    MLP grad of the port's autograd function against JAX's fused_mlp_loss
    (interpret mode), on one 128-row block."""
    cd, gelu = MODES[mode]
    tol = TOL[cd]
    _, _, mlp, _, tgt, x, _ = _wide_mlp_case(5)
    x, tgt = x[:128], tgt[:128]
    jm = {k: jnp.asarray(v) for k, v in mlp.items()}
    with pltpu.force_tpu_interpret_mode():
        (j_loss, j_out), (j_gm, j_dx) = jax.value_and_grad(
            lambda m, xx: jtf.fused_mlp_loss(
                m, xx, jnp.asarray(tgt), jnp.bfloat16 if cd else None, gelu),
            argnums=(0, 1), has_aux=True)(jm, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tm = {k: torch.tensor(v, requires_grad=True) for k, v in mlp.items()}
    loss, out = ttf.fused_mlp_loss(tm, tx, torch.tensor(tgt), _tmd(cd), gelu)
    loss.backward()
    assert abs(float(loss.detach()) - float(j_loss)) / float(j_loss) \
        < tol["loss"]
    assert float(np.abs(out.numpy() - np.asarray(j_out)).max()) < tol["out"]
    assert _rel(tx.grad, j_dx) < tol["grad"]
    for k in NAMES:
        assert _rel(tm[k].grad, j_gm[k]) < tol["grad"], (k, mode)


def test_fused_mlp_loss_ng_at_f127_matches_jax():
    """K7's plain version (2D node planes) at F = 127 (C = 24, PE 3)
    against JAX's K7 (``_impl_ng``, interpret mode): loss, MLP grads and
    the accumulated node planes."""
    rng = np.random.default_rng(12)
    n, step, data, crops, rowsb, c, pe = 8, 0.5, 32, 2, 4, 24, 3
    f = 2
    g0n, g1n = int(data * step) + 1, int(data * step / 2) + 1
    g0 = rng.uniform(-0.4, 0.5, (c, g0n, g0n)).astype(np.float32)
    g1 = rng.uniform(-0.4, 0.5, (c, g1n, g1n)).astype(np.float32)
    mlp = _mlp(rng, 5 * c + 2 * pe + 1, H)
    origins = rng.integers(0, data - n + 1, (crops, 2)).astype(np.int32)
    tgt = rng.uniform(0, 1, (crops * n * n, 3)).astype(np.float32)
    x = decoder_input((torch.tensor(g0), torch.tensor(g1)), 0,
                      torch.tensor(origins), step, n, pe_channels=pe,
                      mip_level=0).reshape(crops * n * n, -1).numpy()
    assert x.shape[1] == 127
    jm = {k: jnp.asarray(v) for k, v in mlp.items()}
    jorg = jnp.asarray(origins)
    kw = dict(crops=crops, ncols=n, rowsb=rowsb, f=f)
    j_loss, _, j_gm, dp, dc1 = jtf._impl_ng(
        jnp.asarray(x), jnp.asarray(tgt), jorg, *(jm[k] for k in NAMES),
        matmul_dtype=None, gelu="erf", interpret=True, **kw)
    planes = jtf._accumulate_node_planes(
        dp, dc1, jorg, g0_nodes=g0n, g1_nodes=g1n, hidden=H, **kw)
    res = ttf.fused_mlp_loss_ng_plain(
        torch.tensor(x), torch.tensor(tgt), torch.tensor(origins),
        *(torch.tensor(mlp[k]) for k in NAMES), n=n, f=f, g0_nodes=g0n,
        g1_nodes=g1n, gelu="erf")
    tol = TOL[None]
    assert abs(float(res[0]) - float(j_loss)) / float(j_loss) < tol["loss"]
    for mine, k in zip(res[2:8], NAMES):
        assert _rel(mine, j_gm[k]) < tol["grad"], k
    for mine, want in zip(res[8:], planes):
        assert mine.shape == want.shape
        assert _rel(mine, np.asarray(want)) < tol["grad"]


@pytest.mark.cuda
def test_k9_kernel_matches_plain_on_cuda():
    """K9 against its plain version on the card at H = 64, F = 127
    (chip_smoke.py holds it at the protocol's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, step, data, crops, _, sparse = GEOMETRIES[1]
    g0, g1, mlp, origins, tgt, x, f = _setup3(6, n, step, data, crops,
                                              sparse, hidden=64, c=12, pe=6)
    dev = "cuda"
    args = [torch.tensor(x, device=dev), torch.tensor(tgt, device=dev),
            torch.tensor(origins)]
    args += [torch.tensor(mlp[k], device=dev) for k in NAMES]
    for cd, gelu in MODES.values():
        kw = dict(n=n, f=f, g0_nodes=g0.shape[1], g1_nodes=g1.shape[1],
                  cd=_tmd(cd), gelu=gelu)
        got = ttf.fused_mlp_loss_ng3_kernel(*args, **kw)
        torch.cuda.synchronize()
        want = ttf.fused_mlp_loss_ng_plain(*args, **kw)
        for a, b in zip(got, want):
            assert _rel(a.cpu(), b.cpu()) < CUDA_TOL[cd]


@pytest.mark.cuda
def test_k6_kernel_at_f127_matches_plain_on_cuda():
    """K6 at F = 127 on the card, on whole and partial 128-row tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, mlp, _, tgt, x, _ = _wide_mlp_case(7)
    dev = "cuda"
    weights = [torch.tensor(mlp[k], device=dev) for k in NAMES]
    x, tgt = torch.tensor(x, device=dev), torch.tensor(tgt, device=dev)
    for npix in (128, 125, 8):
        for cd, gelu in MODES.values():
            kw = dict(cd=_tmd(cd), gelu=gelu)
            got = ttf.fused_mlp_loss_kernel(x[:npix], tgt[:npix], *weights,
                                            **kw)
            torch.cuda.synchronize()
            want = ttf.fused_mlp_loss_plain(x[:npix], tgt[:npix], *weights,
                                            **kw)
            for a, b in zip(got, want):
                assert _rel(a.cpu(), b.cpu()) < CUDA_TOL[cd]
