"""nic_torch.kernels.train_fused (K6, the dx kernel; K7, kernel2) against
nic.kernels.train_fused.

The JAX kernels run on the CPU as the JAX suite runs them:
``fused_mlp_loss`` and ``fused_mlp_loss_ng`` (which dispatches to the
lane-packed K8) under ``pltpu.force_tpu_interpret_mode()``, and K7
(``_impl_ng``) and K8 (``_impl_ng2``) called directly with
``interpret=True``; to keep the file cheap, each kernel2 case makes two
JAX kernel calls: fp32 the custom VJP (K8) and K7, bf16 K8 directly. The
port runs the plain versions of its CUDA kernels, which a CPU tensor
takes, and its autograd functions. Inputs come from numpy (grids, MLP,
origins, targets); the decoder-input rows are the port's gather of those
grids (held to JAX's in test_torch_sample.py), handed to both. Sizes and
geometries are the JAX suite's kernel2 cases (C=4, PE 2, H=16; f = 2, 4,
1).

Tolerances. fp32 dots: the JAX suite's own for kernel2 (loss rel 1e-6,
``out`` 1e-5 abs, dG0/dG1 and MLP grads rel 1e-5). bf16 dot inputs: loss
rel 1e-4, ``out`` 1e-3 abs, grads rel 1e-2, as for K11: the two packages
sum in different orders, and a last-bit difference in an fp32 sum can
flip the bf16 rounding of a dot input (2^-9 relative).
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

# (n, step, data_size, crops, rowsb): f = 2, 4, 1
GEOMETRIES = [(8, 0.5, 32, 3, 4), (16, 0.25, 64, 2, 8), (16, 1.0, 32, 2, 8)]
MODES = {"fp32-erf": (None, "erf"), "bf16-poly": ("bf16", "poly")}
TOL = {None: dict(loss=1e-6, out=1e-5, grad=1e-5),
       "bf16": dict(loss=1e-4, out=1e-3, grad=1e-2)}
# kernel vs plain on the card: K11's limits (chip_smoke.py), grads rel
CUDA_TOL = {None: 1e-4, "bf16": 1e-2}
C, PE, H = 4, 2, 16
NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


def _setup(seed, n, step, data, crops, hidden=H, c=C, pe=PE):
    """numpy grids, MLP, origins and targets; x = the gather of them."""
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

    x = decoder_input((torch.tensor(g0), torch.tensor(g1)), 0,
                      torch.tensor(origins), step, n, pe_channels=pe,
                      mip_level=0).reshape(crops * n * n, -1).numpy()
    return g0, g1, mlp, origins, tgt, x, f


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _jmd(cd):
    return jnp.bfloat16 if cd else None


def _tmd(cd):
    return torch.bfloat16 if cd else None


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["f2", "f4", "f1"])
def test_fused_mlp_loss_ng_matches_jax(geometry, mode):
    """Loss, out, dG0, dG1 and every MLP grad of the port's autograd
    function (its plain K7) against JAX's: the custom VJP (K8, interpret
    mode) in fp32, K8's raw outputs through JAX's unfold in bf16; then the
    port's node planes and MLP grads against the raw outputs of K7 (fp32)
    or K8 (bf16), accumulated by JAX's _accumulate_node_planes."""
    n, step, data, crops, rowsb = geometry
    cd, gelu = MODES[mode]
    tol = TOL[cd]
    g0, g1, mlp, origins, tgt, x, f = _setup(7, n, step, data, crops)
    jm = {k: jnp.asarray(v) for k, v in mlp.items()}
    jx, jtgt, jorg = jnp.asarray(x), jnp.asarray(tgt), jnp.asarray(origins)

    kw = dict(crops=crops, ncols=n, rowsb=rowsb, f=f)
    raw = {}
    if cd is None:
        def ng_loss(g0g1, m):
            return jtf.fused_mlp_loss_ng(g0g1[0], g0g1[1], m, jx, jtgt, jorg,
                                         crops, n, rowsb, f, None, gelu)

        with pltpu.force_tpu_interpret_mode():
            (j_loss, j_out), ((j_dg0, j_dg1), j_gm) = jax.value_and_grad(
                ng_loss, argnums=(0, 1), has_aux=True)(
                    (jnp.asarray(g0), jnp.asarray(g1)), jm)
        impls = (jtf._impl_ng,)
    else:
        impls = (jtf._impl_ng2,)
    for impl in impls:
        raw[impl.__name__] = impl(
            jx, jtgt, jorg, *(jm[k] for k in NAMES), matmul_dtype=_jmd(cd),
            gelu=gelu, interpret=True, **kw)
    if cd is not None:
        j_loss, j_out, j_gm, dp, dc1 = raw["_impl_ng2"]
        j_dg0, j_dg1 = jtf._unfold_node_grads(
            dp, dc1, jorg, jm["w1"], g0_nodes=g0.shape[1:],
            g1_nodes=g1.shape[1:], channels=C, **kw)

    tg0 = torch.tensor(g0, requires_grad=True)
    tg1 = torch.tensor(g1, requires_grad=True)
    tm = {k: torch.tensor(v, requires_grad=True) for k, v in mlp.items()}
    loss, out = ttf.fused_mlp_loss_ng(tg0, tg1, tm, torch.tensor(x),
                                      torch.tensor(tgt), torch.tensor(origins),
                                      n, f, _tmd(cd), gelu)
    loss.backward()
    assert abs(float(loss.detach()) - float(j_loss)) / float(j_loss) \
        < tol["loss"]
    assert float(np.abs(out.numpy() - np.asarray(j_out)).max()) < tol["out"]
    assert _rel(tg0.grad, j_dg0) < tol["grad"]
    assert _rel(tg1.grad, j_dg1) < tol["grad"]
    for k in NAMES:
        assert _rel(tm[k].grad, j_gm[k]) < tol["grad"], (k, mode)

    # the raw kernel outputs: K7 and K8 node tiles → planes
    res = ttf.fused_mlp_loss_ng_plain(
        torch.tensor(x), torch.tensor(tgt), torch.tensor(origins),
        *(torch.tensor(mlp[k]) for k in NAMES), n=n, f=f,
        g0_nodes=g0.shape[1], g1_nodes=g1.shape[1], cd=_tmd(cd), gelu=gelu)
    for name, (j_l, _, j_g, dp, dc1) in raw.items():
        planes = jtf._accumulate_node_planes(
            dp, dc1, jorg, g0_nodes=g0.shape[1], g1_nodes=g1.shape[1],
            hidden=H, **kw)
        assert abs(float(res[0]) - float(j_l)) / float(j_l) < tol["loss"]
        for mine, want in zip(res[2:8], (j_g[k] for k in NAMES)):
            assert _rel(mine, want) < tol["grad"], (name, mode)
        for mine, want in zip(res[8:], planes):
            assert mine.shape == want.shape
            assert _rel(mine, want) < tol["grad"], (name, mode)


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_mlp_loss_matches_jax(mode):
    """K6: loss, out, dx and every MLP grad of the port's autograd function
    (its plain version) against JAX's fused_mlp_loss (interpret mode), on
    the gather's features at the f = 4 geometry."""
    cd, gelu = MODES[mode]
    tol = TOL[cd]
    _, _, mlp, _, tgt, x, _ = _setup(5, *GEOMETRIES[1][:4])
    jm = {k: jnp.asarray(v) for k, v in mlp.items()}
    with pltpu.force_tpu_interpret_mode():
        (j_loss, j_out), (j_gm, j_dx) = jax.value_and_grad(
            lambda m, xx: jtf.fused_mlp_loss(m, xx, jnp.asarray(tgt),
                                             _jmd(cd), gelu),
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


def test_node_sums_are_the_formula():
    """The plain K7 node planes against a pixel-by-pixel loop of the
    formula (cell sums at period f, bilinear node weights at period 2f at
    the absolute coordinate's phase), on origins of every phase."""
    rng = np.random.default_rng(3)
    n, f, crops = 6, 2, 4
    origins = np.array([[0, 0], [1, 3], [2, 5], [7, 6]], np.int32)
    dz1 = rng.normal(size=(crops * n * n, 2)).astype(np.float32)
    g0n, g1n = 10, 6
    pacc, c1acc = ttf._node_sums(torch.tensor(dz1), torch.tensor(origins),
                                 n=n, f=f, g0_nodes=g0n, g1_nodes=g1n)
    want_p = np.zeros((g0n + 1, g0n + 1, 2))
    want_c = np.zeros((g1n + 2, g1n + 2, 2))
    for i, (o0, o1) in enumerate(origins):
        for r in range(n):
            for c in range(n):
                y, x = o0 + r, o1 + c
                d = dz1[(i * n + r) * n + c].astype(np.float64)
                want_p[y // f, x // f] += d
                u, v = (y % (2 * f)) / (2 * f), (x % (2 * f)) / (2 * f)
                for a, wr in ((0, 1 - u), (1, u)):
                    for b, wc in ((0, 1 - v), (1, v)):
                        node = (y // (2 * f) + a, x // (2 * f) + b)
                        want_c[node] += wr * wc * d
    np.testing.assert_allclose(pacc.numpy(), want_p, rtol=0, atol=1e-5)
    np.testing.assert_allclose(c1acc.numpy(), want_c, rtol=0, atol=1e-5)


def _cuda_case(seed):
    """Flagship widths (C=12, PE 6, H=64) at the f = 4 geometry."""
    g0, g1, mlp, origins, tgt, x, f = _setup(seed, *GEOMETRIES[1][:4],
                                             hidden=64, c=12, pe=6)
    dev = "cuda"
    args = [torch.tensor(x, device=dev), torch.tensor(tgt, device=dev)]
    weights = [torch.tensor(mlp[k], device=dev) for k in NAMES]
    return g0, g1, args, weights, torch.tensor(origins), f


@pytest.mark.cuda
def test_k6_kernel_matches_plain_on_cuda():
    """The dx kernel against its plain version on the card (chip_smoke.py
    holds it at the path's shapes), on whole 128-pixel tiles and on a
    last tile of 125 pixels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, (x, tgt), weights, _, _ = _cuda_case(5)
    for npix in (x.shape[0], x.shape[0] - 3):
        for cd, gelu in MODES.values():
            kw = dict(cd=_tmd(cd), gelu=gelu)
            got = ttf.fused_mlp_loss_kernel(x[:npix], tgt[:npix], *weights,
                                            **kw)
            torch.cuda.synchronize()
            want = ttf.fused_mlp_loss_plain(x[:npix], tgt[:npix], *weights,
                                            **kw)
            for a, b in zip(got, want):
                assert _rel(a.cpu(), b.cpu()) < CUDA_TOL[cd]


@pytest.mark.cuda
def test_k7_kernel_matches_plain_on_cuda():
    """The node-gradient kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g0, g1, (x, tgt), weights, origins, f = _cuda_case(6)
    n = GEOMETRIES[1][0]
    for cd, gelu in MODES.values():
        kw = dict(n=n, f=f, g0_nodes=g0.shape[1], g1_nodes=g1.shape[1],
                  cd=_tmd(cd), gelu=gelu)
        got = ttf.fused_mlp_loss_ng_kernel(x, tgt, origins, *weights, **kw)
        torch.cuda.synchronize()
        want = ttf.fused_mlp_loss_ng_plain(x, tgt, origins, *weights, **kw)
        for a, b in zip(got, want):
            assert _rel(a.cpu(), b.cpu()) < CUDA_TOL[cd]
