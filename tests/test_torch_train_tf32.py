"""A numeric model, in torch on the CPU, of the fp32-dot train step that
K11's and K12's tensor-core bodies take as three TF32 products
(``ff_pixel_tf32``, ``ff3_pixel_tf32``: csrc/train_common.cuh
``ff_tail_mma`` with ``TailTf32`` and ``noise_tf32``).

In the bodies ε·W1, z2 = h1·W2, dh1 = dz2·W2ᵀ and dW2 = h1ᵀ·dz2 are each
three TF32 products of the operands' hi and lo parts (al·bh + ah·bl +
ah·bh, al·bl dropped; ``dot3`` of test_torch_decode_tf32.py models
them), while the 64 → 3 layer with its two backward products, and εᵀ·dz1
(part D, ``ff_epsgrad``), stay fp32 on the CUDA cores. The model is the
port's plain version of each step (``fused_train_ff_plain``,
``fused_train_ff3_plain``, which the autograd functions run on the CPU)
with its dot, ``_CdDot``, replaced by :class:`_Tf32Dot`, which takes
those products so.

The model holds, within fp32-dot mode's limits (the JAX suite's: loss
rel 1e-5, out 1e-5 abs, grads rel 1e-4):
- JAX's fp32 kernels, ``_impl_ff`` and ``_impl_ff3`` in Pallas interpret
  mode as the JAX suite runs them, one call each, through the port's
  autograd functions: 2 crops of 16² (C = 4, PE 2) and 2 crops of 8³
  (C = 2, PE 2), F = 25, H = 64, feature noise on;
- the port's plain versions at the flagship widths: K11 at F = 73 (C =
  12, PE 6) on 2 crops of 32², K12 at F = 127 on 4 crops of 8³, H = 64,
  numpy-seeded, with noise: loss, out, every MLP and PE grad, the node
  planes or volumes and εᵀ·dz1.

One TF32 product a dot (the operands rounded to TF32, no lo parts) is
modelled too, on the same flagship inputs: it misses those limits, which
is why the bodies take three.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)
from jax.experimental.pallas import tpu as pltpu
from test_torch_decode_tf32 import dot3, tf32

from nic.kernels import train_fused_ff as jff
from nic.kernels import train_fused_ff3 as jff3
from nic_torch.kernels import train_fused_ff as tff
from nic_torch.kernels import train_fused_ff3 as tff3

TOL = dict(loss=1e-5, out=1e-5, grad=1e-4)  # fp32-dot mode's limits
H = 64
SEED = np.array([12345, -987654321, 0, 0], np.int32)
NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


def dot1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b as one TF32 product (both operands rounded to TF32), summed in
    float64 and returned in fp32."""
    return (tf32(a).double() @ tf32(b).double()).float()


def _tf32_dot(product):
    """A stand-in for ``_CdDot`` (fp32 dots only) whose products over the
    hidden width (ε·W1, h1·W2 and, in the backward, dz2·W2ᵀ and h1ᵀ·dz2)
    are ``product`` and whose 64 → 3 layer and εᵀ·dz1 are fp32."""

    class _Tf32Dot(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, w, cd):
            assert cd is None, "the model is of fp32-dot mode"
            ctx.save_for_backward(a, w)
            return a @ w if w.shape[1] == 3 else product(a, w)

        @staticmethod
        def backward(ctx, g):
            a, w = ctx.saved_tensors
            if w.shape[1] == 3:          # the 64 -> 3 layer: CUDA cores
                return g @ w.T, a.T @ g, None
            if not ctx.needs_input_grad[0]:  # ε·W1: εᵀ·dz1 is part D
                return None, a.T @ g, None
            return product(g, w.T), product(a.T, g), None

    return _Tf32Dot


@pytest.fixture
def model(monkeypatch):
    """Installs the model's dot in both plain steps: ``model(product)``."""
    def install(product):
        for mod in (tff, tff3):
            monkeypatch.setattr(mod, "_CdDot", _tf32_dot(product))
    return install


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _mlp(rng, nfeat):
    dims = (nfeat, H, H, 3)
    mlp = {}
    for i in range(3):
        b = 1.0 / np.sqrt(dims[i])
        mlp[f"w{i + 1}"] = rng.uniform(-b, b, dims[i:i + 2]).astype(np.float32)
        mlp[f"b{i + 1}"] = rng.uniform(-b, b, dims[i + 1]).astype(np.float32)
    return mlp


def _setup(seed, nd, n, step, data, crops, c, pe):
    """numpy grids of ``nd`` dimensions, an MLP of H = 64 over F = (5 or 9)
    C + nd PE + 1 features (2D, or 3D with dense G0), origins and
    targets of crops of n^nd pixels on the lattice of period 1/step."""
    rng = np.random.default_rng(seed)
    g0n, g1n = int(data * step) + 1, int(data * step / 2) + 1
    g0 = rng.uniform(-0.4, 0.5, (c,) + (g0n,) * nd).astype(np.float32)
    g1 = rng.uniform(-0.4, 0.5, (c,) + (g1n,) * nd).astype(np.float32)
    mlp = _mlp(rng, (5 if nd == 2 else 9) * c + nd * pe + 1)
    origins = rng.integers(0, data - n + 1, (crops, nd)).astype(np.int32)
    tgt = rng.uniform(0, 1, (crops * n**nd, 3)).astype(np.float32)
    return g0, g1, mlp, origins, tgt, int(round(1.0 / step))


def _check(got_loss, got_out, got, want_loss, want_out, want, tag):
    assert abs(got_loss - want_loss) / want_loss < TOL["loss"], tag
    assert float(np.abs(got_out - want_out).max()) < TOL["out"], tag
    for k, w in want.items():
        assert _rel(got[k], w) < TOL["grad"], (tag, k, _rel(got[k], w))


def _autograd(fn, g0, g1, mlp, tgt, origins, *args):
    """(loss, out, grads) of a port autograd function on the CPU."""
    tg0 = torch.tensor(g0, requires_grad=True)
    tg1 = torch.tensor(g1, requires_grad=True)
    tm = {k: torch.tensor(v, requires_grad=True) for k, v in mlp.items()}
    loss, out = fn(tg0, tg1, tm, torch.tensor(tgt), torch.tensor(origins),
                   torch.tensor(SEED), *args)
    loss.backward()
    grads = {"g0": tg0.grad, "g1": tg1.grad,
             **{k: v.grad for k, v in tm.items()}}
    return (float(loss.detach()), out.detach().numpy(),
            {k: v.numpy() for k, v in grads.items()})


def test_k11_model_holds_jax_fp32(model):
    """K11: 2 crops of 16² at f = 4, F = 25, noise on: the model through
    the port's autograd function against JAX's fp32 ``_impl_ff`` and its
    unfold."""
    n, rowsb, crops, pe = 16, 8, 2, 2
    g0, g1, mlp, origins, tgt, f = _setup(21, 2, n, 0.25, 64, crops, 4, pe)
    assert tff.ff_geometry(crops=crops, n=n, rowsb=rowsb, f=f, hidden=H,
                           pe_channels=pe)
    jm = {k: jnp.asarray(v) for k, v in mlp.items()}
    jorg = jnp.asarray(origins)
    with pltpu.force_tpu_interpret_mode():
        (loss, out, dw2, db2, dw3, db3, dpe0, dpe1, db1, dp, dc1,
         dw1e) = jff._impl_ff(
            jnp.asarray(g0), jnp.asarray(g1), *(jm[k] for k in NAMES),
            jnp.asarray(tgt), jorg, jnp.asarray(SEED), crops=crops, n=n,
            rowsb=rowsb, f=f, npe=pe, lodf=1.0, matmul_dtype=None,
            gelu="erf", nbits=8)
    dg0, dg1, dw1 = jff._unfold_ff(
        dp, dc1, jorg, jnp.asarray(g0), jnp.asarray(g1), jm["w1"], db1, dpe0,
        dpe1, crops=crops, n=n, rowsb=rowsb, f=f, npe=pe, lodf=1.0,
        channels=4)
    want = {"g0": dg0, "g1": dg1, "w1": dw1 + dw1e, "b1": db1, "w2": dw2,
            "b2": db2, "w3": dw3, "b3": db3}
    model(dot3)
    got = _autograd(tff.fused_train_ff, g0, g1, mlp, tgt, origins, n, f, pe,
                    1.0, None, "erf", 8)
    _check(*got, float(loss), np.asarray(out),
           {k: np.asarray(v) for k, v in want.items()}, "K11 vs JAX")


def test_k12_model_holds_jax_fp32(model):
    """K12: 2 crops of 8³ at f = 4 (dense G0, triangular PE), F = 25,
    noise on: the model through the port's autograd function against
    JAX's fp32 ``_impl_ff3`` and its unfold."""
    n, rowsb, crops, pe = 8, 4, 2, 2
    g0, g1, mlp, origins, tgt, f = _setup(23, 3, n, 0.25, 32, crops, 2, pe)
    assert mlp["w1"].shape[0] == 25
    jm = {k: jnp.asarray(v) for k, v in mlp.items()}
    jorg = jnp.asarray(origins)
    kw = dict(crops=crops, n=n, rowsb=rowsb, f=f)
    with pltpu.force_tpu_interpret_mode():
        (loss, out, dw2, db2, dw3, db3, dpe0, dpe1, dpe2, db1, dp, dc1,
         dw1e) = jff3._impl_ff3(
            jnp.asarray(g0), jnp.asarray(g1), *(jm[k] for k in NAMES),
            jnp.asarray(tgt), jorg, jnp.asarray(SEED[:3]), npe=pe, lodf=1.0,
            sparse_g0=False, use_tri_pe=True, matmul_dtype=None, gelu="erf",
            interpret=True, nbits=8, **kw)
    dg0, dg1, dw1 = jff3._unfold_ff3(
        dp, dc1, jorg, jnp.asarray(g0), jnp.asarray(g1), jm["w1"], db1, dpe0,
        dpe1, dpe2, npe=pe, lodf=1.0, sparse_g0=False, channels=2, **kw)
    want = {"g0": dg0, "g1": dg1, "w1": dw1 + dw1e, "b1": db1, "w2": dw2,
            "b2": db2, "w3": dw3, "b3": db3}
    model(dot3)
    got = _autograd(tff3.fused_train_ff3, g0, g1, mlp, tgt, origins, n, f,
                    pe, 1.0, False, True, None, "erf", 8)
    _check(*got, float(loss), np.asarray(out),
           {k: np.asarray(v) for k, v in want.items()}, "K12 vs JAX")


# the flagship cells: K11 2 crops of 32² at f = 4 (F = 73), K12 4 crops of
# 8³ at f = 4 (F = 127); C = 12, PE 6, H = 64, noise on
FLAGSHIP = {"k11": (2, 32, 0.25, 128, 2), "k12": (3, 8, 0.25, 32, 4)}


def _flagship_step(kind, product, model):
    """The plain step at the flagship widths, with the model's dot when
    ``product`` is given → its outputs as numpy (None dropped)."""
    nd, n, step, data, crops = FLAGSHIP[kind]
    g0, g1, mlp, origins, tgt, f = _setup(31 + nd, nd, n, step, data, crops,
                                          12, 6)
    assert crops * n**nd >= 2048
    assert mlp["w1"].shape[0] == (73 if nd == 2 else 127)
    t = {k: torch.tensor(v) for k, v in mlp.items()}
    if product is not None:
        model(product)
    with torch.no_grad():
        if nd == 2:
            planes = tff.fold_planes(torch.tensor(g0), torch.tensor(g1),
                                     t["w1"])
            res = tff.fused_train_ff_plain(
                *planes, *(t[k] for k in NAMES), torch.tensor(tgt),
                torch.tensor(origins), torch.tensor(SEED), n=n, f=f, npe=6,
                lodf=0.5, cd=None, gelu="erf", nbits=8)
        else:
            vols = tff3.fold_volumes(torch.tensor(g0), torch.tensor(g1),
                                     t["w1"], False, None)
            res = tff3.fused_train_ff3_plain(
                *vols, *(t[k] for k in NAMES), torch.tensor(tgt),
                torch.tensor(origins), torch.tensor(SEED), n=n, f=f, npe=6,
                lodf=0.5, sparse_g0=False, use_tri_pe=True, cd=None,
                gelu="erf", nbits=8)
    return [r.numpy() for r in res if r is not None]


def _errors(got, want) -> dict:
    """{loss rel, out max|Δ|, worst grad rel} of a step's outputs."""
    return {"loss": _rel(got[0], want[0]),
            "out": float(np.abs(got[1] - want[1]).max()),
            "grad": max(_rel(a, b) for a, b in zip(got[2:], want[2:]))}


@pytest.mark.parametrize("kind", list(FLAGSHIP))
def test_flagship_model_holds_plain(kind, model, monkeypatch):
    """At the flagship widths the three-product model holds the plain
    version (fp32 dots) to fp32-dot mode's limits, and the one-product
    model does not: it misses the grads' limit."""
    want = _flagship_step(kind, None, model)
    three = _errors(_flagship_step(kind, dot3, model), want)
    one = _errors(_flagship_step(kind, dot1, model), want)
    print(f"{kind} at the flagship widths, model vs plain: 3xTF32 {three}; "
          f"1xTF32 {one}")
    for k, tol in TOL.items():
        assert three[k] < tol, (kind, k, three)
    assert one["grad"] > TOL["grad"], (kind, one)
