"""nic_torch.kernels.train_fused_ff3 (kernel3 in 3D, K12) against
nic.kernels.train_fused_ff3.

The JAX kernel runs in Pallas interpret mode on the CPU (one call per
case: its raw outputs, then JAX's own unfold and node-volume accumulation
of them); the port runs its autograd function, whose CPU path is the
plain version of the CUDA kernel. Geometries are the JAX suite's
(tests/test_train_kernel.py: C=2, PE 2, H=16, two crops of 8³; f = 4, 2,
1, method 4's sparse G0 with sinusoidal PE, and slab blocks smaller than
a cell), each in fp32·erf without noise and bf16·poly with the in-kernel
feature noise. Tolerances as for K11 (test_torch_train_fused_ff.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)
from jax.experimental.pallas import tpu as pltpu

from nic.kernels import train_fused as jtf
from nic.kernels import train_fused_ff as jff
from nic.kernels import train_fused_ff3 as jff3
from nic_torch.grids.sample import decoder_input
from nic_torch.kernels import train_fused_ff3 as tff3
from nic_torch.models.mlp import apply_mlp

# (n, step, data_size, crops, rowsb, sparse)
GEOMETRIES = [(8, 0.25, 32, 2, 4, False), (8, 0.25, 32, 2, 4, True),
              (8, 0.5, 32, 2, 2, False), (8, 1.0, 16, 2, 4, False),
              (8, 0.25, 32, 2, 2, False)]
IDS = ["f4", "f4-m4", "f2", "f1", "f4-rowsb2"]
MODES = {"fp32-erf": (None, "erf", None), "bf16-poly-noise": ("bf16", "poly",
                                                              8)}
TOL = {None: dict(loss=1e-5, out=1e-5, grad=1e-4),
       "bf16": dict(loss=1e-4, out=1e-3, grad=1e-2)}
C, PE, H = 2, 2, 16
SEED = np.array([12345, -987654321, 0, 0], np.int32)
NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


def _setup(seed, n, step, data, crops, sparse, hidden=H, c=C, pe=PE):
    rng = np.random.default_rng(seed)
    f = int(round(1.0 / step))
    g0n, g1n = int(data * step) + 1, int(data * step / 2) + 1
    g0 = rng.uniform(-0.4, 0.5, (c,) + (g0n,) * 3).astype(np.float32)
    g1 = rng.uniform(-0.4, 0.5, (c,) + (g1n,) * 3).astype(np.float32)
    dims = (c * ((4 if sparse else 8) + 1) + 3 * pe + 1, hidden, hidden, 3)
    mlp = {}
    for i in range(3):
        b = 1.0 / np.sqrt(dims[i])
        mlp[f"w{i + 1}"] = rng.uniform(-b, b, dims[i:i + 2]).astype(np.float32)
        mlp[f"b{i + 1}"] = rng.uniform(-b, b, dims[i + 1]).astype(np.float32)
    origins = rng.integers(0, data - n + 1, (crops, 3)).astype(np.int32)
    tgt = rng.uniform(0, 1, (crops * n**3, 3)).astype(np.float32)
    return g0, g1, mlp, origins, tgt, f


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def test_ff3_geometry_and_slab_rows_match_jax():
    for crops in (1, 2, 8):
        for n in (1, 2, 4, 8, 16, 32, 64):
            for rowsb in (1, 2, 4, 8, 16):
                for f in (1, 2, 4, 8):
                    for hidden, pe, nfeat in ((16, 2, 0), (64, 6, 127),
                                              (64, 6, 79), (64, 10, 0)):
                        kw = dict(crops=crops, n=n, rowsb=rowsb, f=f,
                                  hidden=hidden, pe_channels=pe, nfeat=nfeat)
                        assert tff3.ff3_geometry(**kw) == \
                            jff3.ff3_geometry(**kw), kw
            # the JAX trainer's slab block (nic/train/ntc.py, kernel3-3d)
            cap = jtf.pick_block_rows(crops * n**3)
            want = None if cap is None else min(max(cap // (n * n), 1), n)
            assert tff3.slab_rows(crops, n) == want


def _jax_ff3(g0, g1, mlp, tgt, origins, *, n, rowsb, f, sparse, cd, gelu,
             nbits):
    """One interpret-mode call of the JAX kernel → (loss, out, grads,
    accumulated node volumes)."""
    crops = origins.shape[0]
    jm = {k: jnp.asarray(v) for k, v in mlp.items()}
    jorg = jnp.asarray(origins)
    with pltpu.force_tpu_interpret_mode():
        res = jff3._impl_ff3(
            jnp.asarray(g0), jnp.asarray(g1), *(jm[k] for k in NAMES),
            jnp.asarray(tgt), jorg, jnp.asarray(SEED[:3]), crops=crops, n=n,
            rowsb=rowsb, f=f, npe=PE, lodf=1.0, sparse_g0=sparse,
            use_tri_pe=not sparse,
            matmul_dtype=jnp.bfloat16 if cd else None, gelu=gelu,
            interpret=True, nbits=nbits)
    (loss, out, dw2, db2, dw3, db3, dpe0, dpe1, dpe2, db1, dp, dc1,
     dw1e) = res
    dg0, dg1, dw1 = jff3._unfold_ff3(
        dp, dc1, jorg, jnp.asarray(g0), jnp.asarray(g1), jm["w1"], db1, dpe0,
        dpe1, dpe2, crops=crops, n=n, rowsb=rowsb, f=f, npe=PE, lodf=1.0,
        sparse_g0=sparse, channels=C)
    if dw1e is not None:
        dw1 = dw1 + dw1e
    vols = jtf._accumulate_node_volumes(
        dp, dc1, jorg, crops=crops, n=n, rowsb=rowsb, f=f,
        g0_nodes=g0.shape[1], g1_nodes=g1.shape[1], hidden=H)
    grads = {"g0": dg0, "g1": dg1, "w1": dw1, "b1": db1, "w2": dw2,
             "b2": db2, "w3": dw3, "b3": db3}
    return (float(loss), np.asarray(out),
            {k: np.asarray(v) for k, v in grads.items()},
            [np.asarray(v) for v in vols])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_fused_train_ff3_matches_jax(geometry, mode):
    """Loss, out, dG0, dG1 and every MLP grad of the port's autograd
    function against the JAX kernel's; the plain version's accumulated
    node volumes against JAX's accumulation of its kernel's tiles."""
    n, step, data, crops, rowsb, sparse = geometry
    cd, gelu, noise = MODES[mode]
    tol = TOL[cd]
    g0, g1, mlp, origins, tgt, f = _setup(11, n, step, data, crops, sparse)
    assert tff3.ff3_geometry(crops=crops, n=n, rowsb=rowsb, f=f, hidden=H,
                             pe_channels=PE)
    j_loss, j_out, j_grads, j_vols = _jax_ff3(
        g0, g1, mlp, tgt, origins, n=n, rowsb=rowsb, f=f, sparse=sparse,
        cd=cd, gelu=gelu, nbits=noise)

    tcd = torch.bfloat16 if cd else None
    tg0 = torch.tensor(g0, requires_grad=True)
    tg1 = torch.tensor(g1, requires_grad=True)
    tm = {k: torch.tensor(v, requires_grad=True) for k, v in mlp.items()}
    before = tff3.fused_train_ff3_kernel.launches
    loss, out = tff3.fused_train_ff3(
        tg0, tg1, tm, torch.tensor(tgt), torch.tensor(origins),
        torch.tensor(SEED), n, f, PE, 1.0, sparse, not sparse, tcd, gelu,
        noise)
    loss.backward()
    assert tff3.fused_train_ff3_kernel.launches == before  # CPU: no launch
    assert abs(float(loss.detach()) - j_loss) / j_loss < tol["loss"]
    assert float(np.abs(out.numpy() - j_out).max()) < tol["out"]
    got = {"g0": tg0.grad, "g1": tg1.grad,
           **{k: v.grad for k, v in tm.items()}}
    for k, want in j_grads.items():
        assert _rel(got[k].numpy(), want) < tol["grad"], (k, mode)

    vols = tff3.fold_volumes(torch.tensor(g0), torch.tensor(g1),
                             torch.tensor(mlp["w1"]), sparse, tcd)
    res = tff3.fused_train_ff3_plain(
        *vols, *(torch.tensor(mlp[k]) for k in NAMES), torch.tensor(tgt),
        torch.tensor(origins), torch.tensor(SEED), n=n, f=f, npe=PE,
        lodf=1.0, sparse_g0=sparse, use_tri_pe=not sparse, cd=tcd, gelu=gelu,
        nbits=noise)
    for mine, want in zip(res[10:12], j_vols):
        assert mine.shape == want.shape
        assert _rel(mine.numpy(), want) < tol["grad"]


def test_fused_train_ff3_feature_noise_matches_external_eps():
    """The in-kernel ε rebuilt outside (JAX's counter hash at the JAX
    kernel's 3D counters (voxel + base)·pad8(F) + j) and added to the
    gather's features: the plain gather + MLP autograd and the port's
    fused step agree in loss, out and every grad, which pins the counter
    layout and both noise dots."""
    n, step, data, crops, _, _ = GEOMETRIES[0]
    bits = 8
    g0, g1, mlp, origins, tgt, f = _setup(23, n, step, data, crops, False)
    nfeat = 9 * C + 3 * PE + 1
    fslot = -(-nfeat // 8) * 8
    npix = crops * n**3
    ctr = (np.arange(npix, dtype=np.int32)[:, None] * fslot
           + np.arange(nfeat, dtype=np.int32)[None, :])
    eps = torch.from_numpy(np.array(jff.eps_uniform(
        jnp.asarray(ctr), jnp.int32(SEED[0]), jnp.int32(SEED[1]), bits)))

    def run(fused):
        tg = [torch.tensor(g0, requires_grad=True),
              torch.tensor(g1, requires_grad=True)]
        tm = {k: torch.tensor(v, requires_grad=True) for k, v in mlp.items()}
        if fused:
            loss, out = tff3.fused_train_ff3(
                tg[0], tg[1], tm, torch.tensor(tgt), torch.tensor(origins),
                torch.tensor(SEED), n, f, PE, 0.0, False, True, None, "erf",
                bits)
        else:
            x = decoder_input(tg, 0, torch.tensor(origins), step, n,
                              pe_channels=PE, mip_level=0, ndim=3)
            out = apply_mlp(tm, x.reshape(npix, -1) + eps)
            loss = torch.mean((out - torch.tensor(tgt)) ** 2)
        loss.backward()
        return (float(loss.detach()), out.detach().numpy(),
                [t.grad.numpy() for t in tg] + [tm[k].grad.numpy()
                                                 for k in NAMES])

    (l0, o0, g_ref), (l1, o1, g_ff) = run(False), run(True)
    assert abs(l0 - l1) / l0 < 1e-5
    assert float(np.abs(o0 - o1).max()) < 1e-5
    for a, b in zip(g_ff, g_ref):
        assert _rel(a, b) < 1e-4


def test_fused_train_ff3_refuses_out_of_volume_origins():
    n, step, data, crops, _, _ = GEOMETRIES[0]
    g0, g1, mlp, origins, tgt, f = _setup(3, n, step, data, crops, False)
    vols = tff3.fold_volumes(torch.tensor(g0), torch.tensor(g1),
                             torch.tensor(mlp["w1"]))
    bad = torch.tensor(origins)
    bad[0, 2] = data  # the crop's last voxel past the P volume
    with pytest.raises(ValueError, match="outside"):
        tff3.fused_train_ff3_kernel(
            *vols, *(torch.tensor(mlp[k]) for k in NAMES), torch.tensor(tgt),
            bad, torch.tensor(SEED), n=n, f=f, npe=PE, lodf=0.0)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """K12 against its plain version on the card at H = 64, F = 127
    (chip_smoke.py holds it at the protocol's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, step, data, crops, _, sparse = GEOMETRIES[0]
    g0, g1, mlp, origins, tgt, f = _setup(5, n, step, data, crops, sparse,
                                          hidden=64, c=12, pe=6)
    dev = "cuda"
    vols = tff3.fold_volumes(torch.tensor(g0, device=dev),
                             torch.tensor(g1, device=dev),
                             torch.tensor(mlp["w1"], device=dev))
    args = [*vols, *(torch.tensor(mlp[k], device=dev) for k in NAMES),
            torch.tensor(tgt, device=dev), torch.tensor(origins),
            torch.tensor(SEED)]
    for cd, gelu, noise in ((None, "erf", None), (torch.bfloat16, "poly", 8)):
        kw = dict(n=n, f=f, npe=6, lodf=0.0, cd=cd, gelu=gelu, nbits=noise)
        got = tff3.fused_train_ff3_kernel(*args, **kw)
        torch.cuda.synchronize()
        want = tff3.fused_train_ff3_plain(*args, **kw)
        tol = TOL[None if cd is None else "bf16"]["grad"]
        for a, b in zip(got, want):
            if b is not None:
                assert _rel(a.cpu().numpy(), b.cpu().numpy()) < tol
