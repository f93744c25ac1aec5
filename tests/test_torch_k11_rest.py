"""The back half of K11 (``csrc/train_common.cuh``: ``ff_epsgrad``, εᵀ·dz1,
and ``node_windows``, the per-crop node windows) against the K11 plain
version, on the CPU.

The two kernels' plain versions, :func:`eps_grad_plain` and
:func:`node_windows_plain`, and their wrappers (which take the plain
version for a CPU tensor) run on the dz1 that the K11 plain version's
autograd produces (``with_dz1``), and must give back that plain version's
dw1e, P_acc and C1_acc; the K11 plain version is held to JAX by
tests/test_torch_train_fused_ff.py, so no JAX call runs here. Cases: f =
4, 2, 1 with crop origins at every phase mod 2f on both axes, crops·n²
not a multiple of 128 (the kernels' last tile is partial), F = 73 (the
flagship's, one feature pass of K11's 80) at pixel base 0 and F = 137
(past K11's pass and K12's 128) at a pixel base past 0 (a mesh rank's
share of the stream), fp32 and bf16 dots, at H = 16. Limits: εᵀ·dz1 is the same product as
the plain step's dw1e (rel 1e-6); the windows sum the same terms in
another order (rel 1e-5, the limit chip_smoke.py holds the kernel to).
The C1 cells the windows kernel walks per crop (as many as the C1
window has nodes, the size of its scratch) are checked against the
windows at every n and phase.
"""

import collections
import functools

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)

from nic_torch.kernels import train_fused as tf
from nic_torch.kernels import train_fused_ff as tff

# (f, n, crops): origins at every phase mod f1 = 2f; crops·n² = 800, 400,
# 162, none a multiple of 128
LATTICES = [(4, 10, 8), (2, 10, 4), (1, 9, 2)]
MODES = {"fp32-erf": (None, "erf"), "bf16-poly": (torch.bfloat16, "poly")}
# (C, PE) → F = 5C + 2PE + 1: 73 (the flagship's) and 137; each with its
# pixel base
FEATS = {73: (12, 6), 137: (24, 8)}
BASES = {73: 0, 137: 123457}
H, NBITS, S0, S1 = 16, 8, 12345, -987654321


@functools.lru_cache(maxsize=None)
def _k11_plain(f, n, crops, nfeat, mode):
    """The K11 plain step with feature noise on seeded random planes →
    (its outputs, dz1, origins); every crop origin at its own phase mod
    2f on each axis."""
    rng = np.random.default_rng(1000 * f + nfeat)
    c, pe = FEATS[nfeat]
    base = BASES[nfeat]
    f1 = 2 * f
    size = 4 * n + 2 * f1   # pixels per axis the planes span
    g0n, g1n = size // f + 1, size // f1 + 1
    g0 = torch.from_numpy(rng.uniform(-0.4, 0.5, (c, g0n, g0n))
                          .astype(np.float32))
    g1 = torch.from_numpy(rng.uniform(-0.4, 0.5, (c, g1n, g1n))
                          .astype(np.float32))
    dims = (nfeat, H, H, 3)
    w = []
    for i in range(3):
        b = 1.0 / np.sqrt(dims[i])
        w += [torch.from_numpy(rng.uniform(-b, b, dims[i:i + 2])
                               .astype(np.float32)),
              torch.from_numpy(rng.uniform(-b, b, dims[i + 1])
                               .astype(np.float32))]
    ph = np.arange(crops) % f1
    origins = np.stack([f1 * rng.integers(0, 2 * n // f1, crops) + ph,
                        f1 * rng.integers(0, 2 * n // f1, crops)
                        + rng.permutation(ph)], axis=1).astype(np.int64)
    tgt = torch.from_numpy(rng.uniform(0, 1, (crops * n * n, 3))
                           .astype(np.float32))
    cd, gelu = MODES[mode]
    p_plane, c1_plane = tff.fold_planes(g0, g1, w[0], cd)
    seed = torch.tensor([S0, S1, base, 0], dtype=torch.int32)
    outs = tff.fused_train_ff_plain(
        p_plane, c1_plane, *w, tgt, torch.from_numpy(origins), seed, n=n,
        f=f, npe=pe, lodf=0.0, cd=cd, gelu=gelu, nbits=NBITS,
        with_dz1=True)
    return outs[:-1], outs[-1], origins, (g0n, g1n)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("nfeat", list(FEATS))
@pytest.mark.parametrize("f,n,crops", LATTICES)
def test_eps_grad_matches_k11_plain(f, n, crops, nfeat, mode):
    """εᵀ·dz1 of the plain version and of the wrapper on the CPU = the K11
    plain step's dw1e, for the step's stream (fslot = F padded to 8)."""
    outs, dz1, _, _ = _k11_plain(f, n, crops, nfeat, mode)
    want = outs[11]
    kw = dict(nfeat=nfeat, fslot=-(-nfeat // 8) * 8, s0=S0, s1=S1,
              nbits=NBITS, pixel_base=BASES[nfeat],
              bf16=MODES[mode][0] is not None)
    launches = tff.eps_grad.launches
    for fn in (tff.eps_grad_plain, tff.eps_grad):
        got = fn(dz1, **kw)
        assert got.shape == want.shape == (nfeat, H)
        assert _rel(got, want) <= 1e-6, (fn.__name__, _rel(got, want))
    assert tff.eps_grad.launches == launches  # a CPU tensor launches none


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("nfeat", list(FEATS))
@pytest.mark.parametrize("f,n,crops", LATTICES)
def test_node_windows_match_k11_plain(f, n, crops, nfeat, mode):
    """Each crop's windows of the plain version and of the wrapper on the
    CPU, placed into the planes, = the K11 plain step's P_acc and C1_acc;
    the windows have the kernel's extents."""
    outs, dz1, origins, (g0n, g1n) = _k11_plain(f, n, crops, nfeat, mode)
    rows0, cols0, rows1, cols1 = tf._window_extents(n, f)
    launches = tf.node_windows.launches
    for fn in (tf.node_windows_plain, tf.node_windows):
        win_p, win_c1 = fn(dz1, torch.from_numpy(origins), n, f)
        assert win_p.shape == (crops, rows0, cols0, H)
        assert win_c1.shape == (crops, rows1, cols1, H)
        pacc, c1acc = tf._accumulate_node_planes(
            win_p, win_c1, origins, f=f, g0_nodes=g0n,
            g1_nodes=g1n)
        for got, want in ((pacc, outs[9]), (c1acc, outs[10])):
            assert got.shape == want.shape
            assert _rel(got, want) <= 1e-5, (fn.__name__, _rel(got, want))
    assert tf.node_windows.launches == launches


@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_window_cells_hold_every_window_node(f):
    """Per axis, at every crop size n and phase of the origin mod 2f: the
    C1 cells the kernel walks, one per C1 window node (node q takes cells
    q − 1 and q), hold each P window cell in exactly one G0 half (cell
    2a + h − 1 where the phase is ≥ f, else 2a + h) and each pixel."""
    f1 = 2 * f
    for n in range(1, 4 * f1 + 2):
        rows0, cols0, rows1, cols1 = tf._window_extents(n, f)
        for cells, ext0 in ((rows1, rows0), (cols1, cols0)):
            for ph in range(f1):
                s = int(ph >= f)
                held = collections.Counter(2 * a + h - s
                                           for a in range(cells)
                                           for h in (0, 1))
                assert all(held[q] == 1 for q in range(ext0)), (n, ph)
                assert (n - 1 + ph) // f1 < cells, (n, ph)


def test_node_windows_refuse_a_wrong_dz1():
    dz1 = torch.zeros(2 * 8 * 8 - 1, H)
    with pytest.raises(ValueError, match="not \\[crops·n², H\\]"):
        tf.node_windows(dz1, torch.zeros(2, 2, dtype=torch.int64), 8, 2)
