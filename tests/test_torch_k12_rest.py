"""The node volumes of K12 and K9 (``csrc/train_common.cuh``:
``node_volumes`` + ``node_volume_corners``, the per-crop P and C1 windows of
dz1 in 3D) against the K12 plain version and K9's plain reduction, and
K12's part C (``csrc/train_fused_ff3.cu``: ``ff3_pe_band`` +
``ff_pe_sum``, the PE grads and db1) against the K12 plain version, on the
CPU.

The plain version :func:`node_volumes_plain` and its wrapper
:func:`node_volumes` (which takes the plain version for a CPU tensor) run
on the dz1 that the K12 plain version's autograd produces (``with_dz1``);
placed by :func:`_accumulate_node_planes`, their windows must give back
that plain version's P_acc and C1_acc, and K9's plain node sums
(:func:`_node_sums`) of the same dz1. The K12 plain version is held to JAX
by tests/test_torch_train_fused_ff3.py and ``_node_sums`` by
tests/test_torch_train_fused_ng3.py, so no JAX call runs here. Cases: f =
4, 2, 1 with crop origins at every phase mod 2f on all three axes and
crops·n³ not a multiple of 128, method 3 (dense G0, triangular PE) and
method 4 (sparse G0, sinusoidal PE), fp32·erf and bf16·poly with the
feature noise, at H = 16. Limit: the windows sum the same terms in another
order (rel 1e-5, the limit chip_smoke.py holds the kernel to). The C1
cells the kernel walks per crop (one block per cell of the C1 window, the
size of its scratch) and its split of a quarter's lines over a block's
line slots are checked to read every voxel once and to hold every window
node.

Part C: the plain version :func:`pe_grads3_plain` and its wrapper
:func:`pe_grads3` (the plain version for a CPU tensor, no launch) on the
same dz1 must give the K12 plain step's dpe0, dpe1, dpe2 and db1 (rel
1e-5: the same fp32 terms summed in another order), over the same cases
at npe 6 and 8 (method 3 with triangular PE, method 4 with sinusoidal PE);
the bands of slabs the kernel's blocks take hold every slab once.
"""

import collections
import functools

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)

from nic_torch.kernels import train_fused as tf
from nic_torch.kernels import train_fused_ff3 as tff3

# (f, n, crops): origins at every phase mod f1 = 2f on each axis; crops·n³
# = 5832, 500, 250, none a multiple of 128; n mod f1 is 1, the windows'
# extents (the JAX package's) hold every voxel's nodes for n mod f1 ≤ 2
LATTICES = [(4, 9, 8), (2, 5, 4), (1, 5, 2)]
MODES = {"fp32-erf": (None, "erf"), "bf16-poly": (torch.bfloat16, "poly")}
C, PE, H, NBITS, S0, S1 = 2, 2, 16, 8, 12345, -987654321
# line slots of a node_volumes block a G0 quarter (csrc/train_common.cuh)
QUARTER_SLOTS = 4


@functools.lru_cache(maxsize=None)
def _k12_plain(f, n, crops, method, mode, npe=PE):
    """The K12 plain step with feature noise on seeded random volumes and
    ``npe`` PE rows a axis → (its outputs, dz1, origins, (g0n, g1n)); every
    crop origin at its own phase mod 2f on each axis."""
    rng = np.random.default_rng(100 * f + 10 * n + method + 1000 * (npe - PE))
    sparse = method == 4
    f1 = 2 * f
    size = 2 * n + 2 * f1   # voxels per axis the volumes span
    g0n, g1n = size // f + 1, size // f1 + 1
    g0 = torch.from_numpy(rng.uniform(-0.4, 0.5, (C,) + (g0n,) * 3)
                          .astype(np.float32))
    g1 = torch.from_numpy(rng.uniform(-0.4, 0.5, (C,) + (g1n,) * 3)
                          .astype(np.float32))
    dims = (C * ((4 if sparse else 8) + 1) + 3 * npe + 1, H, H, 3)
    w = []
    for i in range(3):
        b = 1.0 / np.sqrt(dims[i])
        w += [torch.from_numpy(rng.uniform(-b, b, dims[i:i + 2])
                               .astype(np.float32)),
              torch.from_numpy(rng.uniform(-b, b, dims[i + 1])
                               .astype(np.float32))]
    ph = np.arange(crops) % f1
    origins = np.stack([f1 * rng.integers(0, n // f1 + 1, crops)
                        + (ph if d == 0 else rng.permutation(ph))
                        for d in range(3)], axis=1).astype(np.int64)
    tgt = torch.from_numpy(rng.uniform(0, 1, (crops * n**3, 3))
                           .astype(np.float32))
    cd, gelu = MODES[mode]
    vols = tff3.fold_volumes(g0, g1, w[0], sparse, cd)
    seed = torch.tensor([S0, S1, 0, 0], dtype=torch.int32)
    outs = tff3.fused_train_ff3_plain(
        *vols, *w, tgt, torch.from_numpy(origins), seed, n=n, f=f, npe=npe,
        lodf=0.0, sparse_g0=sparse, use_tri_pe=not sparse, cd=cd, gelu=gelu,
        nbits=NBITS, with_dz1=True)
    return outs[:-1], outs[-1], origins, (g0n, g1n)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def _placed(fn, f, n, crops, method, mode):
    """The windows of ``fn`` on the case's dz1, checked for the kernel's
    extents, placed into full-grid volumes."""
    _, dz1, origins, (g0n, g1n) = _k12_plain(f, n, crops, method, mode)
    ext0, ext1 = tf._window_extents_3d(n, f)
    win_p, win_c1 = fn(dz1, torch.from_numpy(origins), n, f)
    assert win_p.shape == (crops, *ext0, H)
    assert win_c1.shape == (crops, *ext1, H)
    return tf._accumulate_node_planes(win_p, win_c1, origins, f=f,
                                      g0_nodes=g0n, g1_nodes=g1n)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("method", [3, 4])
@pytest.mark.parametrize("f,n,crops", LATTICES)
def test_node_volumes_match_k12_plain(f, n, crops, method, mode):
    """Each crop's volumes of the plain version and of the wrapper on the
    CPU, placed into the full-grid volumes, = the K12 plain step's P_acc
    and C1_acc."""
    outs = _k12_plain(f, n, crops, method, mode)[0]
    launches = tf.node_volumes.launches
    for fn in (tf.node_volumes_plain, tf.node_volumes):
        for got, want in zip(_placed(fn, f, n, crops, method, mode),
                             outs[10:12]):
            assert got.shape == want.shape
            assert _rel(got, want) <= 1e-5, (fn.__name__, _rel(got, want))
    assert tf.node_volumes.launches == launches  # a CPU tensor launches none


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("method", [3, 4])
@pytest.mark.parametrize("f,n,crops", LATTICES)
def test_node_volumes_match_node_sums(f, n, crops, method, mode):
    """The same placed volumes = K9's plain reduction (``_node_sums``) of
    the same dz1."""
    _, dz1, origins, (g0n, g1n) = _k12_plain(f, n, crops, method, mode)
    want = tf._node_sums(dz1, torch.from_numpy(origins), n=n, f=f,
                         g0_nodes=g0n, g1_nodes=g1n)
    got = _placed(tf.node_volumes, f, n, crops, method, mode)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= 1e-5, _rel(g, w)


@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_volume_cells_hold_every_window_node(f):
    """Per axis, at every crop size n and phase of the origin mod 2f: the
    C1 cells the kernel walks, one per C1 window node on that axis (r1 on
    the slab axis, c1 on the others; node q takes cells q − 1 and q), read
    each voxel once (the cell's G0 halves, f voxels each from the cell's
    first, cut at the crop's edges) and hold each P window cell in exactly
    one G0 half (cell 2a + h − 1 where the phase is ≥ f, else 2a + h); a
    quarter's 4 line slots take each of its f·f lines once."""
    f1 = 2 * f
    for n in range(1, 4 * f1 + 2):
        ext0, ext1 = tf._window_extents_3d(n, f)
        for cells, r0 in zip(ext1, ext0):
            for ph in range(f1):
                s = int(ph >= f)
                read = collections.Counter(
                    v for a in range(cells) for h in (0, 1)
                    for i in range(f)
                    for v in [2 * a * f - ph + h * f + i] if 0 <= v < n)
                assert read == collections.Counter(range(n)), (n, ph)
                held = collections.Counter(2 * a + h - s
                                           for a in range(cells)
                                           for h in (0, 1))
                assert all(held[q] == 1 for q in range(r0)), (n, ph)
    lines = collections.Counter(m for sub in range(QUARTER_SLOTS)
                                for m in range(sub, f * f, QUARTER_SLOTS))
    assert lines == collections.Counter(range(f * f))


def test_node_volumes_refuse_a_wrong_dz1():
    dz1 = torch.zeros(2 * 4**3 - 1, H)
    with pytest.raises(ValueError, match="not \\[crops·n³, H\\]"):
        tf.node_volumes(dz1, torch.zeros(2, 3, dtype=torch.int64), 4, 2)


def test_k12_plain_dz1_is_the_cotangent_of_z1():
    """``with_dz1`` appends dz1 [N, H], whose sum is the step's db1."""
    f, n, crops = LATTICES[1]
    outs, dz1, _, _ = _k12_plain(f, n, crops, 3, "fp32-erf")
    assert len(outs) == 13 and dz1.shape == (crops * n**3, H)
    assert _rel(dz1.sum(dim=0), outs[9]) <= 1e-5


def test_node_volumes_refuse_f_not_a_power_of_two():
    dz1 = torch.zeros(2 * 4**3, H)
    with pytest.raises(ValueError, match="power of two"):
        tf.node_volumes(dz1, torch.zeros(2, 3, dtype=torch.int64), 4, 3)


@pytest.mark.parametrize("npe", [6, 8])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("method", [3, 4])
@pytest.mark.parametrize("f,n,crops", LATTICES)
def test_pe_grads3_match_k12_plain(f, n, crops, method, mode, npe):
    """The PE grads and db1 of the plain version and of the wrapper on the
    CPU = the K12 plain step's dpe0, dpe1, dpe2 and db1 (triangular PE in
    method 3, sinusoidal in method 4; crops at every phase)."""
    outs, dz1, origins, _ = _k12_plain(f, n, crops, method, mode, npe)
    launches = tff3.pe_grads3.launches
    for fn in (tff3.pe_grads3_plain, tff3.pe_grads3):
        got = fn(dz1, torch.from_numpy(origins), n, f, npe, method == 3)
        assert len(got) == 4
        for g, want in zip(got, outs[6:10]):
            assert g.shape == want.shape
            assert _rel(g, want) <= 1e-5, (fn.__name__, _rel(g, want))
    assert tff3.pe_grads3.launches == launches  # a CPU tensor launches none


def test_pe_grads3_refuse_a_wrong_dz1():
    dz1 = torch.zeros(2 * 4**3 - 1, H)
    with pytest.raises(ValueError, match="not \\[crops·n³, H\\]"):
        tff3.pe_grads3(dz1, torch.zeros(2, 3, dtype=torch.int64), 4, 2, 6)
    with pytest.raises(ValueError, match="not \\[crops·n³, H\\]"):
        tff3.pe_grads3(torch.zeros(2 * 4**3, H),
                       torch.zeros(2, 2, dtype=torch.int64), 4, 2, 6)


def test_pe_grads3_refuse_more_than_8_pe_rows():
    dz1 = torch.zeros(2 * 4**3, H)
    with pytest.raises(ValueError, match="0 to 8 PE rows"):
        tff3.pe_grads3(dz1, torch.zeros(2, 3, dtype=torch.int64), 4, 2, 9)
