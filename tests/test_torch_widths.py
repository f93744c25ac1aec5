"""nic_torch.kernels._widths: every hidden width the port's gates admit
runs on an instantiated CUDA width, and the zero padding that takes it
there leaves the step unchanged.

The table test is pure Python: for every H in 1..320 (and, where a gate
reads it, a range of F) that a gate accepts, ``kernel_width`` names a
width ≥ H that the family's ``.cu`` source dispatches on, or, past the
built widths of the families whose gates check no width, the next
multiple of 64, up to the family's widest (``WIDEST``), past which it
refuses. The padding tests run the plain versions of K11, K7 and K12 at
H = 16 (K12 also at F = 133, method 3 with C = 12 and PE 8), and of K7
and K1 at H = 130 (padded to 192, a wide body's width), once directly
and once through the wrapper's pad-and-slice helper: a padded unit has
zero first-layer weights and zero outgoing weights, so loss, out and
every grad agree to fp32 summation order (rel 1e-6). No test here runs
JAX: the plain versions are held to JAX at small H elsewhere.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nic_torch.kernels import _widths
from nic_torch.kernels import decode_fused_v2 as dv2
from nic_torch.kernels import train_fused as tf
from nic_torch.kernels import train_fused_ff as tff
from nic_torch.kernels import train_fused_ff3 as tff3

CSRC = Path(tff.__file__).resolve().parent / "csrc"
# where each family's .cu dispatches on its widths
DISPATCH = {
    "decode_v2": ("decode_fused_v2.cu", r"(?:dispatch_mode<|kMmaMin = )(\d+)"),
    "decode_z1mm": ("decode_z1mm.cu", r"NIC_Z1MM\((\d+)\)"),
    "decode_v1": ("decode_fused.cu", r"NIC_V1\((\d+),"),
    "decode_v3": ("decode_fused_v3.cu", r"NIC_TAIL\((\d+),"),
    "train_ff": ("train_fused_ff.cu", r"dispatch_gelu<(\d+),"),
    "train_ff3": ("train_fused_ff3.cu", r"dispatch_gelu<(\d+),"),
    "train_mlp": ("train_fused.cu", r"NIC_WIDTH\((\d+)\)"),
}
FEATURES = (13, 73, 79, 127, 133, 205, 301)
SEED = np.array([12345, -987654321, 0, 0], np.int32)
NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


def _admitted(family, hidden, nfeat):
    """Does a gate of the port send hidden width ``hidden`` (and ``nfeat``
    features) to this family's kernels? The kernel3 gates bound H; the
    kernel2/kernel gates and the decode gates check no width."""
    if family == "train_ff":
        return tff.ff_geometry(crops=8, n=256, rowsb=8, f=1, hidden=hidden,
                               pe_channels=6)
    if family == "train_ff3":
        return tff3.ff3_geometry(crops=8, n=32, rowsb=2, f=4, hidden=hidden,
                                 pe_channels=8, nfeat=nfeat)
    return True


@pytest.mark.parametrize("family", sorted(_widths.KERNEL_WIDTHS))
def test_every_admitted_width_maps_onto_a_built_width(family):
    src, pattern = DISPATCH[family]
    built = {int(w) for w in re.findall(pattern, (CSRC / src).read_text())}
    assert set(_widths.KERNEL_WIDTHS[family]) == built
    widest = _widths.WIDEST.get(family)
    admitted = 0
    for hidden in range(1, 321):
        for nfeat in FEATURES:
            if not _admitted(family, hidden, nfeat):
                continue
            admitted += 1
            width = _widths.kernel_width(family, hidden)
            if hidden <= max(built):
                assert width in built and width >= hidden
                # the narrowest built width that holds it
                assert not [w for w in built if hidden <= w < width]
            else:  # a wide body's width: the next multiple of 64
                assert widest is not None
                assert width % 64 == 0 and 0 <= width - hidden < 64
    assert admitted >= 64 * len(FEATURES)
    if widest is None:
        with pytest.raises(ValueError, match=re.escape(
                str(_widths.KERNEL_WIDTHS[family]))):
            _widths.kernel_width(family, max(built) + 1)
    else:  # the largest-H refusal, which names the widest width
        assert widest >= 1024 and widest % 64 == 0
        assert _widths.kernel_width(family, widest) == widest
        with pytest.raises(ValueError, match=re.escape(str(widest))):
            _widths.kernel_width(family, widest + 1)


def test_pad_and_unpad_round_trip():
    t = torch.arange(2 * 16 * 16, dtype=torch.float32).reshape(2, 16, 16)
    p = _widths.pad_hidden(t, 64, (1, 2))
    assert p.shape == (2, 64, 64) and float(p[:, 16:].abs().sum()) == 0.0
    assert torch.equal(_widths.unpad(p, 16, (1, 2)), t)
    assert _widths.pad_hidden(t, 16, (1, 2)) is t  # built width: no copy
    assert _widths.unpad(t, 16, (1, 2)) is t


def _mlp(rng, nfeat, hidden):
    dims = (nfeat, hidden, hidden, 3)
    mlp = {}
    for i in range(3):
        b = 1.0 / np.sqrt(dims[i])
        mlp[f"w{i + 1}"] = torch.tensor(
            rng.uniform(-b, b, dims[i:i + 2]).astype(np.float32))
        mlp[f"b{i + 1}"] = torch.tensor(
            rng.uniform(-b, b, dims[i + 1]).astype(np.float32))
    return mlp


def _assert_same(direct, padded):
    assert len(direct) == len(padded)
    for i, (a, b) in enumerate(zip(direct, padded)):
        if a is None:
            assert b is None
            continue
        assert a.shape == b.shape, i
        a, b = a.double(), b.double()
        scale = float(a.abs().max()) + 1e-30
        assert float((a - b).abs().max()) / scale < 1e-6, i


MODES = {"fp32-erf": (None, "erf"), "bf16-poly": (torch.bfloat16, "poly")}


@pytest.mark.parametrize("noise", [None, 8])
@pytest.mark.parametrize("mode", list(MODES))
def test_k11_padding_is_exact(mode, noise):
    cd, gelu = MODES[mode]
    rng = np.random.default_rng(3)
    c, pe, n, f, crops, hidden = 4, 2, 16, 2, 2, 16
    g0 = torch.tensor(rng.uniform(-0.4, 0.5, (c, 17, 17)).astype(np.float32))
    g1 = torch.tensor(rng.uniform(-0.4, 0.5, (c, 9, 9)).astype(np.float32))
    mlp = _mlp(rng, 5 * c + 2 * pe + 1, hidden)
    origins = torch.tensor(rng.integers(0, 16, (crops, 2)).astype(np.int32))
    tgt = torch.tensor(rng.uniform(0, 1, (crops * n * n, 3))
                       .astype(np.float32))
    p_plane, c1_plane = tff.fold_planes(g0, g1, mlp["w1"], cd)
    args = (p_plane, c1_plane, *(mlp[k] for k in NAMES), tgt, origins,
            torch.tensor(SEED))
    kw = dict(n=n, f=f, npe=pe, lodf=1.0, cd=cd, gelu=gelu, nbits=noise)
    direct = tff.fused_train_ff_plain(*args, **kw)
    padded = tff.fused_train_ff_padded(tff.fused_train_ff_plain, 64, *args,
                                       **kw)
    _assert_same(direct, padded)


@pytest.mark.parametrize("mode", list(MODES))
def test_k7_padding_is_exact(mode):
    cd, gelu = MODES[mode]
    rng = np.random.default_rng(5)
    n, f, crops, hidden, nfeat = 8, 2, 2, 16, 29
    x = torch.tensor(rng.uniform(-1, 1, (crops * n * n, nfeat))
                     .astype(np.float32))
    tgt = torch.tensor(rng.uniform(0, 1, (crops * n * n, 3))
                       .astype(np.float32))
    origins = torch.tensor(rng.integers(0, 8, (crops, 2)).astype(np.int32))
    mlp = _mlp(rng, nfeat, hidden)
    kw = dict(n=n, f=f, g0_nodes=9, g1_nodes=5, cd=cd, gelu=gelu)
    args = (x, tgt, origins, *(mlp[k] for k in NAMES))
    direct = tf.fused_mlp_loss_ng_plain(*args, **kw)
    padded = tf.fused_mlp_loss_padded(tf.fused_mlp_loss_ng_plain, 64, *args,
                                      **kw)
    _assert_same(direct, padded)


@pytest.mark.parametrize("c,pe", [(2, 2), (12, 8)], ids=["F25", "F133"])
def test_k12_padding_is_exact(c, pe):
    rng = np.random.default_rng(7)
    n, f, crops, hidden = 8, 2, 2, 16
    g0 = torch.tensor(rng.uniform(-0.4, 0.5, (c, 9, 9, 9)).astype(np.float32))
    g1 = torch.tensor(rng.uniform(-0.4, 0.5, (c, 5, 5, 5)).astype(np.float32))
    nfeat = 9 * c + 3 * pe + 1
    mlp = _mlp(rng, nfeat, hidden)
    origins = torch.tensor(rng.integers(0, 8, (crops, 3)).astype(np.int32))
    tgt = torch.tensor(rng.uniform(0, 1, (crops * n**3, 3))
                       .astype(np.float32))
    cd = torch.bfloat16
    p_vol, c1_vol = tff3.fold_volumes(g0, g1, mlp["w1"], False, cd)
    args = (p_vol, c1_vol, *(mlp[k] for k in NAMES), tgt, origins,
            torch.tensor(SEED))
    kw = dict(n=n, f=f, npe=pe, lodf=0.5, cd=cd, gelu="poly", nbits=8)
    direct = tff3.fused_train_ff3_plain(*args, **kw)
    padded = tff3.fused_train_ff3_padded(tff3.fused_train_ff3_plain, 64,
                                         *args, **kw)
    _assert_same(direct, padded)


def test_k7_wide_padding_is_exact():
    """K7's plain step at H = 130 directly and padded to 192 (the width
    mlp_pixel_wide runs it at)."""
    rng = np.random.default_rng(11)
    n, f, crops, hidden, nfeat = 4, 2, 2, 130, 29
    assert _widths.kernel_width("train_mlp", hidden) == 192
    x = torch.tensor(rng.uniform(-1, 1, (crops * n * n, nfeat))
                     .astype(np.float32))
    tgt = torch.tensor(rng.uniform(0, 1, (crops * n * n, 3))
                       .astype(np.float32))
    origins = torch.tensor(rng.integers(0, 8, (crops, 2)).astype(np.int32))
    mlp = _mlp(rng, nfeat, hidden)
    kw = dict(n=n, f=f, g0_nodes=9, g1_nodes=5, cd=None, gelu="erf")
    args = (x, tgt, origins, *(mlp[k] for k in NAMES))
    direct = tf.fused_mlp_loss_ng_plain(*args, **kw)
    padded = tf.fused_mlp_loss_padded(tf.fused_mlp_loss_ng_plain, 192, *args,
                                      **kw)
    _assert_same(direct, padded)


@pytest.mark.parametrize("mode", ["fp32", "i16"])
def test_k1_wide_padding_is_exact(mode):
    """K1's plain per-pixel stage at H = 130 directly and with its planes
    and tail weights padded to 192 (decode_v2_mma's width for it)."""
    rng = np.random.default_rng(13)
    nr, ncl, f, f1, hidden = 8, 6, 2, 4, 130
    assert _widths.kernel_width("decode_v2", hidden) == 192
    def arr(*shape, lo=-0.5, hi=0.5):
        return torch.tensor(rng.uniform(lo, hi, shape).astype(np.float32))
    pc, c1v = arr(nr // f, ncl, hidden), arr(nr // f1 + 1, ncl, hidden)
    pe_u = arr(nr, hidden)
    mlp = _mlp(rng, 4, hidden)
    w2, b2, w3, b3 = (mlp[k] for k in ("w2", "b2", "w3", "b3"))
    scale = None
    if mode == "i16":
        scale = torch.tensor(0.5 / 32767.0)
        pc = torch.round(pc * 32767.0).to(torch.int16)
        c1v = torch.round(c1v * 32767.0).to(torch.int16)
        w2, w3 = w2.to(torch.bfloat16), w3.to(torch.bfloat16)
    kw = dict(f=f, f1=f1, gelu="tanherf" if mode == "i16" else "exact")
    direct = dv2.decode_kernel_2d_plain(pc, c1v, pe_u, w2, b2, w3, b3, scale,
                                        **kw)
    padded = dv2._padded_planes(dv2.decode_kernel_2d_plain, 192, pc, c1v,
                                pe_u, w2, b2, w3, b3, scale, **kw)
    _assert_same((direct,), (padded,))
