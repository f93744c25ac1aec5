"""A numeric model, in torch on the CPU, of K2's tensor-core body
``decode_z1mm_mma`` (csrc/decode_z1mm.cu): a warp takes a window of 16
consecutive image rows of one column, and z1 of those rows is the
product of A' (the matching columns of the static ``[A0 | A1]`` matrix,
``z1_matrix``) with the band S' of P and C1v rows the window reads; at
R = 8 a window spans two tiles and A' is block-diagonal.

- ``z1_matrix``'s entries (0, 1 − fu, fu) are exact in TF32 for every
  (R, f, f1) the C entry point admits (R·K ≤ 1024), so the kernel's fp32
  product needs two TF32 products (A·S_lo + A·S_hi) and not three; they
  are exact in bf16 up to f1 = 256, and at the one admitted geometry past
  it (R = 512, f = 1, f1 = 512: K = 2) A is the sum of two bf16 parts,
  which the kernel then takes as two exact products.
- The window model (the kernel's ``Band``, ``band_a`` and ``stage_band``
  rules, here in torch) reproduces the plain version's first-layer sums
  (``_z1mm_sums``) exactly in float64, at JAX's geometries and at two
  corners its gate never sends: R = 8 with f = f1 = 2 (18 band rows),
  R = 32 with f = 4, f1 = 8 (two windows a tile), and the bf16 split
  geometry.
- The two-product TF32 model of the product, then the first GELU and the
  3xTF32 tail model of test_torch_decode_tf32.py, holds
  ``decode_kernel_z1mm_plain`` within the fp32 limit 2e-5 at H = 64 and
  128.

No JAX here: the plain version is held to JAX in
test_torch_decode_fused_v2.py.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)

from nic_torch.kernels import decode_fused_v2 as tdf
from test_torch_decode_tf32 import _inputs, _tail, dot3, tf32

TOL = 2e-5  # K2's fp32 limit against its plain version
# (R, f, f1): JAX's geometries (mips 0-2 of the flagship, then the
# deeper mips' R = f1 = 2f) and two contract corners outside its gate
JAX_GEOMETRIES = [(8, 4, 8), (8, 2, 4), (8, 1, 2), (16, 8, 16), (32, 16, 32)]
CORNERS = [(8, 2, 2), (32, 4, 8)]
SPLIT = (512, 1, 512)  # the one admitted geometry whose A bf16 splits


def _powers(n):
    return [1 << i for i in range(n.bit_length()) if (1 << i) <= n]


def _admitted(R):
    """The (f, f1) with R·K ≤ 1024 that ``_check_z1mm`` and the C entry
    point admit at tile rows R (K counts A0's columns unless f == 1)."""
    return [(f, f1) for f in _powers(R) for f1 in _powers(R)
            if R * ((R // f if f > 1 else 0) + R // f1 + 1) <= 1024]


@pytest.mark.parametrize("R", [8, 16, 32, 64, 128, 256, 512])
def test_z1_matrix_is_exact_in_bf16_and_tf32(R):
    pairs = _admitted(R)
    assert pairs
    for f, f1 in pairs:
        a = tdf.z1_matrix(R, f, f1)
        assert torch.equal(tf32(a), a), (R, f, f1)
        hi = a.to(torch.bfloat16).float()
        lo = (a - hi).to(torch.bfloat16).float()
        assert torch.equal(hi + lo, a), (R, f, f1)
        # one bf16 part (the kernel's single product) exactly up to 256
        assert torch.equal(hi, a) == (f1 <= 256), (R, f, f1)
    assert (SPLIT in [(R, f, f1) for f, f1 in pairs]) == (R == 512)


def _band(R, f, f1, add_p, bf16):
    """The kernel's ``Band``: segment rows, P and C1v rows a segment
    reads, band rows, and the band padded to the k step."""
    seg = min(R, 16)
    np_ = 0 if add_p else (seg - 1) // f + 1
    nc = (seg - 1) // f1 + 2
    rows = 16 // seg * (np_ + nc)
    step = 16 if bf16 else 8
    return dict(seg=seg, np=np_, nc=nc, rows=rows,
                kpad=-(-rows // step) * step)


def _window_sums(pc, c1v, *, f, f1, R, bf16, product):
    """z1 [nr, ncl, H] as decode_z1mm_mma forms it, window by window:
    ``product(A', S')`` ([16, kpad] by [kpad, ncl, H], zero past the
    band), plus P where f == 1. A' is read from the wrapper's matrix
    (``z1_matrix``, A0 dropped when f == 1), S' as ``stage_band`` copies
    it (a segment past the image reads the last tile)."""
    add_p = f == 1
    nr, ncl, hidden = pc.shape[0] * f, pc.shape[1], pc.shape[2]
    a = tdf.z1_matrix(R, f, f1)
    kp, m = (0 if add_p else R // f), R // f1
    if add_p:
        a = a[:, R:]
    K = a.shape[1]
    assert K == kp + m + 1
    bd = _band(R, f, f1, add_p, bf16)
    per, ntiles = bd["np"] + bd["nc"], nr // R
    out = torch.zeros((nr, ncl, hidden), dtype=pc.dtype)
    for row0 in range(0, nr, 16):
        s_band = torch.zeros((bd["kpad"], ncl, hidden), dtype=pc.dtype)
        for b in range(bd["rows"]):
            s, j = divmod(b, per)
            r0s = row0 + s * bd["seg"]
            t, rl0 = min(r0s // R, ntiles - 1), r0s % R
            s_band[b] = (pc[t * kp + rl0 // f + j] if j < bd["np"] else
                         c1v[t * m + rl0 // f1 + j - bd["np"]])
        a_band = torch.zeros((16, bd["kpad"]), dtype=pc.dtype)
        for i in range(16):
            s = i // bd["seg"]
            rl, rl0 = (row0 + i) % R, (row0 + s * bd["seg"]) % R
            for j in range(per):
                col = (rl0 // f + j if j < bd["np"] else
                       kp + rl0 // f1 + j - bd["np"])
                a_band[i, s * per + j] = a[rl, col]
            # the band holds every column the row reads
            assert float(a_band[i].sum()) == float(a[rl].sum()) == (
                1.0 if add_p else 2.0)
        z = product(a_band, s_band)
        n = min(16, nr - row0)
        if add_p:
            z[:n] = z[:n] + pc[row0:row0 + n]
        out[row0:row0 + n] = z[:n]
    return out, bd


def _dyadic_planes(rng, nr, ncl, hidden, f, f1):
    """P [nr/f, ncl, H] and C1v [nr/f1 + 1, ncl, H] of multiples of 2^-10
    in [-4, 4): every sum of their products with A is exact in float64."""
    def draw(rows):
        return torch.tensor(rng.integers(-4096, 4096, (rows, ncl, hidden))
                            / 1024.0)
    return draw(nr // f), draw(nr // f1 + 1)


def _einsum(a_band, s_band):
    return torch.einsum("ib,bch->ich", a_band, s_band)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "tf32"])
@pytest.mark.parametrize("R,f,f1", JAX_GEOMETRIES + CORNERS + [SPLIT])
def test_window_band_reproduces_the_plain_sums(R, f, f1, bf16):
    """The window model's z1 equals the plain version's bit for bit in
    float64, half-empty last windows (R = 8, nr % 16 == 8) and several
    windows a tile (R = 32, 512) included."""
    nr = 5 * R if R == 8 else 3 * R
    pc, c1v = _dyadic_planes(np.random.default_rng(R + 10 * f + f1), nr, 5,
                             8, f, f1)
    got, bd = _window_sums(pc, c1v, f=f, f1=f1, R=R, bf16=bf16,
                           product=_einsum)
    want = tdf._z1mm_sums(pc, c1v, f=f, f1=f1, R=R)
    assert want.dtype == torch.float64
    assert torch.equal(got, want)
    if R == 8:  # the window spans two tiles: 2K band rows
        K = (R // f if f > 1 else 0) + R // f1 + 1
        assert bd["rows"] == 2 * K
    assert bd["rows"] <= 32 and bd["kpad"] <= 32


def _two_tf32(a_band, s_band):
    """A'·S' as the kernel takes it for fp32 planes: A'·S_lo + A'·S_hi in
    m16n8k8 TF32 products (A' is exact in TF32), summed in float64 and
    returned in fp32."""
    s_hi = tf32(s_band)
    s_lo = tf32(s_band - s_hi)
    a = a_band.double()
    return (torch.einsum("ib,bch->ich", a, s_lo.double())
            + torch.einsum("ib,bch->ich", a, s_hi.double())).float()


@pytest.mark.parametrize("R,f,f1", [(8, 4, 8), (8, 1, 2)],
                         ids=["mip0", "mip2-add-p"])
@pytest.mark.parametrize("hidden", [64, 128])
def test_two_tf32_product_and_3xtf32_tail_hold_fp32(hidden, R, f, f1):
    """z1 by two TF32 products, plus the row PE, the exact GELU, and the
    tail in 3xTF32, against ``decode_kernel_z1mm_plain`` (fp32)."""
    rng = np.random.default_rng(hidden + f)
    nr, ncl = 32, 64
    pc = torch.tensor(rng.uniform(-1.0, 1.0, (nr // f, ncl, hidden)),
                      dtype=torch.float32)
    c1v = torch.tensor(rng.uniform(-1.0, 1.0, (nr // f1 + 1, ncl, hidden)),
                       dtype=torch.float32)
    pe_u = torch.tensor(rng.uniform(-1.0, 1.0, (nr, hidden)),
                        dtype=torch.float32)
    _, mlp = _inputs(73, hidden, seed=hidden + R)
    args = (pc, c1v, pe_u, mlp["w2"], mlp["b2"], mlp["w3"], mlp["b3"])
    want = tdf.decode_kernel_z1mm_plain(*args, f=f, f1=f1, R=R)
    z1, _ = _window_sums(pc, c1v, f=f, f1=f1, R=R, bf16=False,
                         product=_two_tf32)
    h1 = tdf.GELUS["exact"](z1 + pe_u[:, None, :])
    got = _tail(h1, mlp, dot3)
    assert got.shape == want.shape == (nr, ncl, 3)
    err = float((got - want).abs().max())
    assert err <= TOL, err
    # the model departs from fp32 at all: S_lo carries what S_hi drops
    assert not torch.equal(tf32(pc), pc)
