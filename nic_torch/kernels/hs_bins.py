"""K13: the hyper-synthesis and σ → coding bin of the scale-hyperprior
codec (the CUDA kernel is ``csrc/hs_bins.cu``).

It replaces no Pallas kernel: JAX computes this stage in XLA
(``nic/train/hyperprior.py:284`` ``h_s_bins``). σ picks the rANS table
of every ŷ symbol, so compress and decompress must compute the identical
bin, across processes and devices (the contract of
``nic/models/hyperprior.py:119-131``), or the y stream desyncs. The
library's convolutions sum in an order that depends on the algorithm
they pick and the device's libm differs from the CPU's, so this stage is
one fixed order of IEEE fp32 operations, written twice: once in CUDA and
once here as torch ops (:func:`hs_bins_plain`). The card and the CPU
give the same σ and bins, bit for bit; the bins agree with JAX's except
where XLA's own sums and libm move σ across a bin edge (a share of about
1e-5 of the elements, measured by ``tests/test_torch_hyperprior.py``).

The order (``csrc/hs_bins.cu`` states it beside the code):

- ConvT(N→N, k4 s2 p1) + GELU, twice: each output phase sums its 2×2
  real taps in JAX's polyphase order (``nic/models/matmul_conv.py:190-
  226``), each tap over Cin ascending from 0, the taps in order, bias
  last;
- Conv(N→M, k3 s1 p1): one sum over the taps in ``itertools.product``
  order and Cin ascending, from 0, bias last;
- σ = exp(v), bin = ceil((log σ − ln 0.11)·63/ln(64/0.11)) clipped to
  [0, 63], the constants rounded to fp32 as JAX's weak typing does; log
  of exp, not v, since the round trip is part of the function; exp
  overflow gives bin 63, underflow bin 0, a NaN bin 0.

exp, log and tanh are :func:`exp_fixed`, :func:`log_fixed` and
:func:`tanh_fixed`: exact power-of-two range reduction and a fixed
polynomial, within 1.3 ulp of a float64 reference. GELU is the tanh form
(:func:`gelu_fixed`).

The kernel (the design and its bound are in ``csrc/hs_bins.cu``'s note):
three launches, one a layer; a block computes 16 output channels × a tile
of 4 rows × 16 columns where the layer's grid is large, else 1 row × 16
(8 where N's shared memory needs it), a thread 4 channels × a column of
the tile's rows, from the block's input window and one tap's weights at a
time staged in shared memory by the tensor memory accelerator's tensor
copies. The tiles change no output's order of operations, so its bits
are the plain version's.

- :func:`hs_bins_plain`: the function in torch ops, on any device;
- :func:`hs_bins_kernel`: launches the CUDA kernel for CUDA tensors and
  runs :func:`hs_bins_plain` for CPU tensors; ``hs_bins_kernel.launches``
  counts launches (one per call: the kernel's three layers);
- :func:`launch_plan`: the kernel's tiles, grids and shared memory for
  widths and a ẑ size (a width with none raises);
- :func:`hs_weights`: the rows layout both take, from a
  ``HyperSynthesis`` module.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["HsWeights", "hs_weights", "hs_bins_plain", "hs_bins_kernel",
           "launch_plan", "exp_fixed", "log_fixed", "tanh_fixed",
           "gelu_fixed", "SCALE_MIN", "SCALE_MAX", "NUM_SCALE_BINS"]

SCALE_MIN, SCALE_MAX, NUM_SCALE_BINS = 0.11, 64.0, 64
# fp32 values (each exact in a Python float): ln(SCALE_MIN) and
# (NUM_SCALE_BINS − 1)/ln(SCALE_MAX/SCALE_MIN), as JAX rounds them
LN_MIN = -2.207274913787842
INV_STEP = 9.896079063415527

_LOG2E = 1.4426950216293335
_LN2_HI, _LN2_LO = 0.693145751953125, 1.428606765330187e-06
_EXP_Q = (0.5, 0.1666666716337204, 0.04166646674275398, 0.0083332983776927,
          0.0013933652080595493, 0.000198992871446535)
_LOG_LN2_HI, _LOG_LN2_LO = 0.6931381225585938, 9.05800061445916e-06
_LG = (0.6666666269302368, 0.40000972151756287, 0.2849878668785095,
       0.24279078841209412)
_SQRT2 = 1.4142135381698608
_TINY, _TWO25 = 1.1754943508222875e-38, 33554432.0
_TANH_P = (-0.3333333432674408, 0.13333304226398468, -0.05395938828587532,
           0.02176986075937748, -0.00834672525525093, 0.0022956032771617174)
_GELU_C, _GELU_A = 0.7978845834732056, 0.044714998453855515


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k for int32 k in [−126, 127], exactly."""
    return ((k + 127) << 23).view(torch.float32)


def exp_fixed(x: torch.Tensor) -> torch.Tensor:
    """exp of float32 ``x`` in basic fp32 operations: k = rint(x·log2 e),
    r = (x − k·ln2_hi) − k·ln2_lo, e^r = 1 + (r + r²·Q(r)), times 2^(k/2)
    and 2^(k − k/2)."""
    xc = torch.where(x > 89.0, 89.0, x)
    xc = torch.where(xc < -104.0, -104.0, xc)
    kf = torch.round(xc * _LOG2E)
    r = (xc - kf * _LN2_HI) - kf * _LN2_LO
    q = r * _EXP_Q[5] + _EXP_Q[4]
    for c in _EXP_Q[3::-1]:
        q = q * r + c
    p = 1.0 + (r + (r * r) * q)
    k = kf.to(torch.int32)
    k1 = k >> 1
    out = (p * _pow2(k1)) * _pow2(k - k1)
    return torch.where(torch.isnan(x), x, out)


def log_fixed(s: torch.Tensor) -> torch.Tensor:
    """log of float32 ``s`` ≥ 0 in basic fp32 operations (fdlibm's logf):
    s = m·2^e with m in (√2/2, √2], f = m − 1, log(1 + f) by f/(2 + f) and
    a polynomial; subnormals scaled by 2^25."""
    tiny = s < _TINY
    sc = torch.where(tiny, s * _TWO25, s).contiguous()
    bits = sc.view(torch.int32)
    e = (bits >> 23) - 127 - tiny.to(torch.int32) * 25
    m = ((bits & 0x7FFFFF) | 0x3F800000).view(torch.float32)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    e = e + big.to(torch.int32)
    f = m - 1.0
    sv = f / (2.0 + f)
    z = sv * sv
    w = z * z
    t1 = w * (_LG[1] + w * _LG[3])
    t2 = z * (_LG[0] + w * _LG[2])
    R = t2 + t1
    hfsq = (0.5 * f) * f
    dk = e.to(torch.float32)
    out = dk * _LOG_LN2_HI - ((hfsq - (sv * (hfsq + R) + dk * _LOG_LN2_LO))
                              - f)
    out = torch.where(s == 0.0, float("-inf"), out)
    out = torch.where(s == float("inf"), s, out)
    out = torch.where(torch.isnan(s), s, out)
    return torch.where(s < 0.0, float("nan"), out)


def tanh_fixed(u: torch.Tensor) -> torch.Tensor:
    """tanh of float32 ``u`` in basic fp32 operations: |u| < 0.625 by
    u + u³·P(u²), else 1 − 2/(exp(2|u|) + 1); the sign restored."""
    a = torch.abs(u)
    s = a * a
    P = s * _TANH_P[5] + _TANH_P[4]
    for c in _TANH_P[3::-1]:
        P = P * s + c
    small = a + a * (s * P)
    big = 1.0 - 2.0 / (exp_fixed(a + a) + 1.0)
    t = torch.where(a < 0.625, small, big)
    t = torch.where(u < 0.0, -t, t)
    return torch.where(torch.isnan(u), u, t)


def gelu_fixed(x: torch.Tensor) -> torch.Tensor:
    """The tanh-form GELU x·(½·(1 + tanh(c·(x + a·x³)))) on
    :func:`tanh_fixed`."""
    x3 = (x * x) * x
    inner = x + _GELU_A * x3
    return x * (0.5 * (1.0 + tanh_fixed(_GELU_C * inner)))


def _bins(s: torch.Tensor) -> torch.Tensor:
    b = torch.ceil((log_fixed(s) - LN_MIN) * INV_STEP)
    b = torch.where(b < 0.0, 0.0, b)
    b = torch.where(b > NUM_SCALE_BINS - 1.0, NUM_SCALE_BINS - 1.0, b)
    return torch.where(torch.isnan(b), 0.0, b).to(torch.int32)


class HsWeights(NamedTuple):
    """The hyper-synthesis weights in rows layout: ``w[co, tap·Cin + ci]``
    (the JAX kernel matrix transposed, taps in JAX's order), float32,
    contiguous; biases ``[Cout]``."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor


def hs_weights(h_s) -> HsWeights:
    """:class:`HsWeights` of a ``nic_torch.models.hyperprior.HyperSynthesis``
    (detached)."""
    from nic_torch.io.convert import conv_to_jax, conv_transpose_to_jax

    c1, c2, c3 = h_s.convs

    def rows(w):
        return w.detach().float().t().contiguous()

    def bias(c):
        return c.bias.detach().float().contiguous()

    return HsWeights(rows(conv_transpose_to_jax(c1.weight)), bias(c1),
                     rows(conv_transpose_to_jax(c2.weight)), bias(c2),
                     rows(conv_to_jax(c3.weight)), bias(c3))


def _convt_gelu_plain(x, w, b):
    """Layers 1 and 2: [B, C, H, W] → gelu(convT) [B, Co, 2H, 2W]."""
    B, C, H, W = x.shape
    co = w.shape[0]
    xp = F.pad(x, (1, 1, 1, 1))
    out = x.new_empty(B, co, 2 * H, 2 * W)
    for ry in (0, 1):
        for rx in (0, 1):
            acc = None
            for ay in (0, 1):
                for ax in (0, 1):
                    q = (ry + 2 * ay) * 4 + (rx + 2 * ax)
                    xs = xp[:, :, ry + ay:ry + ay + H, rx + ax:rx + ax + W]
                    t = x.new_zeros(B, co, H, W)
                    for ci in range(C):
                        t = t + xs[:, ci:ci + 1] * w[:, q * C + ci].view(
                            1, co, 1, 1)
                    acc = t if acc is None else acc + t
            out[:, :, ry::2, rx::2] = gelu_fixed(acc + b.view(1, co, 1, 1))
    return out


def hs_bins_plain(z: torch.Tensor, wt: HsWeights) -> tuple:
    """ẑ [B, N, h/4, w/4] float32 → (σ [B, M, h, w] float32, bins int32),
    in the kernel's order of operations, as torch ops."""
    s = _convt_gelu_plain(z, wt.w1, wt.b1)
    s = _convt_gelu_plain(s, wt.w2, wt.b2)
    B, C, H, W = s.shape
    m = wt.w3.shape[0]
    xp = F.pad(s, (1, 1, 1, 1))
    acc = s.new_zeros(B, m, H, W)
    for ky in range(3):
        for kx in range(3):
            xs = xp[:, :, ky:ky + H, kx:kx + W]
            for ci in range(C):
                acc = acc + xs[:, ci:ci + 1] * wt.w3[
                    :, (ky * 3 + kx) * C + ci].view(1, m, 1, 1)
    sigma = exp_fixed(acc + wt.b3.view(1, m, 1, 1))
    return sigma, _bins(sigma)


# csrc/hs_bins.cu's tiles: output channels a block computes, the shared
# bytes a block may take, and the blocks a layer's grid must have for
# 4-row tiles (2 an SM of the H100's 132)
_TC, SMEM_LIMIT, _FILL_BLOCKS = 16, 232_448, 2 * 132


def _chan_stride(n: int) -> int:
    """The staged channel stride: n padded to a multiple of 4 floats with
    stride/4 odd (``chan_stride`` in the source)."""
    s = (n + 3) & ~3
    return s + 4 if (s // 4) % 2 == 0 else s


def _smem(tw: int, tr: int, n: int) -> int:
    """Shared bytes of a block with tiles of tr rows × tw columns: the
    window (rows padded to 128 bytes), two weight buffers, two
    mbarriers."""
    s = _chan_stride(n)
    rp = ((tw + 2) * s + 31) & ~31
    return ((tr + 2) * rp + 2 * _TC * s) * 4 + 16


@functools.lru_cache(maxsize=64)
def launch_plan(n: int, m: int, h4: int, w4: int, batch: int = 1) -> tuple:
    """The kernel's three launches for widths n, m and ẑ [batch, n, h4,
    w4], as ``launch`` in the source picks them: per layer ``tw`` × ``tr``
    (16 × 4 where that grid has 264 blocks and its shared memory fits, else
    16 × 1, else 8 × 1), ``threads`` a block (4·tw), ``smem`` (shared bytes
    a block) and ``grid`` (x, y, z). Raises ValueError where no tile fits
    (n past 932), as the kernel refuses the call."""
    plan = []
    for h, w, co, phases in ((h4, w4, n, 4), (2 * h4, 2 * w4, n, 4),
                             (4 * h4, 4 * w4, m, 1)):
        co_tiles = -(-co // _TC)
        tw, tr = 16, 1
        if (-(-h // 4) * -(-w // 16) * co_tiles * batch * phases
                >= _FILL_BLOCKS and _smem(16, 4, n) <= SMEM_LIMIT):
            tr = 4
        elif _smem(16, 1, n) > SMEM_LIMIT:
            tw = 8
        smem = _smem(tw, tr, n)
        if smem > SMEM_LIMIT:
            raise ValueError(f"hs_bins: no tile of the kernel fits n = {n}: "
                             f"{smem} B of shared memory at {tw} columns, "
                             f"{SMEM_LIMIT} B a block")
        plan.append({"tw": tw, "tr": tr, "threads": 4 * tw, "smem": smem,
                     "grid": (-(-w // tw) * -(-h // tr), co_tiles,
                              batch * phases)})
    return tuple(plan)


def _check(z: torch.Tensor, wt: HsWeights) -> None:
    if z.dim() != 4 or z.dtype != torch.float32:
        raise ValueError(f"hs_bins: z must be float32 [B, N, h4, w4], got "
                         f"{z.dtype} {tuple(z.shape)}")
    n = z.shape[1]
    m = wt.w3.shape[0]
    want = {"w1": (n, 16 * n), "b1": (n,), "w2": (n, 16 * n), "b2": (n,),
            "w3": (m, 9 * n), "b3": (m,)}
    for name, shape in want.items():
        t = getattr(wt, name)
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"hs_bins: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected float32 {shape}")
        if t.device != z.device:
            raise ValueError(f"hs_bins: {name} on {t.device}, z on "
                             f"{z.device}")


def hs_bins_kernel(z: torch.Tensor, wt: HsWeights) -> tuple:
    """(σ, bins) of ẑ: a CUDA tensor launches ``csrc/hs_bins.cu`` (and
    raises if it does not build or launch), a CPU tensor runs
    :func:`hs_bins_plain`; the two give the same bits."""
    _check(z, wt)
    if z.device.type == "cpu":
        return hs_bins_plain(z, wt)
    if z.device.type != "cuda":
        raise ValueError(f"hs_bins runs on cuda or cpu, not {z.device}")
    from nic_torch.kernels import _build

    B, n, h4, w4 = z.shape
    m = wt.w3.shape[0]
    launch_plan(n, m, h4, w4, B)  # raises where the kernel has no tile
    lib = _build.load()
    z = z.contiguous()
    # the layers' outputs, channels-last with the kernel's padded channel
    # stride: the next layer's tensor copies take whole rows of pixels
    s = _chan_stride(n)
    s1 = torch.empty((B, 2 * h4, 2 * w4, s), dtype=torch.float32,
                     device=z.device)
    s2 = torch.empty((B, 4 * h4, 4 * w4, s), dtype=torch.float32,
                     device=z.device)
    sigma = torch.empty((B, m, 4 * h4, 4 * w4), dtype=torch.float32,
                        device=z.device)
    bins = torch.empty(sigma.shape, dtype=torch.int32, device=z.device)
    ws = [t.contiguous() for t in wt]
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = lib.nic_hs_bins(
            z.data_ptr(), *(t.data_ptr() for t in ws),
            s1.data_ptr(), s2.data_ptr(), sigma.data_ptr(), bins.data_ptr(),
            B, n, m, h4, w4, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("hs_bins kernel launch failed: "
                           + lib.nic_cuda_error_string(rc).decode())
    hs_bins_kernel.launches += 1
    return sigma, bins


hs_bins_kernel.launches = 0
