"""The v1 fused 2D decode: lattice gather, interpolation, PE and the whole
decoder MLP per pixel in one CUDA kernel (port of
``nic.kernels.decode_fused``).

For output pixel (r, c) at e = mip − 2·(level + 1) the kernel takes the
four G0 corners (a nearest upsample for e < 0, a strided take for e ≥ 0),
the G1 term (bilinear with the periodic fraction for e ≤ 0, the four
corners summed raw for e == 1 — the reference's step == 2 quirk — and
corner (0, 0) for e ≥ 2), triangular or sinusoidal PE per axis at
G1-resolution coordinates and the LOD constant, rounds that 5C + 2·PE + 1
feature row to the grid dtype and runs the 73→64 GELU → 64 GELU → 3
sigmoid MLP with grid-dtype dot inputs and fp32 sums. The feature row
never reaches device memory.

Its plain version is the gather decode (``decoder_input``, the JAX
package's XLA decode, :func:`nic_torch.grids.sample.gather_decode`) with
the kernel's arithmetic: the feature matrix rounded to the grid dtype and
the A&S erf GELU of ``_gelu_exact``. A CUDA tensor launches
``csrc/decode_fused.cu``: at H = 64 and 128 its tensor-core body
``decode_v1_mma`` (the first layer as m16n8 products from a per-warp
feature tile, then K1's tail, ``csrc/decode_mma.cuh``; fp32 dots as three
TF32 products, the GELU's exponential and reciprocal from the hardware),
so the two differ in summation order and by a few ulp; a CPU tensor runs
the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from nic_torch.grids.pyramid import pyramid_mip_levels
from nic_torch.grids.sample import decoder_input
from nic_torch.kernels._widths import decode_body, kernel_width, pad_mlp
from nic_torch.kernels.decode_fused_v2 import GELUS, _dot
from nic_torch.models.mlp import PARAM_NAMES

__all__ = ["decode_image_fused", "fused_rows_per_block", "decode_kernel_v1",
           "decode_kernel_v1_plain"]

# the per-pixel bodies by their id in csrc/decode_fused.cu (enum Body)
_BODY_IDS = {"decode_fused_v1_kernel": 0, "decode_v1_mma": 1,
             "decode_v1_wide": 2}


def fused_rows_per_block(decode_size: int, e: int, channels: int) -> int:
    """The JAX kernel's row block: ≥ 4096 pixels a block where the image
    allows it, a multiple of the G1 upsample factor, dividing the decode.
    Here it is the number of rows each CUDA block walks."""
    target = max(1, 4096 // max(decode_size, 1))
    rows = 8
    while rows < target and rows * 2 <= decode_size:
        rows *= 2
    f = 1 << max(0, 1 - e)  # G1 upsample factor
    rows = max(rows, f)
    while decode_size % rows:
        rows //= 2
    return max(rows, 1)


def _reach(n: int, e: int) -> int:
    """The last lattice index floor((n − 1)·2^e) an axis of n pixels
    samples."""
    return (n - 1) >> -e if e < 0 else (n - 1) << e


def _check(g0, g1, w1, b1, w2, b2, w3, b3, *, e, n, pe_channels):
    """Validate the v1 stage's operands."""
    tensors = (g0, g1, w1, b1, w2, b2, w3, b3)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("decode_kernel_v1: operands on different devices: "
                         f"{sorted(str(t.device) for t in tensors)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_kernel_v1: operands must be contiguous")
    if g0.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"grids must be float32 or bfloat16, not {g0.dtype}")
    if {g1.dtype, w1.dtype, w2.dtype, w3.dtype} != {g0.dtype}:
        raise ValueError("decode_kernel_v1: G1 and the weights must share the "
                         f"grid dtype {g0.dtype}")
    if g0.dim() != 3 or g1.dim() != 3 or g0.shape[0] != g1.shape[0]:
        raise ValueError("expected G0 [C, s0, s0] and G1 [C, s1, s1]")
    c, s0, s1 = g0.shape[0], g0.shape[1], g1.shape[1]
    if g0.shape[2] != s0 or g1.shape[2] != s1:
        raise ValueError("the v1 decode takes square grids")
    nfeat, hidden = w1.shape
    want = {"w1": (5 * c + 2 * pe_channels + 1, hidden), "b1": (hidden,),
            "w2": (hidden, hidden), "b2": (hidden,), "w3": (hidden, 3),
            "b3": (3,)}
    got = dict(zip(PARAM_NAMES, (t.shape for t in tensors[2:])))
    for k, shape in want.items():
        if tuple(got[k]) != shape:
            raise ValueError(f"{k} has shape {tuple(got[k])}, expected "
                             f"{shape}")
    if _reach(n, e) + 1 >= s0:
        raise ValueError(f"a {n}² decode at e={e} reaches G0 node "
                         f"{_reach(n, e) + 1}; G0 has {s0}")
    g1_last = _reach(n, e - 1) + (1 if e <= 1 else 0)
    if g1_last >= s1:
        raise ValueError(f"a {n}² decode at e={e} reaches G1 node {g1_last};"
                         f" G1 has {s1}")


def decode_kernel_v1_plain(g0, g1, w1, b1, w2, b2, w3, b3, *, e: int, n: int,
                           pe_channels: int, use_tri_pe: bool,
                           mip_level: int, rows: int = 1) -> torch.Tensor:
    """The kernel's function in torch ops → [n, n, 3] fp32: the gather
    decode's feature matrix (from fp32 copies of the grids) rounded to the
    grid dtype, then the MLP with grid-dtype dot inputs, fp32 sums and the
    A&S GELU. ``rows`` is the kernel's block and changes nothing here."""
    _check(g0, g1, w1, b1, w2, b2, w3, b3, e=e, n=n, pe_channels=pe_channels)
    act = GELUS["exact"]
    x = decoder_input((g0.float(), g1.float()), 0,
                      torch.zeros(2, dtype=torch.long), 2.0**e, n,
                      pe_channels=pe_channels, mip_level=mip_level, ndim=2,
                      use_tri_pe=use_tri_pe)
    x = x.to(g0.dtype).float()
    h = act(_dot(x, w1) + b1.float())
    h = act(_dot(h, w2) + b2.float())
    return torch.sigmoid(_dot(h, w3) + b3.float()).reshape(n, n, 3)


def decode_kernel_v1(g0, g1, w1, b1, w2, b2, w3, b3, *, e: int, n: int,
                     pe_channels: int, use_tri_pe: bool, mip_level: int,
                     rows: int) -> torch.Tensor:
    """The v1 decode of one mip (K3) → [n, n, 3] fp32; grids [C, s, s] and
    weights in one dtype (fp32 or bf16), ``rows`` rows per CUDA block.

    A CUDA tensor launches the hand-written kernel (and raises if it does
    not build or launch) with the body
    :func:`~nic_torch.kernels._widths.decode_body` names: the tensor-core
    ``decode_v1_mma`` at H = 64 and 128, the CUDA-core body at H = 16,
    ``decode_v1_wide`` at the multiples of 64 past 128 (another width
    zero-padded to the next of those), any F; a CPU tensor runs
    :func:`decode_kernel_v1_plain`. ``rows`` sizes the CUDA-core body's
    blocks.
    ``decode_kernel_v1.launches`` counts kernel launches."""
    kw = dict(e=e, n=n, pe_channels=pe_channels)
    _check(g0, g1, w1, b1, w2, b2, w3, b3, **kw)
    if g0.device.type == "cpu":
        return decode_kernel_v1_plain(g0, g1, w1, b1, w2, b2, w3, b3,
                                      use_tri_pe=use_tri_pe,
                                      mip_level=mip_level, rows=rows, **kw)
    if g0.device.type != "cuda":
        raise ValueError(f"decode_kernel_v1 runs on cuda or cpu, not "
                         f"{g0.device}")
    nfeat, hidden = w1.shape
    width = kernel_width("decode_v1", hidden)
    if width != hidden:
        return decode_kernel_v1(g0, g1, *pad_mlp(w1, b1, w2, b2, w3, b3,
                                                 width),
                                use_tri_pe=use_tri_pe, mip_level=mip_level,
                                rows=rows, **kw)
    if rows < 1:
        raise ValueError(f"rows must be positive, not {rows}")
    from nic_torch.kernels import _build

    lib = _build.load()
    # fp32 weights for the kernel; bf16 values upcast exactly
    w = [t.float().contiguous() for t in (w1, b1, w2, b2, w3, b3)]
    out = torch.empty((n, n, 3), dtype=torch.float32, device=g0.device)
    bf16 = g0.dtype == torch.bfloat16
    body = decode_body("decode_v1", hidden, "bf16" if bf16 else "fp32")
    pe_scale = -math.log(10000.0) / pe_channels if pe_channels else 0.0
    with torch.cuda.device(g0.device):
        stream = torch.cuda.current_stream(g0.device).cuda_stream
        rc = lib.nic_decode_fused_v1(
            g0.data_ptr(), g1.data_ptr(), *(t.data_ptr() for t in w),
            out.data_ptr(), n, g0.shape[0], g0.shape[1], g1.shape[1],
            hidden, e, pe_channels, int(use_tri_pe), ctypes.c_float(pe_scale),
            ctypes.c_float(float(mip_level)), rows, int(bf16),
            _BODY_IDS[body], stream)
    if rc != 0:
        raise RuntimeError("decode_fused kernel launch failed: "
                           + lib.nic_cuda_error_string(rc).decode())
    decode_kernel_v1.launches += 1
    return out


decode_kernel_v1.launches = 0


def decode_image_fused(fp, mlp, mip_level: int, *, cfg=None,
                       image_size: int | None = None,
                       mip_to_level: dict | None = None,
                       pe_channels: int = 6, use_tri_pe: bool = True,
                       dtype=None, out_dtype=torch.float32) -> torch.Tensor:
    """Full-image v1 decode at ``mip_level`` (2D pyramids) → [N, N, 3].

    ``fp``: the [C, S, S] pyramid; ``mlp``: the decoder parameters. Takes
    a :class:`~nic_torch.config.CompressionConfig` as ``cfg`` or explicit
    ``image_size``/``mip_to_level``/PE settings; ``dtype`` (e.g. bf16)
    rounds the grids and weights to it, and the dots take it."""
    if cfg is not None:
        image_size = cfg.image_size
        mip_to_level = pyramid_mip_levels(
            cfg.image_size, cfg.feature_pyramid_size, cfg.tf_no_mip)
        pe_channels = cfg.pe_channels
        use_tri_pe = cfg.tf_use_tri_pe
    fl = mip_to_level[mip_level]
    e = mip_level - (fl + 1) * 2
    n = image_size // (2**mip_level)
    g0, g1 = fp[fl * 2], fp[fl * 2 + 1]
    if dtype is not None:
        g0, g1 = g0.to(dtype), g1.to(dtype)
    w = [mlp[k].to(g0.dtype).contiguous() for k in PARAM_NAMES]
    out = decode_kernel_v1(
        g0.contiguous(), g1.contiguous(), *w, e=e, n=n,
        pe_channels=pe_channels, use_tri_pe=use_tri_pe, mip_level=mip_level,
        rows=fused_rows_per_block(n, e, g0.shape[0]))
    return out.to(out_dtype)
