"""The 2D folded decode with its per-pixel stage in one CUDA kernel
(port of ``nic.kernels.decode_fused_v2``).

Two stages, as in the JAX package:

- the column stage :func:`_prepare_2d`, plain PyTorch on the tensors'
  device: fold W1 into the grids (``nic_torch.grids.fastdecode``),
  nearest-upsample the folded P plane along columns, interpolate the folded
  C1 plane along columns and fold column-PE + b1 + LOD into it, and build
  the row-PE table; in the reduced-precision modes it also rounds the
  planes to their storage type;
- the per-pixel stage :func:`decode_kernel_2d`: for output pixel (r, c),

      z1 = P[r//f, c] + (1−u)·C1v[r//f1, c] + u·C1v[r//f1+1, c] + peu[r]
      rgb = sigmoid(gelu(gelu(z1)·W2 + b2)·W3 + b3),   u = (r % f1)/f1

  (in i16 mode P and C1v are first multiplied by ``plane_scale``). On a
  CUDA tensor it launches ``csrc/decode_fused_v2.cu``; on a CPU tensor it
  runs :func:`decode_kernel_2d_plain`, the same formula in torch ops.

``z1_matmul`` (``True`` or ``"auto"``, as in the JAX package) sends the
per-pixel stage through :func:`decode_kernel_z1mm` instead (K2,
``csrc/decode_z1mm.cu``): per tile
of R rows, z1 is the product of the static ``[A0 | A1]`` matrix with the
tile's stacked P and C1v rows, then the same MLP tail; ``"auto"`` takes it
exactly where JAX's lane-packed layout would (a geometric predicate), and
int16 planes refuse it.

Plane modes (``dtype`` of :func:`decode_image_fused_v2`): ``None`` fp32
planes and fp32 dots; ``torch.bfloat16`` bf16 plane storage and bf16 dot
inputs; ``"i16"`` int16 fixed-point planes × one shared scale with bf16
dot inputs; ``"surgical"`` fp32 planes with bf16 dot inputs. The
arithmetic is fp32 in every mode and the dots accumulate in fp32.

Mips whose geometry the kernel does not cover (thumbnails with e > 0)
decode through ``fast_decode`` on the same device, as in the JAX package:
a geometric gate, not a device fallback.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from nic_torch.core.encodings import sinusoidal_pe, triangular_pe
from nic_torch.grids.fastdecode import (_axis_take_up, fast_decode,
                                        precompute_first_layer)
from nic_torch.kernels._widths import (PLANE_MODES, decode_body,
                                       kernel_width, pad_hidden, pad_mlp)

__all__ = ["decode_image_fused_v2", "decode_kernel_2d",
           "decode_kernel_2d_plain", "decode_kernel_z1mm",
           "decode_kernel_z1mm_plain", "z1_matrix", "kernel_covers_2d",
           "GELUS"]


# ---- the six GELUs, coefficients exactly as the JAX package's ----------

def _erf(x: torch.Tensor) -> torch.Tensor:
    """erf via Abramowitz & Stegun 7.1.26 (|err| ≤ 1.5e-7)."""
    a1, a2, a3, a4, a5 = (
        0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    )
    p = 0.3275911
    ax = torch.abs(x)
    t = 1.0 / (1.0 + p * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def _gelu_exact(x):
    return 0.5 * x * (1.0 + _erf(x * (1.0 / math.sqrt(2.0))))


def _gelu_tanh(x):
    c = 0.7978845608028654  # sqrt(2/pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def _gelu_quick(x):
    return x * torch.sigmoid(1.702 * x)


# gelu(x) = x/2 + an even polynomial in x² (fit on [-4, 4], exact
# saturation outside; max |err| 3.6e-4)
_GELU_POLY_C = (
    6.063213460406e-06, 3.988279991626e-01, -6.618728056429e-02,
    9.689185146121e-03, -1.058572076001e-03, 8.262109727744e-05,
    -4.286269517788e-06, 1.303813961965e-07, -1.739696971198e-09,
)


def _horner(coefs, v, like):
    acc = torch.full_like(like, coefs[-1])
    for co in coefs[-2::-1]:
        acc = acc * v + co
    return acc


def _gelu_poly(x):
    y = 0.5 * x + _horner(_GELU_POLY_C, x * x, x)
    return torch.where(x > 4.0, x, torch.where(x < -4.0, 0.0, y))


# erf(z) ≈ z·p(v), v = 2z²/B² − 1, B = 3.9188: a degree-16 polynomial
# (max |Δerf| 1.6e-7)
_ERF_COEFS_V = (
    0.36084712417350057, -0.18016249079808996, 0.1341197098397116,
    -0.1092031839839547, 0.09062792421675198, -0.0739776908469364,
    0.0581495074523071, -0.0435456971886969, 0.030547198182092263,
    -0.019592030398672442, 0.012233327075772783, -0.008136814407460185,
    0.004267563623966739, -0.001049107566569795, 0.0006108818677171472,
    -0.0009324910271702735, 0.0003764209620008347,
)
_ERF_B2 = 3.9188 * 3.9188


def _gelu_erfpoly(x):
    v = x * x * (1.0 / _ERF_B2) - 1.0
    erf = (x * 0.7071067811865476) * _horner(_ERF_COEFS_V, v, x)
    y = 0.5 * x * (1.0 + erf)
    lim = 5.54212  # √2·B
    return torch.where(x > lim, x, torch.where(x < -lim, 0.0, y))


# erf(x/√2) ≈ tanh(x·p(x²)), p an odd 6-coefficient fit on [0, 5]
# (max |Δgelu| ≤ 1.44e-6)
_TANHERF_C = (
    0.7978726340911436, 0.03636569087245362, -5.790097523219499e-05,
    -4.725206537106127e-05, 2.7966636242742257e-06,
    -5.653256767756493e-08,
)


def _gelu_tanherf(x):
    p = _horner(_TANHERF_C, x * x, x)
    y = 0.5 * x * (1.0 + torch.tanh(p * x))
    return torch.where(x > 5.0, x, torch.where(x < -5.0, 0.0, y))


GELUS = {"exact": _gelu_exact, "tanh": _gelu_tanh, "quick": _gelu_quick,
         "poly": _gelu_poly, "erfpoly": _gelu_erfpoly,
         "tanherf": _gelu_tanherf}
_GELU_IDS = {name: i for i, name in enumerate(GELUS)}  # order of the .cu
# K1/K5's per-pixel bodies by their id in csrc/decode_fused_v2.cu (enum
# Body)
_BODY_IDS = {"decode_fused_v2_kernel": 0, "decode_v2_mma": 1}
# K2's per-pixel bodies by their id in csrc/decode_z1mm.cu (enum Body)
_Z1MM_BODY_IDS = {"decode_z1mm_mma": 1, "decode_z1mm_wide": 2}


# ---- the per-pixel stage: plain version and CUDA wrapper ---------------

def _padded_planes(fn, width: int, pc, c1v, pe_u, w2, b2, w3, b3, *rest,
                   **kw):
    """``fn`` (a per-pixel or per-voxel stage) on its planes and tail
    weights zero-padded along the hidden axis to ``width`` (``_widths``:
    the padded units add exactly 0 to the output)."""
    _, _, w2, b2, w3, b3 = pad_mlp(None, None, w2, b2, w3, b3, width)
    return fn(pad_hidden(pc, width), pad_hidden(c1v, width),
              pad_hidden(pe_u, width), w2, b2, w3, b3, *rest, **kw)


# (plane dtype, dot dtype) → the kernel's plane mode; the row-PE table is
# stored like the planes in bf16 mode and fp32 otherwise
_MODES = {
    (torch.float32, torch.float32): 0,    # fp32
    (torch.bfloat16, torch.bfloat16): 1,  # bf16
    (torch.int16, torch.bfloat16): 2,     # i16
    (torch.float32, torch.bfloat16): 3,   # surgical
}


def _check(pc, c1v, pe_u, w2, b2, w3, b3, plane_scale, f, f1, gelu) -> int:
    """Validate the per-pixel stage's operands; returns the plane mode."""
    tensors = (pc, c1v, pe_u, w2, b2, w3, b3) + (
        () if plane_scale is None else (plane_scale,))
    if len({t.device for t in tensors}) != 1:
        raise ValueError("decode_kernel_2d: operands on different devices: "
                         f"{sorted(str(t.device) for t in tensors)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_kernel_2d: operands must be contiguous")
    if gelu not in GELUS:
        raise ValueError(f"unknown gelu {gelu!r}; one of {list(GELUS)}")
    mode = _MODES.get((pc.dtype, w2.dtype))
    if mode is None:
        raise ValueError(f"no plane mode for planes {pc.dtype} with dots in "
                         f"{w2.dtype}")
    pe_dtype = torch.bfloat16 if mode == 1 else torch.float32
    dtypes = (c1v.dtype, pe_u.dtype, w3.dtype, b2.dtype, b3.dtype)
    if dtypes != (pc.dtype, pe_dtype, w2.dtype, torch.float32, torch.float32):
        raise ValueError("decode_kernel_2d: dtypes (c1v, pe_u, w3, b2, b3) = "
                         f"{dtypes} do not fit plane mode {mode}")
    if (plane_scale is not None) != (mode == 2):
        raise ValueError("plane_scale is given exactly for int16 planes")
    if pc.dim() != 3 or c1v.dim() != 3 or pe_u.dim() != 2:
        raise ValueError("expected pc [nr/f, ncl, H], c1v [nr/f1+1, ncl, H], "
                         "pe_u [nr, H]")
    nr, hidden = pe_u.shape
    ncl = pc.shape[1]
    for k in (f, f1):
        if k < 1 or k & (k - 1):
            raise ValueError(f"f={f}, f1={f1}: both must be powers of two")
    if nr % f or nr % f1:
        raise ValueError(f"{nr} rows are not a multiple of f={f} and f1={f1}")
    want = {"pc": (nr // f, ncl, hidden), "c1v": (nr // f1 + 1, ncl, hidden),
            "w2": (hidden, hidden), "b2": (hidden,), "w3": (hidden, 3),
            "b3": (3,)}
    got = {"pc": pc.shape, "c1v": c1v.shape, "w2": w2.shape, "b2": b2.shape,
           "w3": w3.shape, "b3": b3.shape}
    for k, shape in want.items():
        if tuple(got[k]) != shape:
            raise ValueError(f"{k} has shape {tuple(got[k])}, expected "
                             f"{shape}")
    if plane_scale is not None and (plane_scale.numel() != 1
                                    or plane_scale.dtype != torch.float32):
        raise ValueError("plane_scale must be one float32 value")
    return mode


def _dot(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h·w with inputs rounded to w's dtype and fp32 sums."""
    if w.dtype == torch.float32:
        return h @ w
    return h.to(w.dtype).float() @ w.float()


def _tail_plain(z1, pe_u, w2, b2, w3, b3, gelu: str) -> torch.Tensor:
    """The MLP tail on the first-layer sums ``z1`` [nr, ncl, H] plus the
    row-PE table → [nr, ncl, 3] fp32."""
    act = GELUS[gelu]
    h = act(z1 + pe_u.float()[:, None, :])
    h = act(_dot(h, w2) + b2)
    return torch.sigmoid(_dot(h, w3) + b3)


def decode_kernel_2d_plain(pc, c1v, pe_u, w2, b2, w3, b3, plane_scale=None,
                           *, f: int, f1: int,
                           gelu: str = "exact") -> torch.Tensor:
    """The kernel's formula in torch ops → [nr, ncl, 3] fp32."""
    _check(pc, c1v, pe_u, w2, b2, w3, b3, plane_scale, f, f1, gelu)
    nr = pe_u.shape[0]
    r = torch.arange(nr, device=pc.device)
    pcf, c1f = pc.float(), c1v.float()
    if plane_scale is not None:
        pcf, c1f = pcf * plane_scale, c1f * plane_scale
    ia = r // f1
    u = ((r % f1).float() / f1)[:, None, None]
    z1 = pcf[r // f] + ((1.0 - u) * c1f[ia] + u * c1f[ia + 1])
    return _tail_plain(z1, pe_u, w2, b2, w3, b3, gelu)


def decode_kernel_2d(pc, c1v, pe_u, w2, b2, w3, b3, plane_scale=None, *,
                     f: int, f1: int, gelu: str = "exact") -> torch.Tensor:
    """The per-pixel stage → [nr, ncl, 3] fp32.

    A CUDA tensor launches the hand-written kernel (and raises if it does
    not build or launch) with the body
    :func:`~nic_torch.kernels._widths.decode_body` names: the tensor-core
    ``decode_v2_mma`` at H = 64, 128 and any multiple of 64 past them
    (another width zero-padded to the next of those), the CUDA-core body
    at H = 16; a CPU tensor runs :func:`decode_kernel_2d_plain`.
    ``decode_kernel_2d.launches`` counts kernel launches."""
    mode = _check(pc, c1v, pe_u, w2, b2, w3, b3, plane_scale, f, f1, gelu)
    if pc.device.type == "cpu":
        return decode_kernel_2d_plain(pc, c1v, pe_u, w2, b2, w3, b3,
                                      plane_scale, f=f, f1=f1, gelu=gelu)
    if pc.device.type != "cuda":
        raise ValueError(f"decode_kernel_2d runs on cuda or cpu, not "
                         f"{pc.device}")
    nr, hidden = pe_u.shape
    ncl = pc.shape[1]
    width = kernel_width("decode_v2", hidden)
    if width != hidden:
        return _padded_planes(decode_kernel_2d, width, pc, c1v, pe_u, w2, b2,
                              w3, b3, plane_scale, f=f, f1=f1, gelu=gelu)
    if any(t.data_ptr() % 16 for t in (pc, c1v, pe_u)):
        raise ValueError("pc, c1v and pe_u must be 16-byte aligned")
    from nic_torch.kernels import _build

    lib = _build.load()
    # the kernel reads fp32 weights; in the bf16-dot modes they already
    # hold bf16 values, so the upcast is exact
    w2f, w3f = w2.float().contiguous(), w3.float().contiguous()
    scale = 1.0 if plane_scale is None else float(plane_scale)
    out = torch.empty((nr, ncl, 3), dtype=torch.float32, device=pc.device)
    with torch.cuda.device(pc.device):
        stream = torch.cuda.current_stream(pc.device).cuda_stream
        rc = lib.nic_decode_fused_v2(
            pc.data_ptr(), c1v.data_ptr(), pe_u.data_ptr(), w2f.data_ptr(),
            b2.data_ptr(), w3f.data_ptr(), b3.data_ptr(),
            ctypes.c_float(scale), out.data_ptr(), nr, ncl, hidden, f, f1,
            mode, _GELU_IDS[gelu],
            _BODY_IDS[decode_body("decode_v2", hidden, PLANE_MODES[mode])],
            stream)
    if rc != 0:
        raise RuntimeError("decode_fused_v2 kernel launch failed: "
                           + lib.nic_cuda_error_string(rc).decode())
    decode_kernel_2d.launches += 1
    return out


decode_kernel_2d.launches = 0


# ---- K2: the z1-matmul per-pixel stage -----------------------------------

def z1_matrix(R: int, f: int, f1: int, device=None) -> torch.Tensor:
    """The static ``[A0 | A1]`` matrix [R, R/f + R/f1 + 1] of a tile of R
    rows (nic/kernels/decode_fused_v2.py:338-345): A0[r, r//f] = 1,
    A1[r, r//f1] = 1 − fu, A1[r, r//f1 + 1] = fu, fu = (r % f1)/f1 (exact
    in bf16)."""
    k0, m = R // f, R // f1
    a = torch.zeros((R, k0 + m + 1), dtype=torch.float32)
    for r in range(R):
        fu = (r % f1) / f1
        a[r, r // f] = 1.0
        a[r, k0 + r // f1] = 1.0 - fu
        a[r, k0 + r // f1 + 1] += fu
    return a.to(device)


@functools.lru_cache(maxsize=None)
def _z1mm_operand(R: int, f: int, f1: int, device: torch.device) -> tuple:
    """K2's static matrix as its entry point takes it, on ``device``, and
    the count of its columns over P rows: ``z1_matrix`` with A0 dropped
    when f == 1 (P is then added as it is). Built once per geometry and
    device, so that a call copies nothing from the host."""
    a = z1_matrix(R, f, f1, device)
    if f == 1:
        return a[:, R:].contiguous(), 0
    return a, R // f


def _check_z1mm(pc, c1v, pe_u, w2, b2, w3, b3, f, f1, R, gelu) -> int:
    mode = _check(pc, c1v, pe_u, w2, b2, w3, b3, None, f, f1, gelu)
    nr = pe_u.shape[0]
    if R < 8 or R & (R - 1) or nr % R or R % f or R % f1:
        raise ValueError(f"tile rows R={R} must be a power of two ≥ 8 that "
                         f"divides {nr} rows and is a multiple of f={f} and "
                         f"f1={f1}")
    return mode


def _z1mm_sums(pc, c1v, *, f: int, f1: int, R: int) -> torch.Tensor:
    """K2's first-layer sums z1 [nr, ncl, H], in fp32 (float64 for float64
    planes): per tile t of R rows, A0·P[t·R/f : (t+1)·R/f] + A1·C1v[t·m :
    t·m + m + 1] (A0 is the identity for f == 1 and P is added as it is,
    as in JAX)."""
    dtype = torch.promote_types(pc.dtype, torch.float32)
    nr, ncl, hidden = pc.shape[0] * f, pc.shape[1], pc.shape[2]
    k0, m, nt = R // f, R // f1, nr // R
    a = z1_matrix(R, f, f1, pc.device).to(dtype)
    rows = (torch.arange(nt, device=pc.device)[:, None] * m
            + torch.arange(m + 1, device=pc.device)[None, :])
    c1t = c1v.to(dtype)[rows]                              # [nt, m+1, ncl, H]
    z1 = torch.einsum("rj,tjch->trch", a[:, k0:], c1t)
    if f == 1:
        z1 = z1 + pc.to(dtype).reshape(nt, R, ncl, hidden)
    else:
        pt = pc.to(dtype).reshape(nt, k0, ncl, hidden)
        z1 = torch.einsum("rj,tjch->trch", a[:, :k0], pt) + z1
    return z1.reshape(nr, ncl, hidden)


def decode_kernel_z1mm_plain(pc, c1v, pe_u, w2, b2, w3, b3, *, f: int,
                             f1: int, R: int,
                             gelu: str = "exact") -> torch.Tensor:
    """K2's formula in torch ops → [nr, ncl, 3] fp32: the first-layer sums
    of :func:`_z1mm_sums` in fp32, then the tail."""
    _check_z1mm(pc, c1v, pe_u, w2, b2, w3, b3, f, f1, R, gelu)
    return _tail_plain(_z1mm_sums(pc, c1v, f=f, f1=f1, R=R), pe_u, w2, b2,
                       w3, b3, gelu)


def decode_kernel_z1mm(pc, c1v, pe_u, w2, b2, w3, b3, *, f: int, f1: int,
                       R: int, gelu: str = "exact") -> torch.Tensor:
    """The z1-matmul per-pixel stage (K2) → [nr, ncl, 3] fp32; float or
    bf16 planes (int16 planes cannot feed its product).

    A CUDA tensor launches the hand-written kernel (and raises if it does
    not build or launch) with the body
    :func:`~nic_torch.kernels._widths.decode_body` names: at H = 64 and
    128 ``decode_z1mm_mma``, the product and K1's tail on the tensor
    cores (a narrower width zero-padded to 64), past 128 the wide body
    ``decode_z1mm_wide`` (a width between multiples of 64 zero-padded to
    the next); a CPU tensor runs :func:`decode_kernel_z1mm_plain`.
    ``decode_kernel_z1mm.launches`` counts kernel launches."""
    mode = _check_z1mm(pc, c1v, pe_u, w2, b2, w3, b3, f, f1, R, gelu)
    if pc.device.type == "cpu":
        return decode_kernel_z1mm_plain(pc, c1v, pe_u, w2, b2, w3, b3, f=f,
                                        f1=f1, R=R, gelu=gelu)
    if pc.device.type != "cuda":
        raise ValueError(f"decode_kernel_z1mm runs on cuda or cpu, not "
                         f"{pc.device}")
    nr, hidden = pe_u.shape
    ncl = pc.shape[1]
    width = kernel_width("decode_z1mm", hidden)
    if width != hidden:
        return _padded_planes(decode_kernel_z1mm, width, pc, c1v, pe_u, w2,
                              b2, w3, b3, f=f, f1=f1, R=R, gelu=gelu)
    if any(t.data_ptr() % 16 for t in (pc, c1v, pe_u)):
        raise ValueError("pc, c1v and pe_u must be 16-byte aligned")
    from nic_torch.kernels import _build

    lib = _build.load()
    a, kp = _z1mm_operand(R, f, f1, pc.device)
    w2f, w3f = w2.float().contiguous(), w3.float().contiguous()
    out = torch.empty((nr, ncl, 3), dtype=torch.float32, device=pc.device)
    with torch.cuda.device(pc.device):
        stream = torch.cuda.current_stream(pc.device).cuda_stream
        rc = lib.nic_decode_z1mm(
            pc.data_ptr(), c1v.data_ptr(), pe_u.data_ptr(), a.data_ptr(),
            w2f.data_ptr(), b2.data_ptr(), w3f.data_ptr(), b3.data_ptr(),
            out.data_ptr(), nr, ncl, hidden, R, a.shape[1], kp, R // f1,
            int(f == 1), mode, _GELU_IDS[gelu],
            _Z1MM_BODY_IDS[decode_body("decode_z1mm", hidden,
                                       PLANE_MODES[mode])], stream)
    if rc != 0:
        raise RuntimeError("decode_fused_v2 z1-matmul kernel launch failed: "
                           + lib.nic_cuda_error_string(rc).decode())
    decode_kernel_z1mm.launches += 1
    return out


decode_kernel_z1mm.launches = 0


# ---- geometry gate and column stage ------------------------------------

def _geometry_ok(e, nr, ncl, R, C, f, f1) -> bool:
    """The JAX kernel's static geometry gate at its default R×C tiles,
    kept so both packages send each mip down the same path (the CUDA
    kernel itself masks ragged edges and has no tile-size limits)."""
    return not (e > 0 or nr % R or nr < R or ncl % C or R % f1 or R % f)


def _hw(image_size) -> tuple[int, int]:
    return ((image_size, image_size) if isinstance(image_size, int)
            else tuple(image_size))


def _gate(mip_level, image_size, mip_to_level, hidden):
    """(e, nr, ncl, f, f1, R, C, covered) for a mip at JAX's default R×C
    tiles; e > 0 is never covered."""
    e = mip_level - (mip_to_level[mip_level] + 1) * 2
    nr, ncl = (s // (2**mip_level) for s in _hw(image_size))
    if e > 0:
        return e, nr, ncl, None, None, None, None, False
    f = 1 << (-e) if e < 0 else 1
    f1 = 1 << (1 - e)
    R = max(8, f1)
    C = min(ncl, 2048 if 2 * hidden == 128 else 1024)
    return e, nr, ncl, f, f1, R, C, _geometry_ok(e, nr, ncl, R, C, f, f1)


def kernel_covers_2d(mip_level: int, image_size, mip_to_level: dict,
                     hidden: int) -> bool:
    """Will :func:`decode_image_fused_v2` run the kernel for this (mip,
    size), or decode through ``fast_decode``? Pure geometry, no compute."""
    return _gate(mip_level, image_size, mip_to_level, hidden)[-1]


def _prepare_2d(fp, mlp, mip_level: int, *, image_size, mip_to_level: dict,
                pe_channels: int, use_tri_pe: bool, dtype):
    """The column stage on the grids' device. Returns ``None`` when the
    geometry is outside the kernel's gate, else ``(pc, c1v, pe_u, w2, b2,
    w3, b3, plane_scale, geom)`` with ``geom`` the kernel's ``f``/``f1``,
    the output size ``n`` × ``nc``, JAX's tile rows ``R`` and its
    lane-packing predicate ``packed``."""
    fl = mip_to_level[mip_level]
    hidden = mlp["w2"].shape[0]
    e, nr, ncl, f, f1, R, C, covered = _gate(mip_level, image_size,
                                             mip_to_level, hidden)
    if not covered:
        return None
    device = fp[0].device
    surgical = dtype == "surgical"
    i16 = dtype == "i16"
    plane_dtype = None if (surgical or i16) else dtype

    p_plane, c1_plane, pe_blocks, w_lod, _ = precompute_first_layer(
        fp, fl, mlp, ndim=2, channels=fp[fl * 2].shape[0],
        pe_channels=pe_channels)
    if plane_dtype is not None:
        # the one storage rounding of the fp32 folds, at node resolution
        p_plane = p_plane.to(plane_dtype)
        c1_plane = c1_plane.to(plane_dtype)

    # column sample positions t_v = v·2^(e−1): C1 nodes v // f1 and +1
    tv = torch.arange(ncl, dtype=torch.float32, device=device) * 2.0 ** (e - 1)
    fv = (tv - torch.floor(tv))[None, :, None]
    rows, cols_nodes = nr // f1 + 1, ncl // f1 + 1

    # separable PE folded through W1; the column term + b1 + LOD fold into
    # C1 (the row-interp weights sum to 1)
    tu = torch.arange(nr, dtype=torch.float32, device=device) * 2.0 ** (e - 1)
    pe_fn = triangular_pe if use_tri_pe else sinusoidal_pe
    table_u = pe_fn(tu[None, :], pe_channels).T  # [NR, PE]
    pe_u = table_u @ pe_blocks[0]  # [NR, H]
    table_v = table_u if ncl == nr else pe_fn(tv[None, :], pe_channels).T
    a_col = table_v @ pe_blocks[1] + mlp["b1"] + float(mip_level) * w_lod

    plane_scale = None
    if i16:
        # one P/C1 scale from the node-resolution maxima (upsample and
        # interpolation are convex, so they bound the full-resolution
        # values); |a_col| joins C1's bound
        s = torch.clamp(torch.maximum(
            p_plane.abs().max(), c1_plane.abs().max() + a_col.abs().max()),
            min=1e-12)
        inv = 32767.0 / s

        def qnode(a):
            return torch.clamp(torch.round(a * inv), -32767.0,
                               32767.0).to(torch.int16)

        p_plane, c1_plane = qnode(p_plane), qnode(c1_plane)
        a_col = a_col * inv  # a_col joins C1 in i16 units
        plane_scale = s / 32767.0

    # P: nearest column upsample, rows cropped to the nr/f the kernel reads
    pc = _axis_take_up(p_plane, e, ncl, axis=1)[: nr // f]
    rep = torch.repeat_interleave(c1_plane[:rows, :cols_nodes], f1, dim=1)
    c1a, c1b = rep[:, :ncl], rep[:, f1:ncl + f1]
    c1v = (1.0 - fv) * c1a.float() + fv * c1b.float() + a_col[None, :, :]
    if i16:
        # the one full-resolution rounding of C1 (i16 units); pe_u stays
        # fp32 and is added after the scale
        c1v = torch.clamp(torch.round(c1v), -32767.0,
                          32767.0).to(torch.int16)
    else:
        c1v = c1v.to(pc.dtype)
        pe_u = pe_u.to(pc.dtype)

    w2, b2, w3, b3 = mlp["w2"], mlp["b2"], mlp["w3"], mlp["b3"]
    if dtype is not None:  # bf16 dot inputs in every reduced mode
        mxu = torch.bfloat16 if (surgical or i16) else dtype
        w2, w3 = w2.to(mxu), w3.to(mxu)
    # JAX's lane-packing predicate (the layout its "auto" z1-matmul rides)
    packed = (2 * hidden == 128 and C % 16 == 0 and (R * C // 2) % 128 == 0
              and ncl % 2 == 0)
    geom = dict(n=nr, nc=ncl, f=f, f1=f1, R=R, packed=packed)
    return (pc.contiguous(), c1v.contiguous(), pe_u.contiguous(), w2, b2,
            w3, b3, plane_scale, geom)


def decode_image_fused_v2(fp, mlp, mip_level: int, *, image_size,
                          mip_to_level: dict, pe_channels: int,
                          use_tri_pe: bool = True, g1_quirk: bool = True,
                          dtype=None, gelu: str = "exact",
                          z1_matmul: bool | str = False) -> torch.Tensor:
    """Full-image 2D decode: the column stage, then the per-pixel kernel
    (``fast_decode`` for mips outside the gate). ``image_size`` is an int
    (square) or an (H, W) pair. ``z1_matmul``: False (K1), True (K2) or
    ``"auto"`` (K2 where JAX's lane-packed layout applies, K1 under int16
    planes). Returns [H, W, 3] fp32."""
    prep = _prepare_2d(
        fp, mlp, mip_level, image_size=image_size, mip_to_level=mip_to_level,
        pe_channels=pe_channels, use_tri_pe=use_tri_pe, dtype=dtype,
    )
    if prep is None:
        hw = _hw(image_size)
        return fast_decode(
            fp, mlp, mip_level, image_size=hw[0], mip_to_level=mip_to_level,
            pe_channels=pe_channels, use_tri_pe=use_tri_pe, ndim=2,
            g1_quirk=g1_quirk,
            n=None if hw[0] == hw[1] else tuple(s // (2**mip_level)
                                                for s in hw),
        )
    pc, c1v, pe_u, w2, b2, w3, b3, plane_scale, geom = prep
    z1mm = geom["packed"] if z1_matmul == "auto" else bool(z1_matmul)
    if z1mm and plane_scale is not None:
        if z1_matmul != "auto":
            raise ValueError(
                "z1_matmul=True is incompatible with dtype='i16' planes "
                "(int16 cannot feed the z1 product); use z1_matmul='auto' "
                "or a float plane dtype")
        z1mm = False  # auto: int16 planes take the per-row kernel
    if z1mm:
        return decode_kernel_z1mm(pc, c1v, pe_u, w2, b2, w3, b3, f=geom["f"],
                                  f1=geom["f1"], R=geom["R"], gelu=gelu)
    return decode_kernel_2d(pc, c1v, pe_u, w2, b2, w3, b3, plane_scale,
                            f=geom["f"], f1=geom["f1"], gelu=gelu)
