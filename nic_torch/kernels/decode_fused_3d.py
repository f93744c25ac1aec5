"""The 3D folded decode with its per-voxel stage in one CUDA kernel (port
of ``nic.kernels.decode_fused_3d``, methods 3 and 4).

The JAX kernel (K5) reuses the 2D decode's body over the frames of a
volume, so this port reuses K1's CUDA kernel with a frame axis
(``csrc/decode_fused_v2.cu`` ``nic_decode_fused_3d``: one launch, frames
on ``blockIdx.z``). Two stages, as in the JAX package:

- the frame and column stage :func:`_prepare_3d`, plain PyTorch on the
  grids' device: fold W1 into the grids (method 4's sparse G0 changes
  only this fold), nearest-upsample the folded P volume along frames and
  columns, interpolate the folded C1 volume along frames and columns and
  fold frame-PE + column-PE + b1 + LOD into it (the row-interpolation
  weights sum to 1), and build the row-PE table;
- the per-voxel stage :func:`decode_kernel_3d`, for voxel (t, r, c):

      z1 = P[t, r//f, c] + (1−u)·C1v[t, r//f1, c] + u·C1v[t, r//f1+1, c]
           + peu[r],        rgb = sigmoid(gelu(gelu(z1)·W2 + b2)·W3 + b3)

  On a CUDA tensor it launches the kernel; on a CPU tensor it runs
  :func:`decode_kernel_3d_plain`, K1's plain version frame by frame.

Plane modes (``dtype``): ``None`` fp32; ``torch.bfloat16`` bf16 storage of
the folded volumes and of the full-resolution C1 and bf16 dot inputs;
``"i16"`` int16 planes with one scale from the true maxima of the P
volume and the full-resolution C1 (rounded half to even, as
``jnp.round``) and bf16 dot inputs; ``"surgical"`` is a 2D mode and
decodes fp32 here, as in the JAX package. Mips with e = mip − 2(fl+1) > 0
(thumbnails) decode through ``fast_decode``, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from nic_torch.core.encodings import sinusoidal_pe, triangular_pe
from nic_torch.grids.fastdecode import (_axis_take_up, fast_decode,
                                        precompute_first_layer)
from nic_torch.kernels._widths import PLANE_MODES, decode_body, kernel_width
from nic_torch.kernels.decode_fused_v2 import (_BODY_IDS, _GELU_IDS,
                                               _padded_planes,
                                               _check, decode_kernel_2d_plain)

__all__ = ["decode_volume_fused", "decode_kernel_3d", "decode_kernel_3d_plain",
           "kernel_covers_3d"]


def _axis_interp(plane: torch.Tensor, e: int, n: int,
                 axis: int) -> torch.Tensor:
    """Linear interpolation of ``plane`` at t = arange(n)·2^(e−1) along
    ``axis`` (the G1 sampling pattern at origin 0, e ≤ 0), in fp32 whatever
    the storage type."""
    f1 = 1 << (1 - e)
    tv = torch.arange(n, dtype=torch.float32, device=plane.device) * (
        2.0 ** (e - 1))
    shape = [1] * plane.dim()
    shape[axis] = n
    fv = (tv - torch.floor(tv)).reshape(shape)
    rep = torch.repeat_interleave(plane.narrow(axis, 0, n // f1 + 1), f1,
                                  dim=axis)             # [.., n + f1, ..]
    a = rep.narrow(axis, 0, n).float()
    b = rep.narrow(axis, f1, n).float()
    return (1.0 - fv) * a + fv * b


def _gate(mip_level: int, image_size: int, mip_to_level: dict, hidden: int):
    """(e, n, f, f1, covered) of a mip: the JAX kernel's geometry gate at
    its default R×C tiles, kept so both packages send each mip down the
    same path (the CUDA kernel masks ragged edges itself)."""
    e = mip_level - (mip_to_level[mip_level] + 1) * 2
    n = image_size // (2**mip_level)
    if e > 0:
        return e, n, None, None, False
    f = 1 << (-e) if e < 0 else 1
    f1 = 1 << (1 - e)
    rows = max(f1, f, min(n, 32))
    cols = min(n, 2048 if 2 * hidden == 128 else 1024)
    covered = not (n % rows or n < rows or n % cols or rows % f1
                   or rows % f)
    return e, n, f, f1, covered


def kernel_covers_3d(mip_level: int, image_size: int, mip_to_level: dict,
                     hidden: int) -> bool:
    """Will :func:`decode_volume_fused` run the kernel for this (mip,
    size), or decode through ``fast_decode``? Pure geometry, no compute."""
    return _gate(mip_level, image_size, mip_to_level, hidden)[-1]


def _prepare_3d(fp, mlp, mip_level: int, *, image_size: int,
                mip_to_level: dict, pe_channels: int, use_tri_pe: bool,
                sparse_g0: bool, dtype):
    """The frame and column stage on the grids' device. Returns ``None``
    outside the kernel's gate, else ``(pc [n, n/f, n, H], c1v [n, n/f1+1,
    n, H], pe_u [n, H], w2, b2, w3, b3, plane_scale, geom)``."""
    fl = mip_to_level[mip_level]
    e, n, f, f1, covered = _gate(mip_level, image_size, mip_to_level,
                                 mlp["w2"].shape[0])
    if not covered:
        return None
    i16 = dtype == "i16"
    if isinstance(dtype, str) and not i16:
        dtype = None  # "surgical" is a 2D mode: 3D decodes fp32
    storage = None if i16 else dtype
    device = fp[0].device

    p_vol, c1_vol, pe_blocks, w_lod, b1 = precompute_first_layer(
        fp, fl, mlp, ndim=3, channels=fp[fl * 2].shape[0],
        pe_channels=pe_channels, sparse_g0=sparse_g0)
    if storage is not None:
        p_vol, c1_vol = p_vol.to(storage), c1_vol.to(storage)

    # separable PE through W1: rows ride as the kernel's peu; frame and
    # column terms + b1 + LOD fold into C1
    t1 = torch.arange(n, dtype=torch.float32, device=device) * 2.0 ** (e - 1)
    pe_fn = triangular_pe if use_tri_pe else sinusoidal_pe
    table = pe_fn(t1[None, :], pe_channels).T              # [n, PE]
    a_frame = table @ pe_blocks[0]
    pe_u = table @ pe_blocks[1]
    a_col = table @ pe_blocks[2] + b1 + float(mip_level) * w_lod

    # C1 in real units: interpolated along frames and columns (fp32 in
    # every mode); rows stay at node resolution (+1 halo row)
    c1r = c1_vol[:, :n // f1 + 1]
    c1v = _axis_interp(_axis_interp(c1r, e, n, axis=0), e, n, axis=2)
    c1v = c1v + a_frame[:, None, None, :] + a_col[None, None, :, :]
    plane_scale = None
    if i16:
        # one P/C1 scale from the true maxima (P's node maximum bounds the
        # nearest samples; the full-resolution C1 exists in fp32 here)
        s = torch.clamp(torch.maximum(p_vol.abs().max(), c1v.abs().max()),
                        min=1e-12)
        inv = 32767.0 / s

        def q(a):  # round half to even, as jnp.round
            return torch.clamp(torch.round(a * inv), -32767.0,
                               32767.0).to(torch.int16)

        p_vol, c1v = q(p_vol), q(c1v)
        plane_scale = s / 32767.0
    # P: nearest upsample along frames and columns, rows at cell
    # resolution for the kernel's row stage
    pr = p_vol[:, :n // f]
    pc = _axis_take_up(_axis_take_up(pr, e, n, axis=0), e, n, axis=2)
    if not i16:
        c1v = c1v.to(pc.dtype)
        pe_u = pe_u.to(pc.dtype)

    w2, b2, w3, b3 = mlp["w2"], mlp["b2"], mlp["w3"], mlp["b3"]
    if dtype is not None:  # bf16 dot inputs in both reduced modes
        w2, w3 = w2.to(torch.bfloat16), w3.to(torch.bfloat16)
    geom = dict(n=n, f=f, f1=f1)
    return (pc.contiguous(), c1v.contiguous(), pe_u.contiguous(), w2, b2,
            w3, b3, plane_scale, geom)


def _check3(pc, c1v, pe_u, w2, b2, w3, b3, plane_scale, f, f1, gelu) -> int:
    """K1's operand checks on one frame, plus the frame axis."""
    if pc.dim() != 4 or c1v.dim() != 4 or pc.shape[0] != c1v.shape[0]:
        raise ValueError("expected pc [T, nr/f, ncl, H] and c1v [T, nr/f1+1, "
                         f"ncl, H], got {tuple(pc.shape)}, {tuple(c1v.shape)}")
    if not (pc.is_contiguous() and c1v.is_contiguous()):
        raise ValueError("decode_kernel_3d: pc and c1v must be contiguous")
    return _check(pc[0], c1v[0], pe_u, w2, b2, w3, b3, plane_scale, f, f1,
                  gelu)


def decode_kernel_3d_plain(pc, c1v, pe_u, w2, b2, w3, b3, plane_scale=None,
                           *, f: int, f1: int,
                           gelu: str = "exact") -> torch.Tensor:
    """The kernel's formula in torch ops (K1's plain version per frame) →
    [T, nr, ncl, 3] fp32."""
    _check3(pc, c1v, pe_u, w2, b2, w3, b3, plane_scale, f, f1, gelu)
    return torch.stack([
        decode_kernel_2d_plain(pc[t], c1v[t], pe_u, w2, b2, w3, b3,
                               plane_scale, f=f, f1=f1, gelu=gelu)
        for t in range(pc.shape[0])])


def decode_kernel_3d(pc, c1v, pe_u, w2, b2, w3, b3, plane_scale=None, *,
                     f: int, f1: int, gelu: str = "exact") -> torch.Tensor:
    """The per-voxel stage → [T, nr, ncl, 3] fp32.

    A CUDA tensor launches ``nic_decode_fused_3d`` (and raises if it does
    not build or launch) with K1's body for the width
    (:func:`~nic_torch.kernels._widths.decode_body`: ``decode_v2_mma`` at
    H ≥ 64, a width between zero-padded to the next multiple of 64); a
    CPU tensor runs :func:`decode_kernel_3d_plain`.
    ``decode_kernel_3d.launches`` counts kernel launches."""
    mode = _check3(pc, c1v, pe_u, w2, b2, w3, b3, plane_scale, f, f1, gelu)
    if pc.device.type == "cpu":
        return decode_kernel_3d_plain(pc, c1v, pe_u, w2, b2, w3, b3,
                                      plane_scale, f=f, f1=f1, gelu=gelu)
    if pc.device.type != "cuda":
        raise ValueError(f"decode_kernel_3d runs on cuda or cpu, not "
                         f"{pc.device}")
    nt = pc.shape[0]
    nr, hidden = pe_u.shape
    ncl = pc.shape[2]
    width = kernel_width("decode_v2", hidden)
    if width != hidden:
        return _padded_planes(decode_kernel_3d, width, pc, c1v, pe_u, w2, b2,
                              w3, b3, plane_scale, f=f, f1=f1, gelu=gelu)
    if any(t.data_ptr() % 16 for t in (pc, c1v, pe_u)):
        raise ValueError("pc, c1v and pe_u must be 16-byte aligned")
    from nic_torch.kernels import _build

    lib = _build.load()
    w2f, w3f = w2.float().contiguous(), w3.float().contiguous()
    scale = 1.0 if plane_scale is None else float(plane_scale)
    out = torch.empty((nt, nr, ncl, 3), dtype=torch.float32, device=pc.device)
    with torch.cuda.device(pc.device):
        stream = torch.cuda.current_stream(pc.device).cuda_stream
        rc = lib.nic_decode_fused_3d(
            pc.data_ptr(), c1v.data_ptr(), pe_u.data_ptr(), w2f.data_ptr(),
            b2.data_ptr(), w3f.data_ptr(), b3.data_ptr(),
            ctypes.c_float(scale), out.data_ptr(), nt, nr, ncl, hidden, f,
            f1, mode, _GELU_IDS[gelu],
            _BODY_IDS[decode_body("decode_v2", hidden, PLANE_MODES[mode])],
            stream)
    if rc != 0:
        raise RuntimeError("decode_fused_3d kernel launch failed: "
                           + lib.nic_cuda_error_string(rc).decode())
    decode_kernel_3d.launches += 1
    return out


decode_kernel_3d.launches = 0


def decode_volume_fused(fp, mlp, mip_level: int, *, image_size: int,
                        mip_to_level: dict, pe_channels: int,
                        use_tri_pe: bool = True, sparse_g0: bool = False,
                        g1_quirk: bool = True, dtype=None,
                        gelu: str = "exact") -> torch.Tensor:
    """Full-volume 3D decode: the frame and column stage, then one kernel
    launch over all frames (``fast_decode`` for mips outside the gate).
    Returns [n, n, n, 3] fp32, n = image_size // 2^mip_level."""
    prep = _prepare_3d(fp, mlp, mip_level, image_size=image_size,
                       mip_to_level=mip_to_level, pe_channels=pe_channels,
                       use_tri_pe=use_tri_pe, sparse_g0=sparse_g0,
                       dtype=dtype)
    if prep is None:
        return fast_decode(fp, mlp, mip_level, image_size=image_size,
                           mip_to_level=mip_to_level, pe_channels=pe_channels,
                           use_tri_pe=use_tri_pe, ndim=3, sparse_g0=sparse_g0,
                           g1_quirk=g1_quirk).float()
    pc, c1v, pe_u, w2, b2, w3, b3, plane_scale, geom = prep
    return decode_kernel_3d(pc, c1v, pe_u, w2, b2, w3, b3, plane_scale,
                            f=geom["f"], f1=geom["f1"], gelu=gelu)
