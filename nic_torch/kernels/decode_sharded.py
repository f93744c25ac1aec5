"""The fused decodes split over the ranks of a mesh (port of
``nic.kernels.decode_sharded``).

The output's outermost pixel axis, image rows in 2D and frames in 3D,
splits into one contiguous block per rank (over every mesh axis, rank
order), and every rank runs the unchanged per-pixel kernel on its block:

- 2D: the column stage :func:`~nic_torch.kernels.decode_fused_v2._prepare_2d`
  runs once per rank, replicated; the folded P plane and the row-PE
  table split by rows, and the C1 plane's block carries one duplicated
  halo node row (the interpolation's), so no rank needs another's data;
  K1 (``decode_kernel_2d``, never K2's z1 product) runs on the block;
- 3D: the frame and column stage runs once per rank; the per-frame P and
  C1 planes split by frames with no halo, and K5 (``decode_kernel_3d``)
  runs on the block.

:func:`decode_image_block` and :func:`decode_volume_block` are the work of
rank k of D as a pure function of (k, D), so one process can run every
rank; :func:`decode_image_fused_sharded` and
:func:`decode_volume_fused_sharded` add the collective, an all-gather of
the blocks. Each block is the whole decode's rows bit for bit (the
kernel's per-pixel arithmetic does not depend on where its block starts).
Where the mesh has one rank, the column stage declines the mip (the
folded thumbnails) or the rows (frames) do not split into blocks the
kernel's geometry takes, the single-device entry decodes, as in JAX.
"""

from __future__ import annotations

import torch

from nic_torch.kernels.decode_fused_3d import (_prepare_3d, decode_kernel_3d,
                                               decode_volume_fused)
from nic_torch.kernels.decode_fused_v2 import (_prepare_2d, decode_kernel_2d,
                                               decode_image_fused_v2)
from nic_torch.parallel.mesh import all_gather_rows

__all__ = ["decode_image_block", "decode_volume_block",
           "decode_image_fused_sharded", "decode_volume_fused_sharded"]


def decode_image_block(fp, mlp, mip_level: int, k: int, parts: int, *,
                       image_size, mip_to_level: dict, pe_channels: int,
                       use_tri_pe: bool = True, dtype=None,
                       gelu: str = "exact") -> torch.Tensor | None:
    """Rows [k·n/D, (k+1)·n/D) of the 2D fused decode (D = ``parts``),
    [n/D, nc, 3] fp32; None where JAX's sharded decode falls back to one
    device (the column stage declines, or n/D rows are not a multiple of
    the tile rows R, f and f1)."""
    prep = _prepare_2d(fp, mlp, mip_level, image_size=image_size,
                       mip_to_level=mip_to_level, pe_channels=pe_channels,
                       use_tri_pe=use_tri_pe, dtype=dtype)
    if prep is None:
        return None
    pc, c1v, pe_u, w2, b2, w3, b3, plane_scale, geom = prep
    n, f, f1 = geom["n"], geom["f"], geom["f1"]
    if n % parts or (n // parts) % geom["R"] or (n // parts) % f1 or (
            n // parts) % f:
        return None
    nr = n // parts
    # P rows and row PE split disjointly; C1's node rows overlap by the
    # one halo row the row interpolation reads
    return decode_kernel_2d(
        pc[k * nr // f:(k + 1) * nr // f],
        c1v[k * nr // f1:(k + 1) * nr // f1 + 1],
        pe_u[k * nr:(k + 1) * nr], w2, b2, w3, b3, plane_scale, f=f, f1=f1,
        gelu=gelu)


def decode_volume_block(fp, mlp, mip_level: int, k: int, parts: int, *,
                        image_size: int, mip_to_level: dict,
                        pe_channels: int, use_tri_pe: bool = True,
                        sparse_g0: bool = False, dtype=None,
                        gelu: str = "exact") -> torch.Tensor | None:
    """Frames [k·n/D, (k+1)·n/D) of the 3D fused decode, [n/D, n, n, 3]
    fp32; None where JAX's sharded decode falls back to one device (the
    frame stage declines, or n frames do not split into D blocks)."""
    prep = _prepare_3d(fp, mlp, mip_level, image_size=image_size,
                       mip_to_level=mip_to_level, pe_channels=pe_channels,
                       use_tri_pe=use_tri_pe, sparse_g0=sparse_g0,
                       dtype=dtype)
    if prep is None:
        return None
    pc, c1v, pe_u, w2, b2, w3, b3, plane_scale, geom = prep
    n = geom["n"]
    if n % parts:
        return None
    nt = n // parts
    return decode_kernel_3d(pc[k * nt:(k + 1) * nt], c1v[k * nt:(k + 1) * nt],
                            pe_u, w2, b2, w3, b3, plane_scale, f=geom["f"],
                            f1=geom["f1"], gelu=gelu)


def decode_image_fused_sharded(fp, mlp, mip_level: int, mesh, *, image_size,
                               mip_to_level: dict, pe_channels: int,
                               use_tri_pe: bool = True,
                               g1_quirk: bool = True, dtype=None,
                               gelu: str = "exact") -> torch.Tensor:
    """The 2D fused decode with its rows split over every rank of
    ``mesh`` (every rank calls it and gets the whole [H, W, 3] image);
    the single-device :func:`decode_image_fused_v2` where the split does
    not apply."""
    parts = 1 if mesh is None else mesh.world_size
    kw = dict(image_size=image_size, mip_to_level=mip_to_level,
              pe_channels=pe_channels, use_tri_pe=use_tri_pe, dtype=dtype,
              gelu=gelu)
    block = None
    if parts > 1:
        block = decode_image_block(fp, mlp, mip_level, mesh.rank, parts, **kw)
    if block is None:
        return decode_image_fused_v2(fp, mlp, mip_level, g1_quirk=g1_quirk,
                                     **kw)
    return all_gather_rows(block, mesh)


def decode_volume_fused_sharded(fp, mlp, mip_level: int, mesh, *,
                                image_size: int, mip_to_level: dict,
                                pe_channels: int, use_tri_pe: bool = True,
                                sparse_g0: bool = False,
                                g1_quirk: bool = True, dtype=None,
                                gelu: str = "exact") -> torch.Tensor:
    """The 3D fused decode with its frames split over every rank of
    ``mesh`` (every rank gets the whole [n, n, n, 3] volume); the
    single-device :func:`decode_volume_fused` where the split does not
    apply."""
    parts = 1 if mesh is None else mesh.world_size
    kw = dict(image_size=image_size, mip_to_level=mip_to_level,
              pe_channels=pe_channels, use_tri_pe=use_tri_pe,
              sparse_g0=sparse_g0, dtype=dtype, gelu=gelu)
    block = None
    if parts > 1:
        block = decode_volume_block(fp, mlp, mip_level, mesh.rank, parts,
                                    **kw)
    if block is None:
        return decode_volume_fused(fp, mlp, mip_level, g1_quirk=g1_quirk,
                                   **kw)
    return all_gather_rows(block, mesh)
