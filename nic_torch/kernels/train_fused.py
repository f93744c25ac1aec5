"""Helpers of the fused train kernels (port of the parts of
``nic.kernels.train_fused`` that kernel3 uses).

- :func:`pick_block_rows` and :func:`_pad8`, which the kernel3 gate uses,
  so the same geometries take kernel3 in both packages;
- the GELU pair inside the train kernels: ``"erf"`` (the Abramowitz &
  Stegun erf of the decode kernel, |Δerf| ≤ 1.5e-7) and ``"poly"`` (the
  8-FMA even polynomial, exact saturation outside ±4), each with its
  hand-written derivative;
- :func:`_accumulate_node_planes`, which overlap-adds per-block node tiles
  and places each crop's window into the full-grid planes, per crop in a
  fixed order (no atomics), so the result is the same on every run.

The kernels of this file in the JAX package (K6–K10) come with ROADMAP.md
queue 2, items 3, 4 and 7.
"""

from __future__ import annotations

import torch

from nic_torch.kernels.decode_fused_v2 import _GELU_POLY_C, _erf

__all__ = ["pick_block_rows"]

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT2PI = 0.3989422804014327


def _gelu_fwd(z: torch.Tensor, kind: str):
    """(gelu(z), aux for the backward); for "erf" aux is Φ(z)."""
    if kind == "erf":
        cdf = 0.5 * (1.0 + _erf(z * _INV_SQRT2))
        return z * cdf, cdf
    u = z * z
    acc = torch.full_like(z, _GELU_POLY_C[-1])
    for c in _GELU_POLY_C[-2::-1]:
        acc = acc * u + c
    h = 0.5 * z + acc
    return torch.where(z > 4.0, z, torch.where(z < -4.0, 0.0, h)), None


def _gelu_bwd(z: torch.Tensor, aux, kind: str) -> torch.Tensor:
    """gelu'(z): Φ(z) + z·φ(z) for "erf"; ½ + 2z·q'(z²) for "poly"."""
    if kind == "erf":
        return aux + z * (_INV_SQRT2PI * torch.exp(-0.5 * z * z))
    u = z * z
    acc = torch.full_like(z, 8.0 * _GELU_POLY_C[8])
    for k in range(7, 0, -1):
        acc = acc * u + k * _GELU_POLY_C[k]
    g = 0.5 + 2.0 * z * acc
    return torch.where(z > 4.0, 1.0, torch.where(z < -4.0, 0.0, g))


def pick_block_rows(n_rows: int, max_r: int = 2048) -> int | None:
    """Largest power-of-two row block (≤ ``max_r``, ≥ 8) dividing
    ``n_rows``, or None."""
    r = max_r
    while r >= 8:
        if n_rows % r == 0:
            return r
        r //= 2
    return None


def _pad8(v: int) -> int:
    return -(-v // 8) * 8


def _node_counts(nodes) -> tuple[int, int]:
    return (nodes, nodes) if isinstance(nodes, int) else tuple(nodes)


def _accumulate_node_planes(dp, dc1, origins, *, crops: int, ncols: int,
                            rowsb: int, f: int, g0_nodes, g1_nodes,
                            hidden: int):
    """Per-block node tiles → full-grid planes (P [g0_rows+1, g0_cols+1, H]
    of cell sums of dz1, C1 [g1_rows+2, g1_cols+2, H] of interp-weighted
    sums).

    ``dp`` [crops·B, nr0, ≥nc0, H] and ``dc1`` [crops·B, nr1, ≥nc1, H] hold
    the tiles of B = ncols/rowsb row blocks per crop, in (crop, block)
    order, with the JAX package's extents; ``origins`` [crops, 2]. Blocks
    overlap-add into per-crop windows, which are added into the planes one
    crop after the other."""
    g0r, g0c = _node_counts(g0_nodes)
    g1r, g1c = _node_counts(g1_nodes)
    f1 = 2 * f
    nb = ncols // rowsb
    nr0 = (rowsb + f - 2) // f + 1
    nc0 = (ncols + f - 2) // f + 1
    nr1 = (rowsb + f1 - 2) // f1 + 2
    nc1 = ncols // f1 + 2
    s0 = rowsb // f
    s1 = max(rowsb // f1, 1)
    orgs = [tuple(int(v) for v in o) for o in torch.as_tensor(origins)
            .cpu().tolist()]

    def overlap_add(tiles, nr, nc, stride):
        tiles = tiles.reshape(crops, nb, nr, -1, hidden)[:, :, :, :nc]
        rows = (nb - 1) * stride + nr
        acc = tiles.new_zeros((crops, rows, nc, hidden))
        for q in range(nr):
            acc[:, q:q + (nb - 1) * stride + 1:stride] += tiles[:, :, q]
        return acc

    acc0 = overlap_add(dp, nr0, nc0, s0)
    acc1 = overlap_add(dc1, nr1, nc1, s1)
    planes = []
    for acc, shape, step in ((acc0, (g0r + 1, g0c + 1), f),
                             (acc1, (g1r + 2, g1c + 2), f1)):
        plane = acc.new_zeros(shape + (hidden,))
        rows, cols = acc.shape[1:3]
        for i, (o0, o1) in enumerate(orgs):
            r0, c0 = o0 // step, o1 // step
            plane[r0:r0 + rows, c0:c0 + cols] += acc[i]
        planes.append(plane)
    return tuple(planes)
