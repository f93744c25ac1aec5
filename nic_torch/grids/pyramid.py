"""Multiresolution feature pyramid (port of ``nic.grids.pyramid``).

A pyramid is a tuple of ``2 · levels`` grids; level ``l`` owns the pair
(G0 = ``fp[2l]``, G1 = ``fp[2l+1]``) of shape ``[C, s+1, s+1(, s+1)]``
with ``s = base_size // 2^i`` for list index ``i``. Grids initialise
uniformly in the quantizer range.
"""

from __future__ import annotations

import torch

from nic_torch.core.quant import quant_range, quantize, quantize_clamp

__all__ = [
    "log2_int",
    "pyramid_levels",
    "pyramid_mip_levels",
    "create_pyramid",
    "pyramid_clamp",
    "pyramid_quantize_all",
]


def log2_int(size: int) -> int:
    """Floor log2 by repeated halving."""
    count = 0
    while size != 1:
        size //= 2
        count += 1
    return count


def pyramid_levels(base_size: int) -> int:
    """(log2(base_size) + 1) // 2."""
    return (log2_int(base_size) + 1) // 2


def pyramid_mip_levels(image_size: int, base_size: int,
                       no_mip: bool = False) -> dict[int, int]:
    """mip level → pyramid level: clamp(mip // 2 − 1, 0, levels − 1)."""
    levels = 1 if no_mip else pyramid_levels(base_size)
    return {mip: min(max(mip // 2 - 1, 0), levels - 1)
            for mip in range(log2_int(image_size) + 1)}


def create_pyramid(generator: torch.Generator, base_size, channels: int,
                   num_bits: int, ndim: int = 2, *, device,
                   dtype: torch.dtype = torch.float32,
                   no_mip: bool = False) -> tuple[tuple, int]:
    """Uniform-init pyramid in [q_min, q_max]. Returns (grids, levels).

    ``base_size`` may be a per-axis tuple (rectangular grids). The draws
    come from ``generator`` on its own device and are then moved to
    ``device``, so one seed gives the same grids on every device."""
    sizes = ((base_size,) * ndim if isinstance(base_size, int)
             else tuple(base_size))
    if len(sizes) != ndim:
        raise ValueError(f"base_size {base_size!r} does not have {ndim} axes")
    levels = 1 if no_mip else pyramid_levels(min(sizes))
    q_min, q_max = quant_range(num_bits)
    grids = []
    for i in range(levels * 2):
        shape = (channels,) + tuple(s // (2**i) + 1 for s in sizes)
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=generator.device)
        grids.append((q_min + (q_max - q_min) * u).to(device))
    return tuple(grids), levels


def pyramid_clamp(fp: tuple, fl: int, num_bits: int) -> tuple:
    """Clamp the active level's (G0, G1) pair to the quantizer range;
    the other grids pass through unchanged."""
    out = list(fp)
    out[fl * 2] = quantize_clamp(fp[fl * 2], num_bits)
    out[fl * 2 + 1] = quantize_clamp(fp[fl * 2 + 1], num_bits)
    return tuple(out)


def pyramid_quantize_all(fp: tuple, num_bits: int) -> tuple:
    """Hard-quantize every grid."""
    return tuple(quantize(g, num_bits) for g in fp)
