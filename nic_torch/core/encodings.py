"""Positional encodings (port of ``nic.core.encodings``).

Both encoders take coordinates ``[dim, N]`` and return features
``[num_channels · dim, N]`` (features first, the JAX package's layout).
The triangular encoding keeps the reference's zero row: within each
dimension block, the slot j == 0 (octave 0, offset 0.5) stays zero.
"""

from __future__ import annotations

import math

import torch

__all__ = ["sinusoidal_pe", "tri", "triangular_pe", "pe_dim"]


def pe_dim(num_channels: int, ndim: int) -> int:
    """Output feature count of either encoder for ``ndim`` coordinates."""
    return num_channels * ndim


def sinusoidal_pe(coords: torch.Tensor, num_channels: int) -> torch.Tensor:
    """Row 2k = sin(x·w_k), row 2k+1 = cos(x·w_k), w_k = 10000^(−2k/nc)."""
    dim, n = coords.shape
    half = (num_channels + 1) // 2
    k = torch.arange(0, num_channels, 2, dtype=coords.dtype,
                     device=coords.device)
    div_term = torch.exp(k * (-math.log(10000.0) / num_channels))
    phase = coords[:, None, :] * div_term[None, :, None]  # [dim, half, N]
    inter = torch.stack([torch.sin(phase), torch.cos(phase)], dim=2)
    inter = inter.reshape(dim, 2 * half, n)[:, :num_channels, :]
    return inter.reshape(dim * num_channels, n)


def tri(x: torch.Tensor, offset: float = 0.5) -> torch.Tensor:
    """Triangle wave 2·|((x − offset) mod 2) − 1| − 1 (floored mod)."""
    return 2.0 * torch.abs(torch.remainder(x - offset, 2.0) - 1.0) - 1.0


def triangular_pe(coords: torch.Tensor, num_channels: int) -> torch.Tensor:
    """NTC triangle-wave encoding: row r of a block uses j = nc − 1 − r,
    octave j // 2, offset 0.5 for even j; rows with j == 0 or
    j ≥ 2·(nc // 2) are zero."""
    dim, n = coords.shape
    octaves = num_channels // 2
    rows = []
    for r in range(num_channels):
        j = num_channels - 1 - r
        if j == 0 or j >= 2 * octaves:
            rows.append(torch.zeros_like(coords))
            continue
        offset = 0.5 if j % 2 == 0 else 0.0
        rows.append(tri(coords / (2.0 ** (j // 2)), offset=offset))
    pe = torch.stack(rows, dim=0).transpose(0, 1)  # [dim, nc, N]
    return pe.reshape(dim * num_channels, n)
