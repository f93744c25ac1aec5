"""Fixed-point quantization core (port of ``nic.core.quant``).

The code book is round-half-UP, ``floor(x·(2^b − 1) + 0.5)``, exactly as
the JAX package; ``torch.round`` rounds half-to-even and would disagree
on exact ``.5`` codes, so it is never used here. Grid values live in
``[−(2^b − 1)/2^(b+1), 1/2]`` and are stored as unsigned codes with
offset ``2^(b−1) − 1``. ``pack_bits``/``unpack_bits`` are host-side numpy
and write the same LSB-first bit stream as the JAX package and its native
packer, so artifacts move between the two packages byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "scale_to_bit",
    "normalize_from_bit",
    "quantize",
    "quantize_ste",
    "quantize_to_bit",
    "quantize_from_bit_to_bit",
    "quant_range",
    "quantize_clamp",
    "qat_noise",
    "pack_grid",
    "unpack_grid",
    "pack_bits",
    "unpack_bits",
]


def scale_to_bit(x, bits: int = 8):
    """[0,1] → [0, 2^b − 1]."""
    return x * (2.0**bits - 1.0)


def normalize_from_bit(x, bits: int = 8):
    """[0, 2^b − 1] → [0,1]."""
    return x / (2.0**bits - 1.0)


def quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Round-half-up onto the (2^b − 1)-level code book; in/out in [0,1]."""
    s = 2.0**bits - 1.0
    return torch.floor(x * s + 0.5) / s


def quantize_ste(x: torch.Tensor, bits: int) -> torch.Tensor:
    """:func:`quantize` forward with a straight-through (identity) gradient:
    ``x + (quantize(x) − x).detach()``, the JAX package's form."""
    return x + (quantize(x, bits) - x).detach()


def quantize_to_bit(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """[0,1] → quantized codes scaled to [0, 2^b − 1]."""
    return scale_to_bit(quantize(x, bits), bits)


def quantize_from_bit_to_bit(x: torch.Tensor, bits: int) -> torch.Tensor:
    """[0, 2^b − 1] → re-quantized [0, 2^b − 1]."""
    return scale_to_bit(quantize(normalize_from_bit(x, bits), bits), bits)


def quant_range(bits: int) -> tuple[float, float]:
    """Zero-centred grid value range (q_min, q_max) = (−(2^b−1)/2^(b+1), ½)."""
    return -(2.0**bits - 1.0) / 2.0 ** (bits + 1), 0.5


def quantize_clamp(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Clamp to the grid quantizer range [q_min, q_max]."""
    q_min, q_max = quant_range(bits)
    return torch.clamp(x, q_min, q_max)


def qat_noise(generator: torch.Generator, shape, bits: int) -> torch.Tensor:
    """Uniform QAT noise in [−1/2^(b+1), +1/2^(b+1)) on the generator's
    device: ``(U − 0.5) / 2^b``, the JAX package's distribution from
    another stream."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (u - 0.5) / (2.0**bits)


def pack_grid(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Grid values → uint8 codes ``floor(x·(2^b−1) + 0.5) + 2^(b−1) − 1``."""
    s = 2.0**bits - 1.0
    code = torch.floor(x * s + 0.5) + (2 ** (bits - 1) - 1)
    return code.to(torch.uint8)


def unpack_grid(code: torch.Tensor, bits: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_grid`."""
    x = code.to(dtype) - (2 ** (bits - 1) - 1)
    return x / (2.0**bits - 1.0)


def pack_bits(codes: np.ndarray, bits: int) -> np.ndarray:
    """b-bit codes (any shape) → flat uint8 stream; code i occupies stream
    bits [i·b, (i+1)·b), LSB-first, so the payload is ``ceil(count·b/8)``
    bytes for every b in [1, 8]."""
    codes = np.asarray(codes).reshape(-1).astype(np.uint8)
    if bits >= 8:
        return codes
    bitmat = (codes[:, None] >> np.arange(bits, dtype=np.uint8)) & 1
    return np.packbits(bitmat.reshape(-1), bitorder="little")


def unpack_bits(packed: np.ndarray, bits: int, count: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`; returns ``count`` codes as uint8."""
    packed = np.asarray(packed, dtype=np.uint8).reshape(-1)
    if bits >= 8:
        return packed[:count]
    stream = np.unpackbits(packed, bitorder="little")[: count * bits]
    bitmat = stream.reshape(count, bits).astype(np.uint8)
    return (bitmat * (1 << np.arange(bits, dtype=np.uint8))).sum(
        axis=1
    ).astype(np.uint8)
