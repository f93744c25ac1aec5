"""Image quality metrics (port of ``nic.core.metrics``).

``psnr`` defaults to the reference's ``max = 2^bits`` (256 for 8-bit);
pass ``max_value=255.0`` for the standard convention, which reads
``20·log10(256/255) ≈ 0.034 dB`` lower.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["mse", "psnr", "psnr_of_mse", "average_psnr", "safe_statistics"]


def mse(a, b) -> torch.Tensor:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return torch.mean((a - b) ** 2)


def psnr(original, reconstructed, num_bits: int = 8,
         max_value: float | None = None) -> torch.Tensor:
    """PSNR in dB; ``max_value=None`` → the reference's 2^num_bits."""
    return psnr_of_mse(mse(original, reconstructed), num_bits, max_value)


def psnr_of_mse(m: torch.Tensor, num_bits: int = 8,
                max_value: float | None = None) -> torch.Tensor:
    """PSNR in dB of a mean squared error (``psnr``'s peaks)."""
    if max_value is None:
        max_value = float(2**num_bits)
    db = 10.0 * torch.log10(max_value * max_value / torch.clamp(m, min=1e-30))
    return torch.where(m == 0, torch.full_like(db, float("inf")), db)


def average_psnr(original_video, reconstructed_video, num_bits: int = 8,
                 max_value: float | None = None) -> torch.Tensor:
    """Mean of the per-frame PSNR over the leading (frame) axis."""
    a = torch.as_tensor(original_video)
    b = torch.as_tensor(reconstructed_video)
    return torch.stack([psnr(a[i], b[i], num_bits, max_value)
                        for i in range(a.shape[0])]).mean()


def safe_statistics(x) -> dict:
    """Max/min/mean/variance (ddof 1) over the finite values, with NaN/Inf
    flags; computed in numpy on the host, as the JAX package does."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    finite = x[np.isfinite(x)]
    stats: dict = {
        "has_nan": bool(np.isnan(x).any()),
        "has_inf": bool(np.isinf(x).any()),
        "num_valid": int(finite.size),
    }
    if finite.size:
        stats.update(
            max=float(finite.max()),
            min=float(finite.min()),
            mean=float(finite.mean()),
            var=float(finite.var(ddof=1)) if finite.size > 1 else 0.0,
        )
    return stats
