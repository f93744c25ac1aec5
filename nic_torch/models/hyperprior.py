"""Scale-hyperprior entropy model for rate–distortion training (port of
``nic.models.hyperprior``).

    y = g_a(x)            analysis transform (strided convs)
    z = h_a(|y|)          hyper-analysis
    ẑ ~ factorized prior  (per-channel logistic CDF)
    σ = h_s(ẑ)            hyper-synthesis → per-element Gaussian scales
    ŷ ~ N(0, σ)           conditional prior
    x̂ = g_s(ŷ)           synthesis transform

Training relaxes quantization to additive uniform noise and minimizes
R + λ·255²·D, the rates being code lengths under the priors (−log2 of
the noise-relaxed likelihoods).

The transforms are ``nn.Conv2d(k5, s2, p2)``, ``nn.Conv2d(k3, s1, p1)``
and ``nn.ConvTranspose2d(k4, s2, p1)``, the torch geometry the JAX
package's im2col convs reproduce (``nic/models/matmul_conv.py`` is a TPU
workaround and is not ported). Tensors are NCHW inside; the weights'
JAX layouts are in ``nic_torch.io.convert``. GELU is the tanh form, as
``jax.nn.gelu``'s default.

σ → coding bin in the codec does not run :class:`HyperSynthesis`: it
runs K13 (``nic_torch.kernels.hs_bins``), whose fixed order of
operations makes the bins the same on the card and on the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Analysis", "Synthesis", "HyperAnalysis", "HyperSynthesis",
           "HyperpriorModel", "gaussian_bits", "logistic_bits", "rd_loss",
           "estimate_bits"]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _std_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gaussian_bits(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """−log2 P(y ∈ [y−½, y+½)) under N(0, scale²); y noise-relaxed."""
    scale = torch.clamp(scale, min=1e-6)
    upper = _std_normal_cdf((y + 0.5) / scale)
    lower = _std_normal_cdf((y - 0.5) / scale)
    return -torch.log2(torch.clamp(upper - lower, min=1e-12))


def logistic_bits(z: torch.Tensor, mu: torch.Tensor,
                  log_s: torch.Tensor) -> torch.Tensor:
    """−log2 P(z ∈ [z−½, z+½)) under a per-channel logistic prior (the
    factorized entropy bottleneck); z is NCHW, mu and log_s are [C]."""
    mu, log_s = mu.view(1, -1, 1, 1), log_s.view(1, -1, 1, 1)
    s = torch.exp(log_s)
    upper = torch.sigmoid((z + 0.5 - mu) / s)
    lower = torch.sigmoid((z - 0.5 - mu) / s)
    return -torch.log2(torch.clamp(upper - lower, min=1e-12))


def _down(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 5, 2, 2)


def _up(cin: int, cout: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, 4, 2, 1, output_padding=0)


class Analysis(nn.Module):
    """[B, 3, H, W] → [B, M, H/16, W/16]."""

    def __init__(self, n: int = 128, m: int = 192):
        super().__init__()
        self.convs = nn.ModuleList([_down(3, n), _down(n, n), _down(n, n),
                                    _down(n, m)])

    def forward(self, x):
        for conv in self.convs[:-1]:
            x = _gelu(conv(x))
        return self.convs[-1](x)


class Synthesis(nn.Module):
    """[B, M, H/16, W/16] → [B, 3, H, W]. ``dtype=torch.bfloat16`` runs the
    transposed convs on bf16 inputs and weights (the decode-side option,
    reconstruction only; bias and GELU stay fp32)."""

    def __init__(self, n: int = 128, m: int = 192):
        super().__init__()
        self.convs = nn.ModuleList([_up(m, n), _up(n, n), _up(n, n),
                                    _up(n, 3)])

    def forward(self, y, dtype: torch.dtype | None = None):
        for i, conv in enumerate(self.convs):
            if dtype is None:
                y = conv(y)
            else:
                y = F.conv_transpose2d(y.to(dtype), conv.weight.to(dtype),
                                       None, 2, 1).float()
                y = y + conv.bias.view(1, -1, 1, 1)
            if i < len(self.convs) - 1:
                y = _gelu(y)
        return y


class HyperAnalysis(nn.Module):
    """[B, M, h, w] → [B, N, h/4, w/4] (on |y|)."""

    def __init__(self, n: int = 128, m: int = 192):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv2d(m, n, 3, 1, 1), _down(n, n),
                                    _down(n, n)])

    def forward(self, y):
        z = _gelu(self.convs[0](torch.abs(y)))
        z = _gelu(self.convs[1](z))
        return self.convs[2](z)


class HyperSynthesis(nn.Module):
    """ẑ [B, N, h/4, w/4] → σ [B, M, h, w] (the training path, on the
    library's convolutions; the codec's bins come from K13)."""

    def __init__(self, n: int = 128, m: int = 192):
        super().__init__()
        self.convs = nn.ModuleList([_up(n, n), _up(n, n),
                                    nn.Conv2d(n, m, 3, 1, 1)])

    def forward(self, z):
        s = _gelu(self.convs[0](z))
        s = _gelu(self.convs[1](s))
        return torch.exp(self.convs[2](s))


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen) -> None:
    """flax's ``lecun_normal``: a normal truncated at ±2σ, σ scaled so
    that the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=gen)


class HyperpriorModel(nn.Module):
    """End-to-end scale-hyperprior codec; ``z_mu`` and ``z_log_s`` are the
    factorized prior's (μ, log s), one pair per z channel."""

    def __init__(self, n: int = 128, m: int = 192, *, generator=None):
        super().__init__()
        self.n, self.m = n, m
        self.g_a = Analysis(n, m)
        self.g_s = Synthesis(n, m)
        self.h_a = HyperAnalysis(n, m)
        self.h_s = HyperSynthesis(n, m)
        self.z_mu = nn.Parameter(torch.zeros(n))
        self.z_log_s = nn.Parameter(torch.zeros(n))
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                k = mod.kernel_size[0]
                cin = (mod.in_channels if isinstance(mod, nn.Conv2d)
                       else mod.weight.shape[0])
                _lecun_normal_(mod.weight, k * k * cin, generator)
                nn.init.zeros_(mod.bias)

    def forward(self, x, noise=None, *, generator=None):
        """Noise-relaxed forward of an NCHW batch → (x̂, y_bits, z_bits),
        bits summed per batch element. ``noise`` = (u_y, u_z), uniform
        draws in [−½, ½) of y's and z's shapes; else ``generator`` draws
        them; with neither, y and z are rounded (half to even)."""
        y = self.g_a(x)
        z = self.h_a(y)
        if noise is None and generator is not None:
            noise = tuple(torch.rand(t.shape, generator=generator,
                                     device=t.device, dtype=t.dtype) - 0.5
                          for t in (y, z))
        if noise is not None:
            y_t, z_t = y + noise[0], z + noise[1]
        else:
            y_t, z_t = torch.round(y), torch.round(z)
        sigma = self.h_s(z_t)
        x_hat = self.g_s(y_t)
        y_bits = gaussian_bits(y_t, sigma).sum(dim=(1, 2, 3))
        z_bits = logistic_bits(z_t, self.z_mu, self.z_log_s).sum(
            dim=(1, 2, 3))
        return x_hat, y_bits, z_bits

    def noise_shapes(self, x_shape) -> tuple:
        """The shapes of y and z for an NCHW input of ``x_shape``: each
        k5/s2/p2 conv halves a side, rounding up."""
        b, _, h, w = x_shape
        for _ in range(4):
            h, w = (h + 1) // 2, (w + 1) // 2
        y = (b, self.m, h, w)
        for _ in range(2):
            h, w = (h + 1) // 2, (w + 1) // 2
        return y, (b, self.n, h, w)

    # the codec's stages
    def analysis(self, x):
        return self.g_a(x)

    def hyper_analysis(self, y):
        return self.h_a(y)

    def synthesis(self, y_hat, dtype: torch.dtype | None = None):
        return self.g_s(y_hat, dtype)


def rd_loss(x_hat, x, y_bits, z_bits, lam: float):
    """(λ·255²·MSE + bpp, bpp, MSE) of an NCHW batch; bpp per pixel."""
    num_pixels = x.shape[2] * x.shape[3]
    bpp = torch.mean((y_bits + z_bits) / num_pixels)
    mse = torch.mean((x_hat - x) ** 2)
    return lam * (255.0**2) * mse + bpp, bpp, mse


def estimate_bits(y_bits, z_bits, num_pixels: int) -> float:
    return float(torch.mean(y_bits + z_bits)) / num_pixels
