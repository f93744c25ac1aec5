"""Conv autoencoders (2D / 3D) for the whole-asset compression family
(port of ``nic.models.autoencoder``).

- :class:`ConvEncoder2D`: Conv(3→hidden, k3 s2 p1) ReLU, Conv(hidden→
  latent) Sigmoid; :class:`ConvDecoder2D`: ConvTranspose(latent→hidden,
  k3 s2 p1 op1) ReLU, ConvTranspose(hidden→3) Sigmoid;
- :class:`PixelLatentEncoder`: the 2D encoder with its first conv padded
  by 2, giving the (S/4 + 1)² corner lattice (257 → 129 at 512²) that the
  per-pixel MLP reads 2×2 patches from;
- :class:`ConvEncoder3D` / :class:`ConvDecoder3D`: the Conv3d analogue.

Tensors are NCHW / NCDHW (the JAX package's are channels-last). Torch's
``ConvTranspose(k3, s2, p1, output_padding=1)`` is flax's
``ConvTranspose`` with explicit padding ``((1, 2), …)`` and
``transpose_kernel=True``, and the JAX package's im2col form
(``MatmulConvTranspose``); that im2col form is a TPU workaround and is not
ported: ``nic_torch.io.convert`` reads and writes its parameter trees.
Weights start from flax's ``lecun_normal`` with the fan-in of the JAX
package's default ``matmul`` kernel, kⁿ·Cin, and zero biases.
"""

from __future__ import annotations

import torch
from torch import nn

from nic_torch.models.hyperprior import _lecun_normal_

__all__ = ["ConvEncoder2D", "ConvDecoder2D", "ConvEncoder3D",
           "ConvDecoder3D", "PixelLatentEncoder", "init_convs_"]


def _conv(ndim: int, cin: int, cout: int, pad: int) -> nn.Module:
    cls = nn.Conv2d if ndim == 2 else nn.Conv3d
    return cls(cin, cout, 3, stride=2, padding=pad)


def _conv_t(ndim: int, cin: int, cout: int) -> nn.Module:
    cls = nn.ConvTranspose2d if ndim == 2 else nn.ConvTranspose3d
    return cls(cin, cout, 3, stride=2, padding=1, output_padding=1)


class _Encoder(nn.Module):
    """Two stride-2 convs, ReLU between, Sigmoid head (the latent lies in
    (0, 1) for the fixed-point quantizer)."""

    ndim = 2
    first_pad = 1

    def __init__(self, latent_channels: int, hidden_channels: int,
                 in_channels: int = 3):
        super().__init__()
        self.convs = nn.ModuleList([
            _conv(self.ndim, in_channels, hidden_channels, self.first_pad),
            _conv(self.ndim, hidden_channels, latent_channels, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.convs[1](torch.relu(self.convs[0](x))))


class _Decoder(nn.Module):
    """Two stride-2 transposed convs, each doubling the resolution."""

    ndim = 2

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int = 3):
        super().__init__()
        self.convs = nn.ModuleList([
            _conv_t(self.ndim, in_channels, hidden_channels),
            _conv_t(self.ndim, hidden_channels, out_channels)])

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.convs[1](torch.relu(self.convs[0](z))))


class ConvEncoder2D(_Encoder):
    """[B, 3, H, W] → [B, latent, H/4, W/4]."""


class PixelLatentEncoder(_Encoder):
    """[B, 3, S, S] → [B, latent, S/4 + 1, S/4 + 1]: every pixel's 2×2
    patch ``latent[x//4 : x//4 + 2, y//4 : y//4 + 2]`` stays in bounds."""

    first_pad = 2


class ConvEncoder3D(_Encoder):
    """[B, 3, T, H, W] → [B, latent, T/4, H/4, W/4]."""

    ndim = 3


class ConvDecoder2D(_Decoder):
    """[B, in, h, w] → [B, 3, 4h, 4w]."""


class ConvDecoder3D(_Decoder):
    """[B, in, t, h, w] → [B, 3, 4t, 4h, 4w]."""

    ndim = 3


def init_convs_(module: nn.Module, generator: torch.Generator,
                flax_transpose: bool = False) -> None:
    """flax's ``lecun_normal`` kernels and zero biases for every conv of
    ``module``, in module order. The fan-in is kⁿ·Cin, the JAX package's
    im2col kernels'; ``flax_transpose=True`` gives transposed convs
    flax ``ConvTranspose``'s kⁿ·Cout (its kernel is the forward conv's)."""
    for mod in module.modules():
        if isinstance(mod, nn.modules.conv._ConvNd):
            cin = mod.weight.shape[
                0 if mod.transposed and not flax_transpose else 1]
            _lecun_normal_(mod.weight, cin * mod.weight[0, 0].numel(),
                           generator)
            nn.init.zeros_(mod.bias)
