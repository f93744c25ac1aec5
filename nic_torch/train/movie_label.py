"""Per-frame label-embedding video compression (port of
``nic.train.movie_label``).

A 2D conv autoencoder over the frames as a batch, with a learned
per-frame embedding plane ([T, 1, H/4, W/4], drawn normal·0.1)
concatenated to the latent before the decoder, so one decoder serves
every frame. The latent gets the usual QAT; the embedding stays float.
Each step takes all frames. The JAX trainer builds this model from flax's
``Conv``/``ConvTranspose`` (the ``"xla"`` tree) whatever its other
trainers use, so checkpoints here are written in that tree; the
embedding crosses as JAX's [T, H/4, W/4, 1].

Under a mesh (``mesh=``) the frames split over 'data' (JAX's batched
``movie_spec``), the params replicated: each rank steps on its frames
with its slice of the whole step's noise, its loss the frames' share of
the whole mean; the gradients (the embedding's rows of other frames
zero) and losses are summed over 'data'.
"""

from __future__ import annotations

import numpy as np
import torch

from nic_torch.core.quant import qat_noise
from nic_torch.models.autoencoder import (ConvDecoder2D, ConvEncoder2D,
                                          init_convs_)
from nic_torch.train.conv_ae import QATTrainer, channels_first
from nic_torch.train.hyperprior import conv_flags
from nic_torch.train.spatiotemporal import make_batched_decode

__all__ = ["MovieLabelTrainer"]


class MovieLabelTrainer(QATTrainer):
    conv_impl = "xla"

    def __init__(self, movie, *, num_bits: int = 8, latent_channels: int = 8,
                 hidden_channels: int = 16, num_epochs: int = 50000,
                 lr: float = 1e-3, seed: int = 0, qat_ste: bool = False,
                 device="cuda", mesh=None):
        """``movie``: [T, H, W, 3] in [0, 1]. Weights from
        ``torch.Generator(seed)`` (flax's ``lecun_normal`` at flax's
        ``Conv``/``ConvTranspose`` fan-ins), then the embedding; noise from a
        generator on the device seeded with ``seed + 1``. ``mesh``: this
        rank's :class:`~nic_torch.parallel.mesh.Mesh` (T must split over
        its data axis)."""
        self._init_common(device, seed, lr, mesh)
        self.num_bits, self.num_epochs, self.qat_ste = (num_bits, num_epochs,
                                                        qat_ste)
        self.movie = channels_first(movie, self.device)[0].transpose(
            0, 1).contiguous()
        t, _, h, w = self.movie.shape  # [T, 3, H, W]
        self.encoder = ConvEncoder2D(latent_channels, hidden_channels)
        self.decoder = ConvDecoder2D(latent_channels + 1, hidden_channels, 3)
        init_convs_(self.encoder, self.init_gen)
        init_convs_(self.decoder, self.init_gen, flax_transpose=True)
        self.encoder.to(self.device)
        self.decoder.to(self.device)
        self.emb = torch.nn.Parameter((torch.randn(
            (t, 1, h // 4, w // 4), generator=self.init_gen) * 0.1).to(
                self.device))
        self._init_opt()
        self._decode = make_batched_decode(
            lambda z: self.decoder(torch.cat([z, self.emb], dim=1)))
        self.frames = slice(None)
        if mesh is not None:
            if t % mesh.data:
                raise ValueError(f"{t} frames do not split over {mesh.data} "
                                 "data ranks")
            per = t // mesh.data
            self.frames = slice(mesh.data_index * per,
                                (mesh.data_index + 1) * per)

    def leaves(self, conv_impl: str | None = None) -> dict:
        from nic_torch.io.convert import conv_leaves

        impl = conv_impl or self.conv_impl
        return {**conv_leaves(self.encoder.convs, "enc/params", impl),
                **conv_leaves(self.decoder.convs, "dec/params", impl),
                "emb": (self.emb, lambda t: t.permute(0, 2, 3, 1),
                        lambda t: t.permute(0, 3, 1, 2))}

    def latent_shape(self) -> tuple:
        t, _, lh, lw = self.emb.shape
        return (t, self.encoder.convs[1].out_channels, lh, lw)

    def _draws(self, phase: str) -> tuple:
        if phase != "noise":
            return (None,)
        return (qat_noise(self.gen, self.latent_shape(), self.num_bits),)

    def loss_and_grads(self, phase: str, noise=None) -> torch.Tensor:
        """Forward and backward of one step over all frames (``noise``
        [T, C, H/4, W/4] in the noise phase)."""
        self.opt.zero_grad(set_to_none=True)
        fr = self.frames
        movie = self.movie[fr]
        with conv_flags():
            z = self._qat(self.encoder(movie), phase,
                          None if noise is None else noise[fr])
            out = self.decoder(torch.cat([z, self.emb[fr]], dim=1))
            loss = torch.mean((out - movie) ** 2)
            if self.mesh is not None:  # this rank's share of the mean
                loss = loss / self.mesh.data
            loss.backward()
        return loss.detach()

    def encode(self) -> np.ndarray:
        """→ uint8 per-frame latent codes [T, H/4, W/4, C]; the embedding
        rides in the decoder's parameters."""
        with torch.no_grad(), conv_flags():
            z = self.encoder(self.movie)
        return self._codes(z.movedim(1, -1))

    def decode(self, latent_codes) -> np.ndarray:
        """uint8 codes [T, H/4, W/4, C] → the clip [T, H, W, 3] in [0, 1]."""
        return self._decode(self._latent_of(latent_codes)).cpu().numpy()

    def reconstruct(self) -> np.ndarray:
        return self.decode(self.encode())
