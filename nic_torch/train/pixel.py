"""Pixel-decode trainer: the pixel_comp / pixel_pos_comp workloads (port of
``nic.train.pixel``).

A conv encoder maps the image to a (S/4 + 1)² latent lattice; a tiny MLP
(``nic_torch.models.mlp``: 4·C (+ 2·PE) → H → H → 3, exact-erf GELUs)
decodes each pixel from its 2×2 latent patch (and, for pixel_pos, a
sinusoidal PE of (x, y)). A step draws a batch of random pixels (rows
``xs``, columns ``ys``) and QAT-perturbs their patch features; the step
core (:meth:`PixelTrainer.step_core`) takes ``xs``, ``ys`` and the noise
as tensors, so a test can feed it the JAX trainer's draws.

The patch gather ``latent[:, x//4 + dx, y//4 + dy]`` is advanced
indexing: its backward accumulates into the lattice with
``index_put_(accumulate=True)``, which on CUDA sorts the indices first
(no atomics), so two runs from one seed give the same losses.

Decode is the folded first layer (:meth:`PixelTrainer.decode`): layer 1
commutes with the patch gather, so W1 folds into the lattice once and the
per-pixel work is a ×4 nearest upsample in H space plus separable PE
vectors, then the MLP's tail; no per-pixel loop.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nic_torch.core.encodings import sinusoidal_pe
from nic_torch.core.quant import qat_noise
from nic_torch.models.autoencoder import PixelLatentEncoder, init_convs_
from nic_torch.models.mlp import PARAM_NAMES, apply_mlp, init_mlp
from nic_torch.train.conv_ae import QATTrainer, channels_first
from nic_torch.train.hyperprior import conv_flags

__all__ = ["PixelTrainer", "pixel_patch_features"]

_CELLS = ((0, 0), (0, 1), (1, 0), (1, 1))  # (dx, dy), feature order


def pixel_patch_features(latent: torch.Tensor,
                         image_size: int) -> torch.Tensor:
    """[Hl, Wl, C] latent lattice → [S, S, 4C] per-pixel 2×2 patch
    features, channel-major: for channel c the cells (dx, dy) in row-major
    order → index c·4 + dx·2 + dy (the JAX package's layout)."""
    c = latent.shape[-1]
    ex = torch.arange(image_size, device=latent.device) // 4
    feats = [latent[ex + dx][:, ex + dy] for dx, dy in _CELLS]
    patch = torch.stack(feats, dim=2)  # [S, S, 4, C]
    return patch.transpose(2, 3).reshape(image_size, image_size, 4 * c)


class PixelTrainer(QATTrainer):
    def __init__(self, image, *, num_bits: int = 8, latent_channels: int = 8,
                 hidden: int = 64, num_epochs: int = 20000,
                 batch_pixels: int = 256, use_pe: bool = False,
                 pe_channels: int = 4, lr: float = 1e-3, seed: int = 0,
                 qat_ste: bool = False, device="cuda"):
        """``image``: [S, S, 3] in [0, 1]. Encoder weights from
        ``torch.Generator(seed)`` (flax's ``lecun_normal``), then the MLP
        (U(±1/√fan_in), torch.nn.Linear's bound, as the JAX package);
        pixel draws and noise from a generator on the device seeded with
        ``seed + 1``."""
        self._init_common(device, seed, lr)
        self.num_bits, self.num_epochs, self.qat_ste = (num_bits, num_epochs,
                                                        qat_ste)
        self.batch_pixels = batch_pixels
        self.use_pe, self.pe_channels = use_pe, pe_channels
        self.image = channels_first(image, self.device)  # [1, 3, S, S]
        self.image_size = self.image.shape[2]
        self.latent_channels = latent_channels
        self.encoder = PixelLatentEncoder(latent_channels, 16)
        init_convs_(self.encoder, self.init_gen)
        self.encoder.to(self.device)
        in_features = 4 * latent_channels + (2 * pe_channels if use_pe else 0)
        self.mlp = init_mlp(self.init_gen, in_features, hidden, 3,
                            device=self.device)
        self._init_opt()

    def leaves(self, conv_impl: str | None = None) -> dict:
        from nic_torch.io.convert import conv_leaves, plain_leaves

        return {**conv_leaves(self.encoder.convs, "enc/params",
                              conv_impl or self.conv_impl),
                **plain_leaves({k: self.mlp[k] for k in PARAM_NAMES}, "mlp")}

    # ---- the step -------------------------------------------------------

    def _pe_of(self, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
        coords = torch.stack([xs.float(), ys.float()])
        return sinusoidal_pe(coords, self.pe_channels).T  # [N, 2·PE]

    def _draws(self, phase: str) -> tuple:
        nb, s = self.batch_pixels, self.image_size
        xy = torch.randint(0, s, (2, nb), generator=self.gen,
                           device=self.device)
        noise = (qat_noise(self.gen, (nb, 4 * self.latent_channels),
                           self.num_bits) if phase == "noise" else None)
        return xy[0], xy[1], noise

    def loss_and_grads(self, phase: str, xs, ys, noise=None) -> torch.Tensor:
        """Forward and backward of one step on the pixels (``xs`` rows,
        ``ys`` columns, int64 [N]) with ``noise`` [N, 4C] in the noise
        phase; leaves the gradients in ``.grad``, returns the loss."""
        self.opt.zero_grad(set_to_none=True)
        xs, ys = xs.to(self.device), ys.to(self.device)
        with conv_flags():
            latent = self.encoder(self.image)[0]  # [C, Hl, Wl]
            ex, ey = xs // 4, ys // 4
            cells = [latent[:, ex + dx, ey + dy] for dx, dy in _CELLS]
            nb = xs.shape[0]
            feat = torch.stack(cells, dim=1).reshape(-1, nb).T  # [N, 4C]
            feat = self._qat(feat, phase, noise)
            if self.use_pe:
                feat = torch.cat([feat, self._pe_of(xs, ys)], dim=1)
            out = apply_mlp(self.mlp, feat)
            tgt = self.image[0, :, xs, ys].T  # [N, 3]
            loss = torch.mean((out - tgt) ** 2)
            loss.backward()
        return loss.detach()

    # ---- codes and the folded decode ------------------------------------

    def encode(self) -> np.ndarray:
        """→ uint8 latent codes [Hl, Wl, C]."""
        with torch.no_grad(), conv_flags():
            z = self.encoder(self.image)[0]
        return self._codes(z.movedim(0, -1))

    def decode_latent(self, latent: torch.Tensor) -> torch.Tensor:
        """The folded decode of a float lattice [Hl, Wl, C] → [S, S, 3]:
        P = Σ_cells shift(latent)·W1_cell at the lattice's resolution, a ×4
        nearest upsample, the PE's row and column vectors, then the MLP's
        tail. Exact against the per-pixel MLP up to summation order."""
        mlp, s = self.mlp, self.image_size
        w1 = mlp["w1"]
        c = latent.shape[-1]
        n = s // 4  # ex = x//4 ∈ [0, n−1]; the lattice is n + 1 wide
        ch = torch.arange(c, device=latent.device) * 4
        p_plane = None
        for k, (dx, dy) in enumerate(_CELLS):
            term = latent[dx:dx + n, dy:dy + n] @ w1[ch + k]  # [n, n, H]
            p_plane = term if p_plane is None else p_plane + term
        acc = p_plane.repeat_interleave(4, 0).repeat_interleave(4, 1)
        if self.use_pe:
            coords = torch.arange(s, dtype=torch.float32,
                                  device=latent.device)[None, :]
            table = sinusoidal_pe(coords, self.pe_channels).T  # [s, PE]
            base, pe = 4 * c, self.pe_channels
            pe_u = table @ w1[base:base + pe]
            pe_v = table @ w1[base + pe:base + 2 * pe]
            acc = acc + pe_u[:, None, :] + pe_v[None, :, :]
        h = F.gelu(acc + mlp["b1"])
        h = F.gelu(h @ mlp["w2"] + mlp["b2"])
        return torch.sigmoid(h @ mlp["w3"] + mlp["b3"])

    def decode(self, latent_codes) -> np.ndarray:
        """uint8 codes [Hl, Wl, C] → the image [S, S, 3] in [0, 1]."""
        with torch.no_grad():
            return self.decode_latent(
                self._latent_of(latent_codes)).cpu().numpy()

    def reconstruct(self) -> np.ndarray:
        return self.decode(self.encode())
