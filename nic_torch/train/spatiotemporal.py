"""The one batched spatiotemporal decode of the movie family (port of
``nic.train.spatiotemporal``).

Every conv-AE variant decodes through :func:`make_batched_decode`: a
latent laid out as the host's ``[B, *spatial, C]`` through a conv
decoder, with the natural batch axis as the batch:

- movie_label: B = T frames (one decoder, one batched pass over all
  frames);
- image_comp / movie_frame / movie_2d: B = 1, the image or the √T·S
  sheet;
- movie_3d: B = 1, spatial = (T, H, W).

Under a mesh the trainers split their own axis (``conv_ae``: sheet rows
or frames with the halo recomputed; ``movie_label``: frames), where the
JAX package places the asset with ``movie_spec``/``put_sharded``; the
decode runs whole on every rank.
"""

from __future__ import annotations

import torch

from nic_torch.train.hyperprior import conv_flags

__all__ = ["make_batched_decode"]


def make_batched_decode(apply_fn):
    """``decode(z)``: the host's channels-last latent ``[B, *spatial, C]``
    → ``apply_fn`` on it channels-first (NCHW / NCDHW, one move each way)
    → ``[B, *spatial, 3]``; no autograd, fp32 convolutions (no TF32) on
    deterministic cuDNN. ``apply_fn(z)`` is the variant's decoder (for
    movie_label it concatenates the per-frame embedding plane first)."""

    def decode(z: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), conv_flags():
            out = apply_fn(z.movedim(-1, 1).contiguous())
        return out.movedim(1, -1)

    return decode
