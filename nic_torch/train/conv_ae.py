"""Conv-autoencoder trainer: the image_comp / movie_frame / movie_2d /
movie_3d workloads (port of ``nic.train.conv_ae``).

One step: encoder → QAT (uniform noise of ±1/2^(b+1) for the first 95%
of the epochs, then the hard quantizer, whose floor passes a zero
gradient, or its straight-through form with ``qat_ste``) → decoder →
MSE → Adam(lr, 0.9, 0.999, 1e-8), optax's ``adam``. In the quantize phase
the encoder's gradients are zeros, not ``None``, so Adam still moves it on
its momentum, as optax does.

The step core (:meth:`ConvAETrainer.step_core`) takes its noise as a
tensor, so a test can feed it the JAX trainer's draw; :meth:`train_step`
draws it on the device from the trainer's ``torch.Generator`` (another
stream than JAX's key, so quality parity is statistical). Convolutions
run in fp32 with no TF32 on deterministic cuDNN (``conv_flags``) in the
step, the encode and the decode alike.

The asset enters as the host's [H, W, 3] image or [T, H, W, 3] clip in
[0, 1] and is moved to NCHW / NCDHW once; codes leave in the host's
channels-last layout ([1, H/4, W/4, C] or [1, T/4, H/4, W/4, C] uint8,
the JAX trainer's), as ``truncate(quantize(z)·(2^b − 1))``.

Checkpoints are flat arrays under the JAX trainer's keys
(``nic_torch.io.convert``: the ``conv_impl="matmul"`` tree by default,
either tree on load), so either package resumes the other's. The trainer
defaults to the card and raises without one.

Under a mesh (``mesh=``, :mod:`nic_torch.parallel.mesh`) the sheet rows
(2D) or frames (3D) split over 'data', the params replicated, as the JAX
trainer shards them; where JAX's partitioner exchanges the convolutions'
halos, each rank recomputes them. A rank that owns output rows [4a, 4b)
(blocks of 4 rows, the latent's stride) encodes input rows [4a − 8,
4b + 8) (cut at the asset's border, where the convolutions' zero padding
is the true one) into latent rows [a − 1, b + 1), whose every row the
decode of its own rows reads is exact; it adds that slice of the whole
latent's noise (or quantizes it), decodes it and keeps its own rows. Its
loss is its rows' share of the whole mean, so the gradients and losses
are summed over 'data' (one all-reduce a step). No activation crosses
between ranks. Encode, decode and reconstruct run whole on every rank.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nic_torch.core.quant import qat_noise, quantize, quantize_ste
from nic_torch.models.autoencoder import (ConvDecoder2D, ConvDecoder3D,
                                          ConvEncoder2D, ConvEncoder3D,
                                          init_convs_)
from nic_torch.train.hyperprior import conv_flags, resolve_device
from nic_torch.train.spatiotemporal import make_batched_decode

__all__ = ["ConvAETrainer", "QATTrainer", "channels_first", "halo_window",
           "halo_loss"]

# optax.adam = chain(scale_by_adam, scale_by_learning_rate): its state is
# the chain's 0th
ADAM_PREFIX = "opt/0"


def channels_first(asset: np.ndarray, device) -> torch.Tensor:
    """Host [*spatial, 3] → a float32 [1, 3, *spatial] tensor on
    ``device`` (batch 1; for a batch of frames pass [T, …] and drop the
    added axis)."""
    arr = np.moveaxis(np.asarray(asset, np.float32), -1, 0)[None]
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class QATTrainer:
    """What the conv-AE, pixel and movie-label trainers share: the device,
    the draw generator, Adam, the phase rule, the step loop and the
    checkpoint I/O. A subclass sets ``num_bits``, ``num_epochs``,
    ``qat_ste``, builds its modules, calls :meth:`_init_opt`, and defines
    :meth:`leaves`, :meth:`_draws` and :meth:`loss_and_grads`."""

    conv_impl = "matmul"  # the JAX tree a checkpoint is written in

    def _init_common(self, device, seed: int, lr: float,
                     mesh=None) -> None:
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"device {device} but the mesh rank runs "
                                 f"on {mesh.device}")
            self.device = mesh.device
        self.lr = lr
        self.init_gen = torch.Generator().manual_seed(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.step = 0

    def _init_opt(self) -> None:
        from nic_torch.parallel.mesh import replicate_

        params = [p for p, _, _ in self.leaves().values()]
        replicate_(params, self.mesh)
        self.opt = torch.optim.Adam(params, lr=self.lr, betas=(0.9, 0.999),
                                    eps=1e-8)

    # ---- the step -------------------------------------------------------

    def phase(self) -> str:
        """``"noise"`` while step < 0.95·epochs, then ``"quantize"``."""
        return "noise" if self.step < self.num_epochs * 0.95 else "quantize"

    def _qat(self, z: torch.Tensor, phase: str, noise) -> torch.Tensor:
        if phase == "noise":
            return z + noise
        if phase != "quantize":
            raise ValueError(f"phase must be noise or quantize, not {phase!r}")
        return (quantize_ste if self.qat_ste else quantize)(z, self.num_bits)

    def step_core(self, phase: str, *draws) -> torch.Tensor:
        """One step from the given draws (:meth:`_draws`' tensors): forward,
        backward, Adam; returns the loss (a device scalar). Under a mesh
        the draws are the whole step's and each rank's loss is its share
        of the step's: grads and loss are summed over 'data'."""
        loss = self.loss_and_grads(phase, *draws)
        if self.mesh is not None:
            from nic_torch.parallel.mesh import psum_

            loss = loss.clone()
            psum_([p.grad for p, _, _ in self.leaves().values()
                   if p.grad is not None] + [loss], self.mesh, "data")
        self.opt.step()
        self.step += 1
        return loss

    def train_step(self) -> torch.Tensor:
        phase = self.phase()
        return self.step_core(phase, *self._draws(phase))

    def train_many(self, num_steps: int, chunk: int = 1000) -> np.ndarray:
        """``num_steps`` steps; the losses, read back once a chunk. The
        phase changes at step ⌈0.95·epochs⌉, where :meth:`phase` does."""
        losses = []
        boundary = int(math.ceil(self.num_epochs * 0.95))
        remaining = num_steps
        while remaining > 0:
            if self.step < boundary:
                n, phase = min(remaining, boundary - self.step, chunk), "noise"
            else:
                n, phase = min(remaining, chunk), "quantize"
            hist = [self.step_core(phase, *self._draws(phase))
                    for _ in range(n)]
            losses.append(torch.stack(hist).cpu().numpy())
            remaining -= n
        return np.concatenate(losses)

    # ---- codes ----------------------------------------------------------

    def _codes(self, z: torch.Tensor) -> np.ndarray:
        """Quantized latent → uint8 codes, ``truncate(q·(2^b − 1))`` in fp32
        as the JAX trainers compute them."""
        q = quantize(z, self.num_bits) * (2.0**self.num_bits - 1.0)
        return q.cpu().numpy().astype(np.uint8)

    def _latent_of(self, codes) -> torch.Tensor:
        z = torch.as_tensor(np.asarray(codes), dtype=torch.float32,
                            device=self.device)
        return z / (2.0**self.num_bits - 1.0)

    # ---- checkpoints ----------------------------------------------------

    def params_to_jax(self, conv_impl: str | None = None) -> dict:
        """{JAX leaf path: numpy array} of the parameters in
        ``conv_impl``'s tree (the trainer's by default)."""
        from nic_torch.io.convert import leaves_to_jax

        return leaves_to_jax(self.leaves(conv_impl))

    def grads_to_jax(self, conv_impl: str | None = None) -> dict:
        """The gradients of the last step, as :meth:`params_to_jax`."""
        from nic_torch.io.convert import leaves_to_jax

        leaves = self.leaves(conv_impl)
        return leaves_to_jax(leaves, {k: p.grad for k, (p, _, _)
                                      in leaves.items()})

    def state_arrays(self, conv_impl: str | None = None) -> dict:
        """Params and Adam's state → {npz key: array} under the JAX
        trainer's checkpoint keys (``params/…``, ``opt/0/…``)."""
        from nic_torch.io.convert import adam_to_arrays, leaves_to_jax

        leaves = self.leaves(conv_impl)
        arrays = {f"params/{k}": v for k, v in leaves_to_jax(leaves).items()}
        arrays.update(adam_to_arrays(leaves, self.opt, ADAM_PREFIX))
        return arrays

    def load_state_arrays(self, arrays: dict) -> None:
        """Load params (either JAX tree) and, where the arrays hold it,
        Adam's state (else a fresh Adam); shapes that do not fit raise."""
        from nic_torch.io.convert import (adam_from_arrays, conv_impl_of,
                                          leaves_from_jax)

        impl = conv_impl_of(arrays, "params/enc/params/")
        leaves = self.leaves(impl)
        leaves_from_jax(leaves, arrays, "params/")
        if not adam_from_arrays(arrays, leaves, self.opt, ADAM_PREFIX):
            self._init_opt()

    def save_checkpoint(self, path: str, extra: dict | None = None) -> None:
        from nic_torch.io.artifacts import save_checkpoint

        save_checkpoint(path, self.step, self.state_arrays(), extra)

    def load_checkpoint(self, path: str) -> int:
        """Restore a checkpoint of either package; returns its step."""
        from nic_torch.io.artifacts import load_checkpoint

        step, arrays, _ = load_checkpoint(path)
        self.load_state_arrays(arrays)
        self.step = int(step)
        return self.step


def halo_window(length: int, parts: int, k: int) -> tuple:
    """Rank k of ``parts``' rows along the sharded axis (sheet rows or
    frames) → (input rows, latent rows, own output rows) as slices:
    output rows [4a, 4b), latent rows [a − 1, b + 1) and input rows
    [4(a − 2), 4(b + 2)), each cut at the axis's ends."""
    if length % (4 * parts):
        raise ValueError(f"{length} rows do not split into {parts} blocks "
                         "of a multiple of 4 (the latent's stride)")
    z_rows = length // 4
    a, b = k * z_rows // parts, (k + 1) * z_rows // parts
    za, zb = max(a - 1, 0), min(b + 1, z_rows)
    s, e = max(4 * za - 4, 0), min(4 * zb + 4, length)
    return slice(s, e), slice(za, zb), slice(4 * a, 4 * b)


def halo_loss(encoder, decoder, image, window, qat) -> torch.Tensor:
    """This rank's share of the conv-AE's mean squared error with the
    halo recomputed (:func:`halo_window`'s rows along axis 2 of ``image``,
    [1, 3, L, …]): ``qat(z, latent rows)`` noises or quantizes the latent
    slice. → Σ over the own rows of the squared error / image.numel()."""
    rows_in, rows_z, rows_out = window
    z = encoder(image[:, :, rows_in])
    z = z[:, :, rows_z.start - rows_in.start // 4:
          rows_z.stop - rows_in.start // 4]
    out = decoder(qat(z, rows_z))
    own = out[:, :, rows_out.start - 4 * rows_z.start:
              rows_out.stop - 4 * rows_z.start]
    return torch.sum((own - image[:, :, rows_out]) ** 2) / image.numel()


class ConvAETrainer(QATTrainer):
    def __init__(self, image, *, num_bits: int = 4, latent_channels: int = 8,
                 hidden_channels: int = 16, num_epochs: int = 1000,
                 lr: float = 1e-3, seed: int = 0, qat_ste: bool = False,
                 device="cuda", mesh=None):
        """``image``: [H, W, 3] (2D) or [T, H, W, 3] (3D) in [0, 1]. Weights
        from ``torch.Generator(seed)`` (flax's ``lecun_normal``, fan-in
        kⁿ·Cin; not JAX's values); noise from a generator on the device
        seeded with ``seed + 1``. ``mesh``: this rank's
        :class:`~nic_torch.parallel.mesh.Mesh` (rows or frames over
        'data', a multiple of 4 each)."""
        self._init_common(device, seed, lr, mesh)
        self.num_bits, self.num_epochs, self.qat_ste = (num_bits, num_epochs,
                                                        qat_ste)
        image = np.asarray(image, np.float32)
        self.is_3d = image.ndim == 4
        self.image = channels_first(image, self.device)
        enc, dec = ((ConvEncoder3D, ConvDecoder3D) if self.is_3d
                    else (ConvEncoder2D, ConvDecoder2D))
        self.encoder = enc(latent_channels, hidden_channels)
        self.decoder = dec(latent_channels, hidden_channels, 3)
        for mod in (self.encoder, self.decoder):
            init_convs_(mod, self.init_gen)
            mod.to(self.device)
        self._init_opt()
        self._decode = make_batched_decode(self.decoder)
        self.window = None if mesh is None else halo_window(
            self.image.shape[2], mesh.data, mesh.data_index)

    def leaves(self, conv_impl: str | None = None) -> dict:
        from nic_torch.io.convert import conv_leaves

        impl = conv_impl or self.conv_impl
        return {**conv_leaves(self.encoder.convs, "enc/params", impl),
                **conv_leaves(self.decoder.convs, "dec/params", impl)}

    def latent_shape(self) -> tuple:
        """The latent's NCHW / NCDHW shape."""
        s = tuple(d // 4 for d in self.image.shape[2:])
        return (1, self.encoder.convs[1].out_channels) + s

    def _draws(self, phase: str) -> tuple:
        if phase != "noise":
            return (None,)
        return (qat_noise(self.gen, self.latent_shape(), self.num_bits),)

    def loss_and_grads(self, phase: str, noise=None) -> torch.Tensor:
        """Forward and backward of one step (``noise`` NCHW / NCDHW, the
        latent's shape, used in the noise phase); leaves the gradients in
        ``.grad`` and returns the loss."""
        self.opt.zero_grad(set_to_none=True)
        with conv_flags():
            if self.window is None:
                z = self._qat(self.encoder(self.image), phase, noise)
                loss = torch.mean((self.decoder(z) - self.image) ** 2)
            else:
                loss = halo_loss(self.encoder, self.decoder, self.image,
                                 self.window, lambda z, rows: self._qat(
                                     z, phase, None if noise is None
                                     else noise[:, :, rows]))
            loss.backward()
        return loss.detach()

    def encode(self) -> np.ndarray:
        """→ uint8 latent codes in [0, 2^b − 1], [1, *latent spatial, C]."""
        with torch.no_grad(), conv_flags():
            z = self.encoder(self.image)
        return self._codes(z.movedim(1, -1))

    def decode(self, latent_codes) -> np.ndarray:
        """uint8 codes [1, *latent spatial, C] → the asset [*spatial, 3] in
        [0, 1] (host numpy)."""
        return self._decode(self._latent_of(latent_codes))[0].cpu().numpy()

    def reconstruct(self) -> np.ndarray:
        return self.decode(self.encode())
