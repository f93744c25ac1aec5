"""Rate–distortion trainer, bitstream codec and image-set harness of the
scale-hyperprior model (port of ``nic.train.hyperprior``).

- :class:`HyperpriorTrainer`: R + λD by Adam (lr 1e-4, eps 1e-8) after
  global-norm clipping by optax's formula, g·max/max(‖g‖, max) (no ε
  added to the norm, unlike ``torch.nn.utils.clip_grad_norm_``);
  ``train_chunk`` draws crop origins and the uniform noise on the device
  from an explicit ``torch.Generator`` (the JAX trainer draws them from
  its key inside ``lax.scan``; the streams differ, so quality parity is
  statistical); checkpoints under the JAX trainer's keys
  (``nic_torch.io.convert``), so either package resumes the other's;
  ``evaluate`` scores one image hard-quantized, edge-padded to a multiple
  of 64.
- :class:`HyperpriorCodec`: real rANS bitstreams (``nic_torch.native``)
  over the learned priors; the bins of ŷ come from K13
  (``nic_torch.kernels.hs_bins``), which gives the same bits on the card
  and on the CPU, so a stream made on one decodes on the other.
  ``decompress`` reproduces ``evaluate``'s x̂ exactly on one device.
- :func:`bench_decode_stages`: the decode's stage split on the card.
- :func:`eval_image_set`: mean PSNR and bpp over a list of images.

Layouts: images are HWC numpy arrays in [0, 1] at the public functions,
tensors NCHW inside; a blob's ``y_shape``/``z_shape`` and its streams are
JAX's NHWC (channel fastest), so ``bins_z = tile(arange(N))`` holds and
the streams are the JAX package's. ŷ = round(y) is half to even, as
``np.round``. The transforms run in fp32 (no TF32) on deterministic
cuDNN (:func:`conv_flags`).

Under a mesh (``mesh=``, :mod:`nic_torch.parallel.mesh`) the patch batch
splits over 'data' and the params are replicated, as in the JAX trainer:
every rank draws the whole batch's crops and noise from identically
seeded streams and takes its block; the gradients of the local mean are
averaged over 'data' (one all-reduce), then clipped by the global norm
and stepped on every rank (optax clips after the reduce: clipping per
rank would be another step). Entry points default to the card and raise
without one.
"""

from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from nic_torch.models.hyperprior import HyperpriorModel, rd_loss

__all__ = ["HyperpriorTrainer", "HyperpriorCodec", "bench_decode_stages",
           "eval_image_set", "resolve_device", "resolve_ckpt", "conv_flags"]


def resolve_device(device) -> torch.device:
    """``"cuda"`` (which raises without a card) or ``"cpu"``."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, not {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available (pass "
                           "--device cpu to run on the CPU)")
    return device


def resolve_ckpt(path: str) -> str:
    """A checkpoint file, or the newest one under a directory."""
    if os.path.isdir(path):
        from nic_torch.io.artifacts import CheckpointManager

        newest = CheckpointManager(path).paths_newest_first()
        if not newest:
            raise FileNotFoundError(f"no checkpoints under {path}")
        return newest[0]
    return path


def conv_flags():
    """fp32 convolutions (no TF32) on deterministic cuDNN: the trainer's
    and the codec's transforms, so that a decode reproduces ``evaluate``
    bit for bit on one card."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def _pad64(image: np.ndarray):
    """HWC → [1, H', W', 3] edge-padded to multiples of 64, and (H, W)."""
    h, w = image.shape[:2]
    ph, pw = (-h) % 64, (-w) % 64
    return np.pad(image, ((0, ph), (0, pw), (0, 0)), mode="edge")[None], (h, w)


def _nchw(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2))).to(device)


class HyperpriorTrainer:
    def __init__(self, *, n: int = 96, m: int = 128, lam: float = 0.01,
                 lr: float = 1e-4, patch: int = 256, batch: int = 8,
                 seed: int = 0, clip_grad_norm: float = 1.0,
                 device="cuda", mesh=None):
        """Weights from ``torch.Generator(seed)`` (flax's ``lecun_normal``
        distribution; the values are not JAX's); crops and noise from a
        generator on ``device`` seeded with ``seed + 1``.
        ``clip_grad_norm=0`` disables clipping. ``mesh``: this rank's
        :class:`~nic_torch.parallel.mesh.Mesh` (its device is the run's;
        ``batch`` must split over its data axis)."""
        from nic_torch.parallel.mesh import replicate_

        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            if mesh.device.type != self.device.type or batch % mesh.data:
                raise ValueError(f"a mesh rank on {mesh.device} with "
                                 f"{mesh.data} data ranks cannot run a "
                                 f"{device} batch of {batch}")
            self.device = mesh.device
        self.model = HyperpriorModel(
            n, m, generator=torch.Generator().manual_seed(seed)).to(
                self.device)
        replicate_(self.model, mesh)
        self.lam, self.lr = lam, lr
        self.patch, self.batch, self.seed = patch, batch, seed
        self.clip_grad_norm = clip_grad_norm
        self.opt = torch.optim.Adam(self.model.parameters(), lr=lr, eps=1e-8)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.step = 0

    # ---- one step -------------------------------------------------------

    def loss_and_grads(self, batch, noise=None):
        """Forward and backward of one NCHW batch (a tensor, or HWC numpy
        [B, H, W, 3]); ``noise`` = (u_y, u_z) NCHW, else drawn from the
        trainer's generator. Leaves the gradients in ``.grad``; returns
        (loss, bpp, mse) tensors."""
        x = batch if torch.is_tensor(batch) else _nchw(batch, self.device)
        self.opt.zero_grad(set_to_none=True)
        with conv_flags():
            x_hat, y_bits, z_bits = self.model(
                x, noise, generator=None if noise is not None else self.gen)
            loss, bpp, mse = rd_loss(x_hat, x, y_bits, z_bits, self.lam)
            loss.backward()
        return loss.detach(), bpp.detach(), mse.detach()

    def apply_grads(self) -> None:
        """Global-norm clipping (optax's formula), then Adam."""
        params = [p for p in self.model.parameters() if p.grad is not None]
        if self.clip_grad_norm:
            grads = [p.grad for p in params]
            norm = torch.sqrt(torch.stack([torch.sum(g * g)
                                           for g in grads]).sum())
            scale = torch.where(norm < self.clip_grad_norm,
                                torch.ones_like(norm),
                                self.clip_grad_norm / norm)
            torch._foreach_mul_(grads, scale)
        self.opt.step()
        self.step += 1

    def train_step(self, batch, noise=None):
        """One step on a batch (as :meth:`loss_and_grads`); under a mesh
        ``batch`` and ``noise`` are the whole step's, the noise drawn
        whole if not given, and each rank steps on its block."""
        if self.mesh is None:
            loss = self.loss_and_grads(batch, noise)
        else:
            from nic_torch.parallel.mesh import pmean_, shard_rows

            x = batch if torch.is_tensor(batch) else _nchw(batch,
                                                           self.device)
            if noise is None:  # the whole batch's, as one rank draws it
                noise = tuple(
                    torch.rand(shape, generator=self.gen,
                               device=self.device) - 0.5
                    for shape in self.model.noise_shapes(x.shape))
            loss = self.loss_and_grads(
                shard_rows(x, self.mesh),
                tuple(shard_rows(u, self.mesh) for u in noise))
            loss = tuple(t.clone() for t in loss)
            pmean_([p.grad for p in self.model.parameters()
                    if p.grad is not None] + list(loss), self.mesh)
        self.apply_grads()
        return loss

    # ---- chunks of steps on staged images -------------------------------

    def stage_images(self, images: list) -> torch.Tensor:
        """The training set as one [N, H, W, 3] device tensor; images
        smaller than the largest are edge-padded so crop origins stay
        valid."""
        h = max(i.shape[0] for i in images)
        w = max(i.shape[1] for i in images)
        stack = np.stack([
            np.pad(im, ((0, h - im.shape[0]), (0, w - im.shape[1]), (0, 0)),
                   mode="edge") if im.shape[:2] != (h, w) else im
            for im in images]).astype(np.float32)
        return torch.from_numpy(stack).to(self.device)

    def sample_crops(self, staged: torch.Tensor) -> torch.Tensor:
        """[batch, 3, patch, patch] crops drawn on the device (image index
        and origin per crop from the trainer's generator)."""
        n, h, w = staged.shape[:3]
        dev, g, p = staged.device, self.gen, self.patch
        idx = torch.randint(0, n, (self.batch,), generator=g, device=dev)
        rr = torch.randint(0, h - p + 1, (self.batch,), generator=g,
                           device=dev)
        cc = torch.randint(0, w - p + 1, (self.batch,), generator=g,
                           device=dev)
        ar = torch.arange(p, device=dev)
        rows = (rr[:, None] + ar)[:, :, None]
        cols = (cc[:, None] + ar)[:, None, :]
        return staged[idx[:, None, None], rows, cols].permute(
            0, 3, 1, 2).contiguous()

    def train_chunk(self, staged: torch.Tensor, num_steps: int):
        """``num_steps`` steps on crops of ``staged``; (loss, bpp, mse)
        history arrays of length ``num_steps`` (one sync at the end)."""
        hist = [self.train_step(self.sample_crops(staged))
                for _ in range(num_steps)]
        return tuple(torch.stack(h).cpu().numpy() for h in zip(*hist))

    # ---- checkpoints ----------------------------------------------------

    def state_arrays(self) -> dict:
        from nic_torch.io.convert import hyperprior_state_to_arrays

        return hyperprior_state_to_arrays(self.model, self.opt)

    def jax_tree(self) -> dict:
        """The parameters as the JAX package's tree ({"params": {...}},
        JAX layouts; what ``params_digest`` hashes)."""
        from nic_torch.io.bitstream import nest
        from nic_torch.io.convert import hyperprior_to_jax

        return {"params": nest(hyperprior_to_jax(self.model))}

    def save_checkpoint(self, path: str) -> None:
        """Atomic params + Adam snapshot under the JAX trainer's keys."""
        from nic_torch.io.artifacts import save_checkpoint

        save_checkpoint(path, self.step, self.state_arrays(),
                        extra={"lam": self.lam})

    def load_checkpoint(self, path: str) -> None:
        """Restore a checkpoint of either package; stored shapes that do
        not fit this model raise. A checkpoint without the clipped Adam
        chain's state restores the params with a fresh optimizer, as the
        JAX trainer does."""
        from nic_torch.io.artifacts import load_checkpoint
        from nic_torch.io.convert import hyperprior_state_from_arrays

        step, arrays, _ = load_checkpoint(path)
        if not hyperprior_state_from_arrays(arrays, self.model, self.opt):
            self.opt = torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                        eps=1e-8)
        self.step = int(step)

    # ---- evaluation -----------------------------------------------------

    def evaluate(self, image: np.ndarray):
        """Hard-quantized (PSNR, bpp, x̂ HWC in [0, 1]) of one image in
        [0, 1], padded to a multiple of 64."""
        x, (h, w) = _pad64(image)
        with torch.no_grad(), conv_flags():
            x_hat, y_bits, z_bits = self.model(_nchw(x, self.device))
        x_hat = np.clip(x_hat[0, :, :h, :w].permute(1, 2, 0).cpu().numpy(),
                        0, 1)
        mse = float(np.mean((x_hat - image) ** 2))
        psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
        bpp = float(y_bits[0] + z_bits[0]) / (h * w)
        return psnr, bpp, x_hat


class HyperpriorCodec:
    """Real bitstream compress/decompress around a trained model: rANS
    (``nic_torch.native``) over the Gaussian scale table for ŷ, whose bins
    K13 computes from ẑ, and the per-channel logistic prior for ẑ.
    Lossless w.r.t. the quantized latents."""

    def __init__(self, trainer, synthesis_dtype: torch.dtype | None = None,
                 device=None):
        """``trainer``: a :class:`HyperpriorTrainer` or a model; ``device``
        (default the model's) runs the codec on a copy of the model there.
        ``synthesis_dtype=torch.bfloat16`` runs the synthesis transform on
        bf16 inputs (reconstruction only: the streams do not change)."""
        from nic_torch.kernels.hs_bins import hs_weights

        model = getattr(trainer, "model", trainer)
        here = next(model.parameters()).device
        self.device = resolve_device(device) if device is not None else here
        if self.device != here:
            model = copy.deepcopy(model).to(self.device)
        self.model = model.eval()
        self.synthesis_dtype = synthesis_dtype
        self.hs = hs_weights(model.h_s)
        self._z_mu = model.z_mu.detach().cpu().numpy()
        self._z_log_s = model.z_log_s.detach().cpu().numpy()
        self._cdf_z_cache: dict[int, np.ndarray] = {}

    def _cdf_z(self, max_abs: int) -> np.ndarray:
        hit = self._cdf_z_cache.get(max_abs)
        if hit is None:
            from nic_torch.io import entropy as ec

            hit = ec.logistic_cdf_table(self._z_mu, self._z_log_s, max_abs)
            self._cdf_z_cache[max_abs] = hit
        return hit

    def bins_y(self, z_hat: np.ndarray) -> np.ndarray:
        """K13's bins of ẑ (int NHWC) → flat int32 in NHWC order."""
        from nic_torch.kernels.hs_bins import hs_bins_kernel

        z = torch.from_numpy(np.ascontiguousarray(
            np.asarray(z_hat, np.float32).transpose(0, 3, 1, 2))).to(
                self.device)
        _, bins = hs_bins_kernel(z, self.hs)
        return bins.permute(0, 2, 3, 1).reshape(-1).cpu().numpy()

    def encode_latents(self, image: np.ndarray):
        """(ŷ, ẑ) int32 NHWC of an HWC image, and its (H, W)."""
        x, hw = _pad64(image)
        with torch.no_grad(), conv_flags():
            y = self.model.analysis(_nchw(x, self.device))
            z = self.model.hyper_analysis(y)

        def nhwc(t):
            return torch.round(t).permute(0, 2, 3, 1).to(
                torch.int32).cpu().numpy()

        return nhwc(y), nhwc(z), hw

    def compress(self, image: np.ndarray) -> dict:
        """HWC image in [0, 1] → {'y': bytes, 'z': bytes, header...}."""
        from nic_torch.io import entropy as ec
        from nic_torch.native import rans_encode

        y_hat, z_hat, hw = self.encode_latents(image)
        bins_y = self.bins_y(z_hat)
        a_y = max(1, int(np.abs(y_hat).max()))
        a_z = max(1, int(np.abs(z_hat).max()))
        bytes_y = rans_encode(y_hat.reshape(-1) + a_y, bins_y,
                              ec.gaussian_cdf_table(a_y))
        n_ch = z_hat.shape[-1]
        bins_z = np.tile(np.arange(n_ch, dtype=np.int32), z_hat.size // n_ch)
        bytes_z = rans_encode(z_hat.reshape(-1) + a_z, bins_z,
                              self._cdf_z(a_z))
        return {"y": bytes_y, "z": bytes_z, "a_y": a_y, "a_z": a_z,
                "y_shape": y_hat.shape, "z_shape": z_hat.shape, "hw": hw}

    def num_bits(self, blob: dict) -> int:
        return (len(blob["y"]) + len(blob["z"])) * 8

    def decode_latents(self, blob: dict):
        """(ŷ, ẑ) int32 NHWC decoded from a blob's streams."""
        from nic_torch.io import entropy as ec
        from nic_torch.native import rans_decode

        n_ch = blob["z_shape"][-1]
        count_z = int(np.prod(blob["z_shape"]))
        bins_z = np.tile(np.arange(n_ch, dtype=np.int32), count_z // n_ch)
        z_hat = (rans_decode(blob["z"], bins_z, self._cdf_z(blob["a_z"]))
                 - blob["a_z"]).reshape(blob["z_shape"])
        y_hat = (rans_decode(blob["y"], self.bins_y(z_hat),
                             ec.gaussian_cdf_table(blob["a_y"]))
                 - blob["a_y"]).reshape(blob["y_shape"])
        return y_hat, z_hat

    def synthesize(self, y_hat: np.ndarray, hw) -> np.ndarray:
        """x̂ HWC in [0, 1] of ŷ (int NHWC), cropped to ``hw``."""
        with torch.no_grad(), conv_flags():
            x_hat = self.model.synthesis(_nchw(y_hat, self.device),
                                         self.synthesis_dtype)
        h, w = hw
        return np.clip(x_hat[0, :, :h, :w].permute(1, 2, 0).cpu().numpy(),
                       0, 1)

    def decompress(self, blob: dict) -> np.ndarray:
        y_hat, _ = self.decode_latents(blob)
        return self.synthesize(y_hat, blob["hw"])


def bench_decode_stages(codec: HyperpriorCodec, blob: dict, px: int,
                        iters: int = 20) -> dict:
    """The decode's stage split on the card: ``rans_ms`` (host rANS decode
    of both streams, median), ``host_glue_ms`` (symbol arithmetic,
    reshapes, cached CDF tables, median), ``hs_bins_device_ms`` (K13,
    CUDA events) and ``synthesis_device_ms`` (the synthesis transform at
    the codec's dtype, CUDA events); plus device and whole-decode Mpix/s.
    The bins' device→host copy is not in any stage."""
    from nic_torch.io import entropy as ec
    from nic_torch.kernels.hs_bins import hs_bins_kernel
    from nic_torch.native import rans_decode

    if codec.device.type != "cuda":
        raise RuntimeError("bench_decode_stages times the card: the codec "
                           "must run on cuda")
    n_ch = blob["z_shape"][-1]
    count_z = int(np.prod(blob["z_shape"]))
    bins_z = np.tile(np.arange(n_ch, dtype=np.int32), count_z // n_ch)
    cdf_z = codec._cdf_z(blob["a_z"])
    z_syms = rans_decode(blob["z"], bins_z, cdf_z)
    z_hat = (z_syms - blob["a_z"]).reshape(blob["z_shape"])
    bins_y = codec.bins_y(z_hat)
    cdf_y = ec.gaussian_cdf_table(blob["a_y"])
    y_syms = rans_decode(blob["y"], bins_y, cdf_y)
    y_hat = (y_syms - blob["a_y"]).reshape(blob["y_shape"])

    def med(fn):
        fn()
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e3

    def device_ms(fn):
        fn()
        torch.cuda.synchronize(codec.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    t_rans = med(lambda: (rans_decode(blob["z"], bins_z, cdf_z),
                          rans_decode(blob["y"], bins_y, cdf_y)))

    def glue():
        ec.gaussian_cdf_table(blob["a_y"])
        (z_syms - blob["a_z"]).reshape(blob["z_shape"])
        (y_syms - blob["a_y"]).reshape(blob["y_shape"])
        np.tile(np.arange(n_ch, dtype=np.int32), count_z // n_ch)

    t_glue = med(glue)
    zt = _nchw(z_hat, codec.device)
    yt = _nchw(y_hat, codec.device)
    t_hs = device_ms(lambda: hs_bins_kernel(zt, codec.hs))
    with torch.no_grad(), conv_flags():
        t_gs = device_ms(lambda: codec.model.synthesis(
            yt, codec.synthesis_dtype))
    total = t_rans + t_glue + t_hs + t_gs
    return {"rans_ms": t_rans, "host_glue_ms": t_glue,
            "hs_bins_device_ms": t_hs, "synthesis_device_ms": t_gs,
            "device_mpix_s": px / (t_hs + t_gs) / 1e3,
            "colocated_mpix_s": px / total / 1e3}


def eval_image_set(trainer: HyperpriorTrainer, paths: list,
                   log=None) -> dict:
    """Mean PSNR and bpp (estimated) over a list of images; with ``log``
    (the CLIs' harness) also each image's real rANS bitstream bpp
    (``bpp_bitstream``) and their mean, each image logged."""
    from nic_torch.data.assets import load_rgb

    rows = []
    for p in paths:
        psnr, bpp, _ = trainer.evaluate(load_rgb(p))
        rows.append({"image": os.path.basename(p), "psnr": psnr, "bpp": bpp})
    res = {"images": rows,
           "mean_psnr": float(np.mean([r["psnr"] for r in rows])),
           "mean_bpp": float(np.mean([r["bpp"] for r in rows]))}
    if log is None:
        return res
    codec = HyperpriorCodec(trainer)
    for p, row in zip(paths, rows):
        img = load_rgb(p)
        row["bpp_bitstream"] = codec.num_bits(codec.compress(img)) / (
            img.shape[0] * img.shape[1])
        log(f"{row['image']}: psnr {row['psnr']:.2f} bpp_est "
            f"{row['bpp']:.3f} bpp_real {row['bpp_bitstream']:.3f}")
    res["mean_bpp_bitstream"] = float(np.mean([r["bpp_bitstream"]
                                               for r in rows]))
    return res
