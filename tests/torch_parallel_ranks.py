"""The rank programs of ``tests/test_torch_parallel.py``.

Each runs on one rank of a CPU gloo group that
``nic_torch.parallel.mesh.run_ranks`` spawns (or, with no mesh, in the
test's own process as the one-rank run). They import neither JAX nor the
JAX package; the JAX draws and initial params come in an ``.npz`` file
that the test writes, and the results go back as numpy arrays. Beside
them, :func:`check_steps`, the tests' comparison of two runs' steps.
"""

from __future__ import annotations

import numpy as np
import torch

from nic_torch.config import CompressionConfig
from nic_torch.models.mlp import PARAM_NAMES
from nic_torch.parallel.mesh import check_replicated
from nic_torch.train.ntc import LR_FP, LR_MLP, cosine_lr

# the toy configuration of tests/test_multidevice.py
NTC_KW = dict(image_size=32, crop_mip_level=4, num_epochs=40, fp_bits=4,
              feature_pyramid_channels=4, pe_channels=4,
              hidden_layer_channels=16, tf_no_mip=True, seed=0)


def toy_image(size: int) -> np.ndarray:
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    return np.clip(np.stack([x, y, x * y], axis=0), 0, 1)


def _ntc_result(tr, mesh, losses, grads) -> dict:
    s = tr.state
    params = list(s.fp) + [s.mlp[k] for k in PARAM_NAMES]
    return dict(losses=np.array(losses), grads=grads,
                params=[p.detach().numpy().copy() for p in params],
                engine=tr._plan(0, s.frozen).mode,
                digest=check_replicated(params, mesh))


def ntc_train_steps(mesh, steps: int = 3) -> dict:
    """The gather engine's ``train_step`` on 4 crops, from the trainer's
    own streams (every rank draws the whole step)."""
    from nic_torch.train.ntc import NTCTrainer

    cfg = CompressionConfig(device="cpu", train_forward="gather",
                            num_crops=4, **NTC_KW)
    tr = NTCTrainer(cfg, [toy_image(32)], mesh=mesh)
    params = list(tr.state.fp) + [tr.state.mlp[k] for k in PARAM_NAMES]
    losses, grads = [], []
    for _ in range(steps):
        losses.append(float(tr.train_step()[0]))
        grads.append([p.grad.numpy().copy() for p in params])
    return _ntc_result(tr, mesh, losses, grads)


def ntc_steps(mesh, path: str, forward: str, num_crops: int) -> dict:
    """The port's NTC trainer from the file's initial params, stepped
    through ``step_core`` on the file's whole-step draws (origins, and
    ``eps`` or the kernel3 ``seed`` words per step) → losses, each step's
    (all-reduced) gradients, params and the params' digest (checked equal
    across ranks)."""
    from nic_torch.train.ntc import NTCTrainer

    z = np.load(path)
    cfg = CompressionConfig(device="cpu", train_forward=forward,
                            num_crops=num_crops, **NTC_KW)
    tr = NTCTrainer(cfg, [toy_image(32)], mesh=mesh)
    s = tr.state
    params = list(s.fp) + [s.mlp[k] for k in PARAM_NAMES]
    with torch.no_grad():
        for i, p in enumerate(params):
            p.copy_(torch.from_numpy(z[f"param{i}"]))
    losses, grads = [], []
    for t in range(z["origins"].shape[0]):
        kw = ({"seed": torch.from_numpy(z["seed"][t])} if forward == "kernel3"
              else {"eps": torch.from_numpy(z["eps"][t])})
        loss, _ = tr.step_core(0, torch.from_numpy(z["origins"][t]), **kw)
        losses.append(float(loss))
        grads.append([p.grad.numpy().copy() for p in params])  # reduced
        s.step += 1
    return _ntc_result(tr, mesh, losses, grads)


def hyperprior_steps(mesh, steps: int = 3) -> dict:
    """Steps of a small hyperprior trainer (crops and noise from its own
    seeded streams, clipped at a global norm the step's grads exceed)."""
    from nic_torch.train.hyperprior import HyperpriorTrainer

    tr = HyperpriorTrainer(n=8, m=12, lam=0.01, patch=64, batch=4, seed=0,
                           clip_grad_norm=0.05, device="cpu", mesh=mesh)
    rng = np.random.default_rng(3)
    staged = tr.stage_images([rng.uniform(0, 1, (96, 96, 3)).astype(
        np.float32)])
    lh, bh, _ = tr.train_chunk(staged, steps)
    params = list(tr.model.parameters())
    return dict(losses=lh, bpp=bh,
                params=[p.detach().numpy().copy() for p in params],
                digest=check_replicated(params, mesh))


def movie_label_steps(mesh, steps: int = 3) -> dict:
    """Steps of a small movie-label trainer (4 frames of 16², noise from
    its own seeded stream), the last in the quantize phase."""
    from nic_torch.train.movie_label import MovieLabelTrainer

    rng = np.random.default_rng(0)
    movie = rng.uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)
    tr = MovieLabelTrainer(movie, num_bits=4, num_epochs=steps - 1,
                           device="cpu", mesh=mesh)
    losses = tr.train_many(steps)
    params = [p for p, _, _ in tr.leaves().values()]
    return dict(losses=losses,
                params=[p.detach().numpy().copy() for p in params],
                recon=tr.reconstruct(), digest=check_replicated(params, mesh))


# the hyperprior trainer held to JAX's mesh (clip_grad_norm below the
# steps' global gradient norms: the clip is active in every step)
HP_KW = dict(n=8, m=12, lam=0.01, patch=64, batch=4, seed=0,
             clip_grad_norm=0.05)


def _arrays(z, prefix: str) -> dict:
    """The file's {``prefix`` + path (``:`` for ``/``): array} → {path:
    array}."""
    return {k[len(prefix):].replace(":", "/"): z[k] for k in z.files
            if k.startswith(prefix)}


def _nc(a: np.ndarray) -> torch.Tensor:
    """A channels-last array → a channels-first tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def hyperprior_jax_steps(mesh, path: str) -> dict:
    """The hyperprior trainer from the file's JAX params, stepped on the
    file's whole batches and noise (JAX's draws) → losses, each step's
    gradient norm after the clip, params in JAX's layout and digest."""
    from nic_torch.io.convert import hyperprior_from_jax, hyperprior_to_jax
    from nic_torch.train.hyperprior import HyperpriorTrainer

    z = np.load(path)
    tr = HyperpriorTrainer(**HP_KW, device="cpu", mesh=mesh)
    hyperprior_from_jax(tr.model, _arrays(z, "param:"))
    losses, norms = [], []
    for t in range(z["batch"].shape[0]):
        loss = tr.train_step(z["batch"][t], (_nc(z["uy"][t]),
                                             _nc(z["uz"][t])))[0]
        losses.append(float(loss))
        norms.append(float(torch.sqrt(sum(
            torch.sum(p.grad.double() ** 2) for p in tr.model.parameters()
            if p.grad is not None))))
    return dict(losses=np.array(losses), norms=np.array(norms),
                params=hyperprior_to_jax(tr.model),
                digest=check_replicated(list(tr.model.parameters()), mesh))


def conv_ae_jax_steps(mesh, path: str) -> dict:
    """The conv-AE trainer on the file's sheet from its JAX params, stepped
    on the file's whole-latent noise (JAX's draws; the last step in the
    quantize phase) → losses, params in JAX's layout and digest."""
    from nic_torch.train.conv_ae import ConvAETrainer

    z = np.load(path)
    steps = z["noise"].shape[0]
    tr = ConvAETrainer(z["asset"], num_bits=4, num_epochs=steps - 1,
                       device="cpu", mesh=mesh)
    tr.load_state_arrays({"params/" + k: v
                          for k, v in _arrays(z, "param:").items()})
    losses = []
    for t in range(steps):
        phase = tr.phase()
        draw = _nc(z["noise"][t]) if phase == "noise" else None
        losses.append(float(tr.step_core(phase, draw)))
    return dict(losses=np.array(losses), params=tr.params_to_jax(),
                digest=check_replicated(
                    [p for p, _, _ in tr.leaves().values()], mesh))


def two_ranks(mesh, paths: dict) -> dict:
    """Every check of the 2-rank group, on one spawn."""
    return {"gather": ntc_steps(mesh, paths["gather"], "gather", 8),
            "kernel3": ntc_steps(mesh, paths["kernel3"], "kernel3", 8),
            "hyperprior jax": hyperprior_jax_steps(mesh,
                                                   paths["hyperprior"]),
            "conv_ae jax": conv_ae_jax_steps(mesh, paths["conv_ae"]),
            "hyperprior": hyperprior_steps(mesh),
            "movie_label": movie_label_steps(mesh),
            "conv_ae 2d": conv_ae_steps(mesh, "2d"),
            "conv_ae 3d": conv_ae_steps(mesh, "3d")}


def conv_ae_steps(mesh, kind: str, steps: int = 3) -> dict:
    """Steps of a small conv-AE trainer: a 32×16 sheet (2D) or a clip of
    16 frames of 8² (3D), the last step in the quantize phase."""
    from nic_torch.train.conv_ae import ConvAETrainer

    rng = np.random.default_rng(1)
    shape = (32, 16, 3) if kind == "2d" else (16, 8, 8, 3)
    tr = ConvAETrainer(rng.uniform(0, 1, shape).astype(np.float32),
                       num_bits=4, num_epochs=steps - 1, device="cpu",
                       mesh=mesh)
    losses = tr.train_many(steps)
    params = [p for p, _, _ in tr.leaves().values()]
    return dict(losses=losses,
                params=[p.detach().numpy().copy() for p in params],
                digest=check_replicated(params, mesh))


# ---- the tests' comparison of two runs' steps --------------------------

def _adam64(grads, lrs):
    """The params' total Adam move (optax.adam, cosine learning rates over
    NUM_EPOCHS) replayed in float64 from each step's gradients."""
    m = v = move = 0.0
    for t, g in enumerate(grads, 1):
        g = np.asarray(g, np.float64)
        m, v = 0.9 * m + 0.1 * g, 0.999 * v + 0.001 * g * g
        lr = cosine_lr(lrs, t - 1, NTC_KW["num_epochs"])
        move = move - lr * (m / (1 - 0.9**t)) / (
            np.sqrt(v / (1 - 0.999**t)) + 1e-8)
    return move


GRAD_TOL = 1e-2  # bf16 dot inputs (MLP_NUM_DTYPE=16), test_torch_ntc_train


def check_steps(got, want_losses, want_grads, want_params, loss_tol, what):
    """Losses within ``loss_tol`` (abs), each step's gradients within the
    grad limit, params within atol 1e-5 plus Adam's float64 replay of the
    two runs' gradient difference."""
    np.testing.assert_allclose(got["losses"], want_losses, atol=loss_tol,
                               rtol=0, err_msg=what)
    for t, (gs, ws) in enumerate(zip(got["grads"], want_grads)):
        for i, (g, w) in enumerate(zip(gs, ws)):
            rel = np.abs(g - w).max() / (np.abs(w).max() + 1e-12)
            assert rel < GRAD_TOL, (what, t, i, rel)
    n_grids = len(want_params) - len(PARAM_NAMES)
    for i, (p, q) in enumerate(zip(got["params"], want_params)):
        lr = LR_FP if i < n_grids else LR_MLP
        bound = 1e-5 + np.abs(
            _adam64([g[i] for g in got["grads"]], lr)
            - _adam64([w[i] for w in want_grads], lr))
        diff = np.abs(p - q)
        assert (diff <= bound).all(), (what, i, float(diff.max()))
