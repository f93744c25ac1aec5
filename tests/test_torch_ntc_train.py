"""nic_torch.train.ntc against nic.train.ntc on the CPU (64² sancho,
crops of 2^CROP_MIP_LEVEL).

The LOD stream and the learning-rate schedule are compared exactly (to
float rounding); the engine gates (kernel3, kernel2, kernel, gather) on a
grid of configurations; one train step of every engine from identical
params, crops and noise (JAX's own draws, replayed through the port's
step core) in loss, grads (Adam's first moment after one update is
(1 − b1)·grad in both) and post-Adam params; checkpoints in both
directions; and a kernel3 run across the freeze, step by step. The JAX
kernels run in Pallas interpret mode, as the JAX suite runs them.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)
from jax.experimental.pallas import tpu as pltpu

from nic.cli.image_compression import load_asset as j_load_asset
from nic.config import CompressionConfig as JConfig
from nic.train import ntc as jntc
from nic_torch.cli.image_compression import load_asset as t_load_asset
from nic_torch.config import CompressionConfig as TConfig
from nic_torch.models.mlp import PARAM_NAMES
from nic_torch.train import ntc as tntc

BASE = dict(image_size=64, crop_mip_level=5, image_path="data/sancho_512.png",
            sdc_guard_train=False)
# (loss rel, grad rel). fp32: summation order only; bf16 dot inputs: a
# last-bit difference flips a bf16 rounding, so grads hold to the JAX
# suite's 1e-2. Post-Adam params hold to 1e-6 absolute plus what the two
# grads' difference explains: the first Adam step is lr·g/(|g| + 1e-8),
# so an element whose grad is near zero moves by lr·|Δg|/(|g| + 1e-8).
TOL = {32: (1e-5, 1e-4), 16: (1e-4, 1e-2)}


def _pair(**kw):
    kw = {**BASE, **kw}
    jcfg = JConfig(**kw)
    tcfg = TConfig(device="cpu", **kw)
    jtr = jntc.NTCTrainer(jcfg, j_load_asset(jcfg))
    lines = []
    ttr = tntc.NTCTrainer(tcfg, t_load_asset(tcfg), log=lines.append)
    with torch.no_grad():
        for dst, src in zip(ttr.state.fp, jtr.state.fp):
            dst.copy_(torch.from_numpy(np.array(src)))
        for k in PARAM_NAMES:
            ttr.state.mlp[k].copy_(torch.from_numpy(np.array(
                jtr.state.mlp[k])))
    return jtr, ttr, lines


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _jax_draws(cfg, n, sub, frozen, forward, lod=0):
    """What JAX's train_step draws from its per-step key (ntc.py:761)."""
    k_crop, k_noise = jax.random.split(sub)
    size = cfg.image_size >> min(lod, cfg.effective_max_mip_level)
    origins = jax.random.randint(
        k_crop, (cfg.num_crops, 2), 0,
        jnp.asarray([size - n + 1] * 2, jnp.int32))
    kw = {}
    if not frozen:
        if forward == "kernel3":
            kw["seed"] = torch.from_numpy(np.array(
                jntc._k3_seed(k_noise, jnp.int32(0))))
        else:
            from nic.core.quant import qat_noise

            kw["eps"] = torch.from_numpy(np.array(qat_noise(
                k_noise, (cfg.num_crops * n * n, cfg.decoder_input_channels),
                cfg.fp_bits, jnp.float32)))
    return torch.from_numpy(np.array(origins)), kw


def test_lod_sequence_matches_jax():
    for rate, max_mip in ((0.05, 9), (0.3, 6), (1.0, 3)):
        jr, tr = np.random.default_rng(1), np.random.default_rng(1)
        jg = jntc.UniformLodSchedule(rate)
        tg = tntc.UniformLodSchedule(rate)
        want = [jntc.sample_lod(jr, jg(), max_mip) for _ in range(2000)]
        got = [tntc.sample_lod(tr, tg(), max_mip) for _ in range(2000)]
        assert got == want
    # the trainers' own streams, mip mode
    jtr, ttr, _ = _pair(tf_no_mip=False, max_mip_level=6, crop_mip_level=4)
    assert ttr.max_mip == jtr.max_mip == 6
    want = [jntc.sample_lod(jtr._lod_rng, jtr._uniform_gate(), 6)
            for _ in range(300)]
    got = [tntc.sample_lod(ttr._lod_rng, ttr._uniform_gate(), 6)
           for _ in range(300)]
    assert got == want


def _lr_approx(init, want):
    """optax evaluates the schedule in float32: 1 + cos(πt/T) carries an
    absolute rounding error of about 2^-24 near the end of the schedule,
    so the learning rates agree to init·2^-22 absolute (the port's is the
    float64 value)."""
    return pytest.approx(want, rel=1e-6, abs=init * 2**-22)


def test_cosine_lr_matches_optax_across_the_freeze():
    for init in (tntc.LR_FP, tntc.LR_MLP):
        sched = optax.cosine_decay_schedule(init, 20, alpha=0.0)
        for t in range(30):
            assert tntc.cosine_lr(init, t, 20) == _lr_approx(
                init, float(sched(t)))
    # in the trainer: each optimizer's own count, the grids' stopping at
    # the freeze (step 20 of 20 epochs), the MLP's running on
    _, ttr, _ = _pair(crop_mip_level=4, num_crops=2, num_epochs=20)
    s = ttr.state
    for t in range(24):
        ttr.train_step()
        mlp_lr = s.opt_mlp.param_groups[0]["lr"]
        assert mlp_lr == _lr_approx(tntc.LR_MLP, float(
            optax.cosine_decay_schedule(tntc.LR_MLP, 20, alpha=0.0)(t)))
        fp_lr = s.opt_fp.param_groups[0]["lr"]
        assert fp_lr == _lr_approx(tntc.LR_FP, float(
            optax.cosine_decay_schedule(tntc.LR_FP, 20, alpha=0.0)(
                min(t, 19))))
    assert s.frozen
    assert tntc.adam_count(s.opt_fp) == 20
    assert tntc.adam_count(s.opt_mlp) == 24


def test_forward_mode_matches_jax():
    """Every engine's gates resolve as JAX's on every LOD of mip-mode
    configs, and the engine that runs is the one JAX runs (the PE
    settings reach only the kernel3 gate)."""
    checked = set()
    for forward in ("kernel3", "kernel2", "kernel", "gather"):
        pes = (((6, True), (4, True), (6, False), (10, True))
               if forward == "kernel3" else ((6, True), (6, False)))
        for crop_mip, crops in ((4, 8), (5, 3), (6, 2)):
            for pe, tri in pes:
                kw = dict(tf_no_mip=False, max_mip_level=6,
                          train_forward=forward, crop_mip_level=crop_mip,
                          num_crops=crops, pe_channels=pe, tf_use_tri_pe=tri)
                kw = {**BASE, **kw}
                jcfg = JConfig(**kw)
                jtr = jntc.NTCTrainer(jcfg, j_load_asset(jcfg))
                ttr = tntc.NTCTrainer(
                    TConfig(device="cpu", **kw),
                    [np.zeros((3, 64 >> i, 64 >> i), np.float32)
                     for i in range(7)])
                for lod in range(7):
                    jtr._build_step(lod, False, jit=False)
                    plan = ttr._plan(lod, False)
                    assert plan.mode == jtr._forward_mode, (kw, lod)
                    checked.add(plan.mode)
    assert checked == {"kernel3", "kernel2", "kernel", "gather"}


# the configuration and LOD of each (forward, dtype) case beyond the
# no-mip flagship at LOD 0: kernel2 as the sinusoidal-PE engine; kernel at
# a mip-mode LOD with step 2 (the G1 raw-sum quirk in the gather that K6's
# dx flows back through) and at LOD 0
ONE_STEP = {("kernel2", 16): (dict(tf_use_tri_pe=False), 0),
            ("kernel2", 32): (dict(tf_use_tri_pe=False), 0),
            ("kernel", 16): (dict(tf_no_mip=False, max_mip_level=6), 3)}


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("forward,dtype", [
    ("gather", 32), ("gather", 16), ("kernel3", 16), ("kernel2", 16),
    ("kernel2", 32), ("kernel", 16), ("kernel", 32)])
def test_one_step_matches_jax(forward, dtype, frozen):
    extra, lod = ONE_STEP.get((forward, dtype), ({}, 0))
    jtr, ttr, lines = _pair(train_forward=forward, mlp_num_dtype=dtype,
                            num_epochs=100, crop_mip_level=4, **extra)
    if frozen:
        jtr.freeze_and_quantize()
        ttr.freeze_and_quantize()
    _, n, step = jtr._geometry(lod)
    assert step == (2.0 if lod else 0.25)
    fn = jtr._build_step(lod, frozen, jit=False)
    assert jtr._forward_mode == forward
    sub = jax.random.split(jtr._key)[1]
    s = jtr.state
    with pltpu.force_tpu_interpret_mode():
        fp, mlp, opt_fp, opt_mlp, jloss, _ = fn(s.fp, s.mlp, s.opt_fp,
                                                s.opt_mlp, sub)
    origins, kw = _jax_draws(jtr.cfg, n, sub, frozen, forward, lod)
    loss, _ = ttr.step_core(lod, origins, **kw)
    assert ttr._forward_mode == forward
    assert f"frozen={frozen}): {forward}" in lines[0]

    tol_loss, tol_grad = TOL[dtype]
    assert abs(float(loss) - float(jloss)) / float(jloss) < tol_loss
    ts = ttr.state
    groups = [("mlp", [ts.mlp[k] for k in PARAM_NAMES],
               [opt_mlp[0].mu[k] for k in PARAM_NAMES],
               [mlp[k] for k in PARAM_NAMES], ts.opt_mlp)]
    if not frozen:
        groups.append(("fp", list(ts.fp), list(opt_fp[0].mu), list(fp),
                       ts.opt_fp))
    for name, params, jmu, jparams, opt in groups:
        lr = tntc.LR_MLP if name == "mlp" else tntc.LR_FP
        for i, (p, mu, jp) in enumerate(zip(params, jmu, jparams)):
            # Adam's first moment after one update: (1 − b1)·grad
            tmu = opt.state[p]["exp_avg"].numpy()
            assert _rel(tmu, mu) < tol_grad, (name, i)
            g, dg = np.abs(np.asarray(mu)) / 0.1, np.abs(tmu - mu) / 0.1
            bound = 1e-6 + lr * dg / (g + 1e-8)
            diff = np.abs(p.detach().numpy() - np.asarray(jp))
            assert (diff <= bound).all(), (name, i, diff.max())
    if frozen:  # frozen grids stay as they were
        for p, jp in zip(ts.fp, fp):
            np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jp))


def _state_arrays(fp, mlp, opt_fp, opt_mlp):
    """JAX state → the port's npz key layout, for comparison."""
    from nic.io.artifacts import _flatten_tree

    out = _flatten_tree({"fp": fp, "mlp": mlp}, "params")
    out.update(_flatten_tree({"fp": opt_fp, "mlp": opt_mlp}, "opt"))
    return out


def test_checkpoints_cross_load_both_ways(tmp_path):
    from nic_torch.io import convert

    jtr, ttr, _ = _pair(crop_mip_level=4, num_epochs=50)
    jtr.train_many(3, chunk=3)
    jpath = str(tmp_path / "jax.npz")
    jtr.save_checkpoint(jpath)
    ttr.load_checkpoint(jpath)
    assert ttr.state.step == 3 and not ttr.state.frozen
    js = jtr.state
    want = _state_arrays(js.fp, js.mlp, js.opt_fp, js.opt_mlp)
    ts = ttr.state
    got = convert.trainer_state_to_arrays(ts.fp, ts.mlp, ts.opt_fp,
                                          ts.opt_mlp)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)

    # the port trains on and writes; JAX resumes from the port's file
    ttr.train_many(2)
    tpath = str(tmp_path / "torch.npz")
    ttr.save_checkpoint(tpath)
    jtr2 = jntc.NTCTrainer(jtr.cfg, j_load_asset(jtr.cfg))
    jtr2.load_checkpoint(tpath)
    assert jtr2.state.step == 5
    got = convert.trainer_state_to_arrays(ts.fp, ts.mlp, ts.opt_fp,
                                          ts.opt_mlp)
    js = jtr2.state
    want = _state_arrays(js.fp, js.mlp, js.opt_fp, js.opt_mlp)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k], err_msg=k)
    jtr2.train_many(1, chunk=1)  # and it trains from there

    # a post-freeze checkpoint before the new schedule's freeze unfreezes
    ttr.freeze_and_quantize()
    ttr.save_checkpoint(tpath)
    _, ttr3, _ = _pair(crop_mip_level=4, num_epochs=50)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ttr3.load_checkpoint(tpath)
    assert any("unfreezing" in str(x.message) for x in w)
    assert not ttr3.state.frozen and ttr3.state.fp[0].requires_grad


def test_kernel3_run_tracks_jax_across_the_freeze():
    """22 steps at NUM_EPOCHS=20 (the grids freeze before step 20), the
    flagship modes (bf16 dot inputs, poly GELU, in-kernel feature noise):
    the port's kernel3 step core fed JAX's per-step origins and seed
    words tracks JAX's kernel3 losses at the JAX suite's rtol 2e-3."""
    jtr, ttr, lines = _pair(train_forward="kernel3", num_epochs=20)
    _, n, _ = jtr._geometry(0)
    jl, tl = [], []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(22):
            sub = jax.random.split(jtr._key)[1]  # what train_step will use
            loss, _, lod = jtr.train_step()
            assert lod == 0 and jtr._forward_mode == "kernel3"
            jl.append(float(loss))
            s = ttr.state
            if not s.frozen and s.step > ttr.cfg.num_epochs * 0.95:
                ttr.freeze_and_quantize()
            origins, kw = _jax_draws(jtr.cfg, n, sub, s.frozen, "kernel3")
            tl.append(float(ttr.step_core(0, origins, **kw)[0]))
            s.step += 1
    assert jtr.state.frozen and ttr.state.frozen
    assert [ln.split(":")[1].split()[0] for ln in lines] == ["kernel3"] * 2
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert tl[19] < tl[0]
