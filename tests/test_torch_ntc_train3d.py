"""nic_torch.train.ntc in 3D (methods 3 and 4) against nic.train.ntc on the
CPU.

The engine gates at the misty protocol's geometry (64³, 8 crops of 32³,
MAX_MIP_LEVEL 6) on every LOD, flag-free and in mip mode; one train step
of each engine from identical params, crops and noise (JAX's own draws
replayed through the port's step core, the JAX kernels in Pallas
interpret mode) on a 16³ clip cut from ``data/misty_64_64.avi`` (two
crops of 8³); and checkpoints in both directions. Tolerances as in
test_torch_ntc_train.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)
from jax.experimental.pallas import tpu as pltpu

from nic.cli.image_compression import load_asset as j_load_asset
from nic.config import CompressionConfig as JConfig
from nic.train import ntc as jntc
from nic_torch.cli.image_compression import load_asset as t_load_asset
from nic_torch.config import CompressionConfig as TConfig
from nic_torch.data import assets as tassets
from nic_torch.models.mlp import PARAM_NAMES
from nic_torch.train import ntc as tntc
from test_torch_ntc_train import TOL, _rel

PROTOCOL = dict(image_path="data/misty_64_64.avi", image_dimension=3,
                image_size=64, max_mip_level=6, crop_mip_level=5,
                sdc_guard_train=False)


@pytest.fixture(scope="module")
def clip16(tmp_path_factory):
    """The clip's first 16 frames of 16² as a 16³ AVI (the port's writer,
    read by both packages' readers)."""
    path = str(tmp_path_factory.mktemp("clip") / "misty16.avi")
    tassets.write_timelaps(tassets.read_clip(PROTOCOL["image_path"])
                           [:16, :16, :16], path)
    return path


@pytest.fixture(scope="module")
def clip32(tmp_path_factory):
    """The clip's first 32 frames of 32² as a 32³ AVI."""
    path = str(tmp_path_factory.mktemp("clip") / "misty32.avi")
    tassets.write_timelaps(tassets.read_clip(PROTOCOL["image_path"])
                           [:32, :32, :32], path)
    return path


def _small(clip, **kw):
    return {**dict(image_path=clip, image_dimension=3, image_size=16,
                   max_mip_level=4, crop_mip_level=3, num_crops=2,
                   num_epochs=100, sdc_guard_train=False), **kw}


def _pair(kw):
    jcfg = JConfig(**kw)
    tcfg = TConfig(device="cpu", **kw)
    jtr = jntc.NTCTrainer(jcfg, j_load_asset(jcfg))
    lines = []
    timgs = t_load_asset(tcfg)
    for a, b in zip(timgs, j_load_asset(jcfg)):
        np.testing.assert_array_equal(a, np.asarray(b))
    ttr = tntc.NTCTrainer(tcfg, timgs, log=lines.append)
    with torch.no_grad():
        for dst, src in zip(ttr.state.fp, jtr.state.fp):
            assert tuple(dst.shape) == src.shape
            dst.copy_(torch.from_numpy(np.array(src)))
        for k in PARAM_NAMES:
            ttr.state.mlp[k].copy_(torch.from_numpy(np.array(
                jtr.state.mlp[k])))
    return jtr, ttr, lines


def test_forward_mode_3d_matches_jax():
    """Every engine's gates resolve as JAX's on every LOD of the misty
    protocol, methods 3 and 4, flag-free and in mip mode: kernel3 (K12) at
    the step ≤ 1 LODs ff3_geometry admits, kernel (K6) where the lattice
    or the block rule refuses, kernel2 (K9) under TRAIN_FORWARD=kernel2."""
    seen = {}
    for forward in ("kernel3", "kernel2", "kernel", "gather"):
        for method in (3, 4):
            for no_mip in (True, False):
                kw = dict(PROTOCOL, train_forward=forward,
                          compression_method=method, tf_no_mip=no_mip)
                jcfg = JConfig(**kw)
                tcfg = TConfig(device="cpu", **kw)
                imgs = [np.zeros((3, 64, 64, 64), np.float32)] * (
                    tcfg.effective_max_mip_level + 1)
                jtr = jntc.NTCTrainer(jcfg, imgs)
                ttr = tntc.NTCTrainer(tcfg, imgs)
                for lod in range(tcfg.effective_max_mip_level + 1):
                    jtr._build_step(lod, False, jit=False)
                    plan = ttr._plan(lod, False)
                    assert plan.mode == jtr._forward_mode, (kw, lod)
                    seen[(forward, method, no_mip, lod)] = plan.mode
    # the table of the 3D path: flag-free LOD 0 and mip-mode LODs 0-6
    for method in (3, 4):
        assert seen[("kernel3", method, True, 0)] == "kernel3"
        assert [seen[("kernel3", method, False, lod)] for lod in range(7)] \
            == ["kernel3"] * 3 + ["kernel"] * 4
        assert seen[("kernel2", method, True, 0)] == "kernel2"


def _jax_draws3(cfg, n, data, sub, frozen, forward):
    """What JAX's train_step draws from its per-step key (ntc.py:761)."""
    k_crop, k_noise = jax.random.split(sub)
    origins = jax.random.randint(k_crop, (cfg.num_crops, 3), 0,
                                 jnp.asarray([data - n + 1] * 3, jnp.int32))
    kw = {}
    if not frozen:
        if forward == "kernel3":
            kw["seed"] = torch.from_numpy(np.array(
                jntc._k3_seed(k_noise, jnp.int32(0))))
        else:
            from nic.core.quant import qat_noise

            kw["eps"] = torch.from_numpy(np.array(qat_noise(
                k_noise, (cfg.num_crops * n**3, cfg.decoder_input_channels),
                cfg.fp_bits, jnp.float32)))
    return torch.from_numpy(np.array(origins)), kw


def _check_step(jtr, ttr, lines, lod, frozen, forward, sub, data):
    """One step at ``lod`` from JAX's per-step key ``sub`` in both
    packages: the loss, Adam's first moment (= (1 − b1)·grad) and the
    updated params, as in the 2D test."""
    _, n, _ = jtr._geometry(lod)
    fn = jtr._build_step(lod, frozen, jit=False)
    assert jtr._forward_mode == forward
    s = jtr.state
    with pltpu.force_tpu_interpret_mode():
        fp, mlp, opt_fp, opt_mlp, jloss, _ = fn(s.fp, s.mlp, s.opt_fp,
                                                s.opt_mlp, sub)
    origins, kw = _jax_draws3(jtr.cfg, n, data, sub, frozen, forward)
    loss, _ = ttr.step_core(lod, origins, **kw)
    assert ttr._forward_mode == forward
    assert f"(lod={lod}, frozen={frozen}): {forward}" in lines[0]

    tol_loss, tol_grad = TOL[jtr.cfg.mlp_num_dtype]
    assert np.isfinite(float(jloss))
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
            tmu = opt.state[p]["exp_avg"].numpy()
            assert _rel(tmu, mu) < tol_grad, (name, i)
            g, dg = np.abs(np.asarray(mu)) / 0.1, np.abs(tmu - mu) / 0.1
            bound = 1e-6 + lr * dg / (g + 1e-8)
            diff = np.abs(p.detach().numpy() - np.asarray(jp))
            assert (diff <= bound).all(), (name, i, diff.max())


@pytest.mark.parametrize("forward,dtype,method,frozen", [
    ("gather", 32, 3, False), ("gather", 16, 4, True),
    ("kernel3", 16, 3, False), ("kernel3", 32, 4, False),
    ("kernel2", 32, 3, False), ("kernel2", 16, 4, False),
    ("kernel", 32, 3, False)])
def test_one_step_3d_matches_jax(clip16, forward, dtype, method, frozen):
    """One LOD-0 step (8³ crops at step ¼) from identical params and
    draws."""
    jtr, ttr, lines = _pair(_small(clip16, train_forward=forward,
                                   mlp_num_dtype=dtype,
                                   compression_method=method))
    if frozen:
        jtr.freeze_and_quantize()
        ttr.freeze_and_quantize()
    assert jtr._geometry(0)[1:] == (8, 0.25)
    _check_step(jtr, ttr, lines, 0, frozen, forward,
                jax.random.split(jtr._key)[1], 16)


def _key_inside(cfg, lod_geometry, grid_nodes, data):
    """The first of 2^16 per-step keys whose crop draw stays inside the
    LOD's grids (JAX's gather reads NaN past them), found in one
    vectorized draw."""
    _, n, step = lod_geometry
    subs = jax.random.split(jax.random.PRNGKey(7), 1 << 16)
    orgs = jax.vmap(lambda k: jax.random.randint(
        jax.random.split(k)[0], (cfg.num_crops, 3), 0,
        jnp.asarray([data - n + 1] * 3, jnp.int32)))(subs)
    last = np.asarray(orgs).max(axis=(1, 2)) + n - 1
    inside = (np.floor(last * step) + 2 <= grid_nodes[0]) & (
        np.floor(last * step / 2) + 2 <= grid_nodes[1])
    assert inside.any()
    return subs[int(np.argmax(inside))]


@pytest.mark.parametrize("lod,forward", [(1, "kernel3"), (2, "kernel")])
def test_mip_mode_step_3d_matches_jax(clip32, lod, forward):
    """A mip-mode step at a LOD ≥ 1 (kernel3 at step ½, kernel at step 1,
    the engines of the misty protocol's mip-mode LODs) whose crops stay
    inside the LOD's grids, where JAX's gather is finite: the witness of
    the mip-mode path beside the padding (the test below)."""
    jtr, ttr, lines = _pair(dict(_small(clip32, tf_no_mip=False,
                                        compression_method=3,
                                        train_forward="kernel3"),
                                 image_size=32, max_mip_level=5,
                                 crop_mip_level=4))
    fl = ttr.mip_to_level[lod]
    nodes = (ttr.state.fp[fl * 2].shape[1], ttr.state.fp[fl * 2 + 1].shape[1])
    sub = _key_inside(jtr.cfg, jtr._geometry(lod), nodes, 32)
    _check_step(jtr, ttr, lines, lod, False, forward, sub, 32)


def test_checkpoints_3d_cross_load_both_ways(clip16, tmp_path):
    from nic_torch.io import convert
    from test_torch_ntc_train import _state_arrays

    jtr, ttr, _ = _pair(_small(clip16, compression_method=4, num_epochs=20))
    jtr.train_many(2, chunk=2)
    jpath = str(tmp_path / "jax.npz")
    jtr.save_checkpoint(jpath)
    ttr.load_checkpoint(jpath)
    assert ttr.state.step == 2
    js, ts = jtr.state, ttr.state
    want = _state_arrays(js.fp, js.mlp, js.opt_fp, js.opt_mlp)
    got = convert.trainer_state_to_arrays(ts.fp, ts.mlp, ts.opt_fp,
                                          ts.opt_mlp)
    assert sorted(got) == sorted(want)
    assert got["params/fp/0"].ndim == 4  # [C, s, s, s]
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)

    ttr.train_many(1)
    tpath = str(tmp_path / "torch.npz")
    ttr.save_checkpoint(tpath)
    jtr2 = jntc.NTCTrainer(jtr.cfg, j_load_asset(jtr.cfg))
    jtr2.load_checkpoint(tpath)
    assert jtr2.state.step == 3
    got = convert.trainer_state_to_arrays(ts.fp, ts.mlp, ts.opt_fp,
                                          ts.opt_mlp)
    js = jtr2.state
    want = _state_arrays(js.fp, js.mlp, js.opt_fp, js.opt_mlp)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k], err_msg=k)
    jtr2.train_many(1, chunk=1)


def test_mip_mode_3d_stays_finite_where_jax_goes_nan(clip16):
    """3D mip mode cuts every LOD's crops from the full-resolution volume
    (the JAX rule, mirrored), so a LOD ≥ 1 crop reaches past its grids:
    the JAX gather reads NaN there and its loss turns NaN at the first such
    draw, while the port pads the LOD's grids with zero nodes and trains
    on (the one reference behaviour the port does not mirror: a fault of
    the reference, ROADMAP.md queue 3)."""
    jtr, ttr, _ = _pair(_small(clip16, compression_method=3, tf_no_mip=False,
                               num_epochs=60))
    cfg = ttr.cfg
    rng = np.random.default_rng(cfg.seed + 1)
    gate = tntc.UniformLodSchedule(cfg.uniform_distribution_rate)
    lods = [tntc.sample_lod(rng, gate(), cfg.effective_max_mip_level)
            for _ in range(10)]
    jl = np.asarray(jtr.train_many(10, chunk=10)[0])
    tl = np.asarray(ttr.train_many(10)[0])
    assert np.isnan(jl).any() and np.isfinite(tl).all()
    first = int(np.argmax(np.isnan(jl)))
    assert lods[first] >= 1 and not any(lods[:first])
    assert np.isfinite(jl[:first]).all()
