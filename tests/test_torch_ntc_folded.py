"""The folded first layer with tile/crop origins and precomputed planes,
``TRAIN_FORWARD=folded`` and the tiled decode of nic_torch.train.ntc,
against the JAX package on the CPU at the JAX suite's tiny configurations
(tests/test_ntc_train.py: 32² with crops of 16², 16³ with crops of 8³;
C = 4, PE 4, H = 16, fp32 dots).

One folded step from identical params and JAX's own draws (crops, and the
ε that JAX's folded forward shares with its gather path) is held to JAX's
in loss, grads (Adam's first moment after one update) and post-Adam
params, at the tolerances of the port's other one-step tests, and to the
port's own gather step from the same draws. The tiled decode is held to
the whole decode and to JAX's tiled decode, gate-log lines included."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)

from nic.config import CompressionConfig as JConfig
from nic.core.quant import qat_noise
from nic.grids import fastdecode as jfd
from nic.grids.pyramid import pyramid_mip_levels
from nic.train import ntc as jntc
from nic_torch.config import CompressionConfig as TConfig
from nic_torch.grids import fastdecode as tfd
from nic_torch.models.mlp import PARAM_NAMES
from nic_torch.train import ntc as tntc
from test_torch_fastdecode import BASE, C, PE, SIZE, both, make_model

TINY = dict(image_size=32, crop_mip_level=4, num_crops=4, num_epochs=300,
            fp_bits=4, feature_pyramid_channels=4, pe_channels=4,
            hidden_layer_channels=16, max_mip_level=5, tf_no_mip=True,
            seed=0, mlp_num_dtype=32, sdc_guard_train=False)
TINY_3D = dict(TINY, image_size=16, image_dimension=3, crop_mip_level=3,
               num_crops=2, num_epochs=60, max_mip_level=4)


def _toy_image(size):
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.stack([np.sin(6 * x) * 0.5 + 0.5, y, ((x + y) % 0.25) * 4.0])
    return np.clip(img, 0, 1)


def _toy_volume():
    rng = np.random.default_rng(0)
    vol = rng.uniform(0, 1, (3, 16, 16, 16)).astype(np.float32)
    return (vol + np.roll(vol, 1, axis=1)) / 2


def _images(kw):
    if kw.get("image_dimension", 2) == 3:
        return [_toy_volume()]
    img = _toy_image(32)
    if kw["tf_no_mip"]:
        return [img]
    return [img[:, ::2**i, ::2**i] for i in range(6)]


def _trainers(kw, forwards):
    """A JAX trainer and one port trainer per forward, all holding the JAX
    trainer's initial params."""
    images = _images(kw)
    jlines = []
    jtr = jntc.NTCTrainer(JConfig(**kw), images, log=jlines.append)
    ports = {}
    for fwd in forwards:
        lines = []
        ttr = tntc.NTCTrainer(TConfig(device="cpu", **{**kw,
                                                        "train_forward": fwd}),
                              images, log=lines.append)
        with torch.no_grad():
            for dst, src in zip(ttr.state.fp, jtr.state.fp):
                dst.copy_(torch.from_numpy(np.array(src)))
            for k in PARAM_NAMES:
                ttr.state.mlp[k].copy_(torch.from_numpy(np.array(
                    jtr.state.mlp[k])))
        ports[fwd] = (ttr, lines)
    return jtr, jlines, ports


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


# ---- origin= and planes= ---------------------------------------------------

@pytest.mark.parametrize("mip", [0, 1, 2])
def test_first_layer_acc_origin_and_planes_match_jax(mip):
    """A tile of 8 at origin (5, 7) (a gather on every axis, e from −2 to
    0) with the fold precomputed once, in both packages."""
    (jfp, jmlp), (tfp, tmlp) = both(*make_model(91))
    m2l = pyramid_mip_levels(SIZE, BASE)
    fl = m2l[mip]
    kw = dict(image_size=SIZE, mip_to_level=m2l, pe_channels=PE,
              use_tri_pe=True, ndim=2, origin=(5, 7), n=8)
    pkw = dict(ndim=2, channels=C, pe_channels=PE)
    jplanes = jfd.precompute_first_layer(jfp, fl, jmlp, **pkw)
    want = np.asarray(jfd.first_layer_acc(jfp, jmlp, mip, planes=jplanes,
                                          **kw))
    want_rgb = np.asarray(jfd.fast_decode(jfp, jmlp, mip, planes=jplanes,
                                          **kw))
    with torch.inference_mode():
        tplanes = tfd.precompute_first_layer(tfp, fl, tmlp, **pkw)
        got = tfd.first_layer_acc(tfp, tmlp, mip, planes=tplanes, **kw)
        got_rgb = tfd.fast_decode(tfp, tmlp, mip, planes=tplanes, **kw)
        again = tfd.first_layer_acc(tfp, tmlp, mip, **kw)  # its own fold
        whole = tfd.first_layer_acc(tfp, tmlp, mip, **{**kw, "origin": None,
                                                        "n": None})
    assert got.shape == want.shape == (8, 8, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_rgb.numpy(), want_rgb, atol=2e-5, rtol=0)
    assert torch.equal(got, again)
    # the tile is a window of the whole decode
    np.testing.assert_allclose(got.numpy(), whole[5:13, 7:15].numpy(),
                               atol=2e-5, rtol=0)


# ---- one TRAIN_FORWARD=folded step ------------------------------------------

@pytest.mark.parametrize("case", ["2d", "2d-mip-lod1", "3d-m3", "3d-m4"])
def test_folded_step_matches_jax_and_gather(case):
    kw = dict(TINY_3D if case.startswith("3d") else TINY, train_forward="folded")
    lod = 0
    if case == "2d-mip-lod1":
        kw["tf_no_mip"], lod = False, 1
    if case.startswith("3d"):
        kw["compression_method"] = int(case[-1])
    jtr, _, ports = _trainers(kw, ("folded", "gather"))
    _, n, _ = jtr._geometry(lod)
    fn = jtr._build_step(lod, False)
    assert jtr._forward_mode == "folded"
    sub = jax.random.PRNGKey(7)
    s = jtr.state
    fp, mlp, opt_fp, opt_mlp, jloss, _ = fn(s.fp, s.mlp, s.opt_fp,
                                            s.opt_mlp, sub)
    # JAX's draws from the step key (nic/train/ntc.py:761): crops over the
    # LOD's image (the whole volume in 3D), the ε its gather path shares
    ndim = jtr.ndim
    k_crop, k_noise = jax.random.split(sub)
    size = jtr.images[lod].shape[1]
    origins = torch.from_numpy(np.array(jax.random.randint(
        k_crop, (kw["num_crops"], ndim), 0,
        jnp.asarray([size - n + 1] * ndim, jnp.int32))))
    eps = torch.from_numpy(np.array(qat_noise(
        k_noise, (kw["num_crops"] * n**ndim, jtr.cfg.decoder_input_channels),
        kw["fp_bits"], jnp.float32)))

    losses = {}
    for fwd, (ttr, lines) in ports.items():
        loss, _ = ttr.step_core(lod, origins, eps=eps)
        assert ttr._forward_mode == fwd
        assert f"(lod={lod}, frozen=False): {fwd} [" in lines[0]
        losses[fwd] = float(loss)
    assert abs(losses["folded"] - float(jloss)) / float(jloss) < 1e-5
    assert abs(losses["folded"] - losses["gather"]) / losses["gather"] < 1e-5
    tf, tg = ports["folded"][0].state, ports["gather"][0].state
    for name, params, gparams, jmu, jparams, opt, gopt, lr in (
            ("mlp", [tf.mlp[k] for k in PARAM_NAMES],
             [tg.mlp[k] for k in PARAM_NAMES],
             [opt_mlp[0].mu[k] for k in PARAM_NAMES],
             [mlp[k] for k in PARAM_NAMES], tf.opt_mlp, tg.opt_mlp,
             tntc.LR_MLP),
            ("fp", list(tf.fp), list(tg.fp), list(opt_fp[0].mu), list(fp),
             tf.opt_fp, tg.opt_fp, tntc.LR_FP)):
        for i, (p, gp, mu, jp) in enumerate(zip(params, gparams, jmu,
                                                jparams)):
            # Adam's first moment after one update: (1 − b1)·grad
            tmu = opt.state[p]["exp_avg"].numpy()
            assert _rel(tmu, mu) < 1e-4, (name, i)
            assert _rel(tmu, gopt.state[gp]["exp_avg"].numpy()) < 1e-4, (
                name, i)
            g, dg = np.abs(np.asarray(mu)) / 0.1, np.abs(tmu - mu) / 0.1
            bound = 1e-6 + lr * dg / (g + 1e-8)
            diff = np.abs(p.detach().numpy() - np.asarray(jp))
            assert (diff <= bound).all(), (name, i, diff.max())


# ---- the tiled decode --------------------------------------------------------

@pytest.mark.parametrize("ndim,backend", [(2, "xla"), (2, "fast"),
                                          (3, "xla"), (3, "fast")])
def test_tiled_decode_matches_whole_and_jax(ndim, backend):
    """Mip mode, 2D DIV_SIZE=3 (4×4 tiles of 8² at mip 0), 3D DIV_SIZE=2
    (4³ tiles of 4³): the stitched tiles equal the whole decode and JAX's
    tiled decode; the gate logs name the same branch."""
    kw = dict(TINY if ndim == 2 else TINY_3D, decode_backend=backend,
              tf_no_mip=False)
    div = 3 if ndim == 2 else 2
    jtr, jlines, ports = _trainers(kw, ("gather",))
    ttr, lines = ports["gather"]
    want = np.asarray(jtr.decode(0, div_size=div))
    tiled = ttr.decode(0, div_size=div)
    whole = ttr.decode(0, div_size=10)
    size = kw["image_size"]
    assert tiled.shape == whole.shape == (size,) * ndim + (3,)
    np.testing.assert_allclose(tiled.numpy(), whole.numpy(), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(tiled.numpy(), want, atol=2e-5, rtol=0)
    gate = [ln for ln in lines if ln.startswith("decode backend gate")]
    jgate = [ln for ln in jlines if ln.startswith("decode backend gate")]
    assert gate[0] == jgate[0]
    assert f"tiled ({4**ndim} tiles, " in gate[0]
