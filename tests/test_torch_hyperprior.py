"""nic_torch's scale-hyperprior codec against nic's, on the CPU: the model
forward, one training step, checkpoints, the params digest and .nicx,
K13's plain version (σ → bin) against JAX's ``h_s_bins``, the codec and
the CLIs. n = 8, m = 12, 64×64 images (one 80×48 for the edge pad); the
JAX parameters are built once per module, jitted, with seeded biases."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)

from nic.io import artifacts as jart
from nic.io import bitstream as jbits
from nic.models.hyperprior import HyperpriorModel as JaxModel
from nic.models.hyperprior import rd_loss as jax_rd_loss
from nic.train.hyperprior import HyperpriorCodec as JaxCodec
from nic_torch.io import bitstream as tbits
from nic_torch.io.convert import hyperprior_from_jax, hyperprior_to_jax
from nic_torch.kernels import hs_bins as k13
from nic_torch.models.hyperprior import HyperpriorModel
from nic_torch.train.hyperprior import HyperpriorCodec, HyperpriorTrainer

N, M = 8, 12
LAM = 0.01
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree) -> dict:
    return {"/".join(str(q.key) for q in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_model():
    """(flax model, params, flat {leaf path: array}): lecun-normal kernels
    from the jitted init, biases and the z prior seeded so that their
    layouts are exercised."""
    model = JaxModel(N, M)
    params = jax.jit(lambda k, x: model.init({"params": k}, x, None))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(1)
    flat = {k: (v if k.endswith("kernel") else
                v + rng.normal(0, 0.05, v.shape).astype(np.float32))
            for k, v in _flat(params["params"]).items()}
    params = {"params": jax.tree.map(jnp.asarray, tbits.nest(flat))}
    return model, params, flat


def _port_model(flat) -> HyperpriorModel:
    model = HyperpriorModel(N, M)
    hyperprior_from_jax(model, flat)
    return model


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2), order="C"))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _images():
    """Two 64×64 crops of sancho and one 80×48 (padded to 128×64)."""
    from nic_torch.data.assets import load_rgb

    img = load_rgb(os.path.join(ROOT, "data", "sancho_512.png"))
    return img[200:264, 180:244], img[40:104, 300:364], img[300:380, 60:108]


def _jax_codec(jax_model):
    model, params, _ = jax_model
    return JaxCodec(types.SimpleNamespace(model=model, params=params))


def test_layouts_round_trip(jax_model):
    _, _, flat = jax_model
    back = hyperprior_to_jax(_port_model(flat))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_forward_matches_jax(jax_model):
    """x̂, y, z within 1e-5 and the bits rel 1e-5, with JAX's own noise
    draws (ky, kz = split(key), as HyperpriorModel.__call__)."""
    model, params, flat = jax_model
    x = np.stack(_images()[:2])
    key = jax.random.PRNGKey(3)

    @jax.jit
    def fwd(p, x, key):
        y = model.apply(p, x, method=model.analysis)
        z = model.apply(p, y, method=model.hyper_analysis)
        ky, kz = jax.random.split(key)
        uy = jax.random.uniform(ky, y.shape, y.dtype, -0.5, 0.5)
        uz = jax.random.uniform(kz, z.shape, z.dtype, -0.5, 0.5)
        return model.apply(p, x, key), y, z, uy, uz

    (xh, yb, zb), y, z, uy, uz = fwd(params, x, key)
    pm = _port_model(flat)
    with torch.no_grad():
        pxh, pyb, pzb = pm(_nchw(x), (_nchw(uy), _nchw(uz)))
        py = pm.analysis(_nchw(x))
        pz = pm.hyper_analysis(py)
    np.testing.assert_allclose(_nhwc(pxh), np.asarray(xh), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_nhwc(py), np.asarray(y), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_nhwc(pz), np.asarray(z), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pyb.numpy(), np.asarray(yb), rtol=1e-5)
    np.testing.assert_allclose(pzb.numpy(), np.asarray(zb), rtol=1e-5)


def test_rounded_codes_match_jax(jax_model):
    """ŷ/ẑ = round(y/z), half to even on both sides: equal wherever the
    value is not within 1e-4 of a half."""
    model, params, flat = jax_model
    x = np.stack(_images()[:2])
    y = np.asarray(jax.jit(lambda p, x: model.apply(
        p, x, method=model.analysis))(params, x))
    z = np.asarray(jax.jit(lambda p, y: model.apply(
        p, y, method=model.hyper_analysis))(params, y))
    pm = _port_model(flat)
    with torch.no_grad():
        py = pm.analysis(_nchw(x))
        pz = pm.hyper_analysis(py)
    for ours, theirs in ((py, y), (pz, z)):
        keep = np.abs(np.abs(theirs - np.floor(theirs)) - 0.5) > 1e-4
        assert keep.mean() > 0.99
        np.testing.assert_array_equal(
            torch.round(ours).permute(0, 2, 3, 1).numpy()[keep],
            np.round(theirs)[keep])


def test_train_step_matches_jax(jax_model):
    """One step from the same params, batch and noise: loss rel 1e-5,
    every leaf's grad max|Δ|/max|g| ≤ 1e-4, params after optax's
    clip_by_global_norm(1) + adam(1e-4) within 1e-6."""
    model, params, flat = jax_model
    x = np.stack(_images()[:2])
    key = jax.random.PRNGKey(7)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4))

    def loss_fn(p, xb, k):
        xh, yb, zb = model.apply(p, xb, k)
        return jax_rd_loss(xh, xb, yb, zb, LAM)[0]

    @jax.jit
    def step(p, xb, k):
        loss, g = jax.value_and_grad(loss_fn)(p, xb, k)
        upd, _ = tx.update(g, tx.init(p), p)
        y = model.apply(p, xb, method=model.analysis)
        z = model.apply(p, y, method=model.hyper_analysis)
        ky, kz = jax.random.split(k)
        noise = (jax.random.uniform(ky, y.shape, y.dtype, -0.5, 0.5),
                 jax.random.uniform(kz, z.shape, z.dtype, -0.5, 0.5))
        return loss, g, optax.apply_updates(p, upd), noise

    loss, grads, new, (uy, uz) = step(params, x, key)
    tr = HyperpriorTrainer(n=N, m=M, lam=LAM, patch=64, batch=2,
                           device="cpu")
    hyperprior_from_jax(tr.model, flat)
    got = tr.loss_and_grads(x, (_nchw(uy), _nchw(uz)))
    assert abs(float(got[0]) - float(loss)) <= 1e-5 * abs(float(loss))
    from nic_torch.io.convert import hyperprior_leaves

    tgrads = hyperprior_to_jax(tr.model, {
        k: p.grad for k, (p, _, _) in hyperprior_leaves(tr.model).items()})
    jgrads = _flat(grads["params"])
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in jgrads.values()))
    assert norm > 1.0  # the step clips
    for k, g in jgrads.items():
        scale = max(float(np.abs(g).max()), 1e-30)
        assert float(np.abs(tgrads[k] - g).max()) / scale <= 1e-4, k
    tr.apply_grads()
    after = hyperprior_to_jax(tr.model)
    for k, v in _flat(new["params"]).items():
        np.testing.assert_allclose(after[k], v, atol=1e-6, rtol=0, err_msg=k)


def test_checkpoints_interchange_with_jax(jax_model, tmp_path):
    """A port checkpoint restores in JAX's load_checkpoint (params and the
    clipped Adam chain's state), and a JAX one in the port."""
    model, params, flat = jax_model
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4))
    tr = HyperpriorTrainer(n=N, m=M, lam=LAM, patch=64, batch=2,
                           device="cpu")
    hyperprior_from_jax(tr.model, flat)
    tr.train_step(np.stack(_images()[:2]))
    path = str(tmp_path / "port.npz")
    tr.save_checkpoint(path)
    step, jp, jopt = jart.load_checkpoint(path, params, tx.init(params))
    assert step == 1
    for k, v in hyperprior_to_jax(tr.model).items():
        np.testing.assert_array_equal(_flat(jp["params"])[k], v)
    arrays = tr.state_arrays()
    jflat = jart._flatten_tree(jopt, "opt")
    assert sorted(jflat) == sorted(k for k in arrays if k.startswith("opt"))
    for k, v in jflat.items():
        np.testing.assert_array_equal(v, arrays[k])

    jpath = str(tmp_path / "jax.npz")
    jart.save_checkpoint(jpath, 5, jp, jopt, extra={"lam": LAM})
    back = HyperpriorTrainer(n=N, m=M, lam=LAM, patch=64, batch=2,
                             device="cpu")
    back.load_checkpoint(jpath)
    assert back.step == 5
    jp_flat = jart._flatten_tree(jp, "params")
    for k, v in back.state_arrays().items():
        np.testing.assert_array_equal(
            v, jp_flat[k] if k.startswith("params") else jflat[k])
    with pytest.raises(ValueError, match="mismatch"):
        HyperpriorTrainer(n=N, m=M + 4, patch=64, batch=1,
                          device="cpu").load_checkpoint(jpath)


def test_params_digest_matches_jax(jax_model):
    model, params, flat = jax_model
    tree = {"params": tbits.nest(hyperprior_to_jax(_port_model(flat)))}
    assert tbits.params_digest(tree) == jbits.params_digest(params)


def test_nicx_bytes_match_jax(jax_model, tmp_path):
    blob = _jax_codec(jax_model).compress(_images()[0])
    info = {"n": N, "m": M, "params_digest": "d", "ckpt": "c"}
    jbits.write_nicx(str(tmp_path / "j.nicx"), blob, info)
    tbits.write_nicx(str(tmp_path / "t.nicx"), blob, info)
    assert (tmp_path / "j.nicx").read_bytes() == (
        tmp_path / "t.nicx").read_bytes()
    got, model_info = tbits.read_nicx(str(tmp_path / "j.nicx"))
    assert model_info == info
    assert got == {k: (tuple(v) if isinstance(v, (tuple, list)) else v)
                   for k, v in blob.items()}


def test_hs_bins_plain_against_jax_h_s_bins(jax_model):
    """K13's plain version against JAX's ``h_s_bins`` on 98304 y
    elements: σ rel 1e-5, the share of differing bins ≤ 1e-3 (XLA's sums
    and libm are not the fixed order's)."""
    model, params, flat = jax_model
    rng = np.random.default_rng(5)
    z = np.round(rng.normal(0, 2.5, (2, 16, 16, N))).astype(np.float32)
    codec = _jax_codec(jax_model)
    want = np.asarray(codec._h_s_bins(jnp.asarray(z)))
    sigma_j = np.asarray(jax.jit(lambda p, z: model.apply(
        p, z, method=model.hyper_synthesis))(params, z))
    sigma, bins = k13.hs_bins_plain(
        _nchw(z), k13.hs_weights(_port_model(flat).h_s))
    np.testing.assert_allclose(_nhwc(sigma), sigma_j, rtol=1e-5)
    got = _nhwc(bins)
    assert got.size >= 50_000 and len(np.unique(got)) > 20
    differ = int((got != want).sum())
    print(f"K13 plain vs JAX h_s_bins: {differ} of {got.size} bins differ")
    assert differ / got.size <= 1e-3


def _ulps(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    spacing = np.spacing(np.abs(ref.astype(np.float32))).astype(np.float64)
    return np.abs(got.astype(np.float64) - ref) / np.maximum(spacing,
                                                             2.0**-149)


@pytest.mark.parametrize("name", ["exp", "log", "tanh"])
def test_fixed_routines_within_2_ulp(name):
    rng = np.random.default_rng(11)
    if name == "exp":
        x = np.concatenate([np.linspace(-103.9, 88.7, 400_001),
                            rng.uniform(-20, 20, 100_000)]).astype(np.float32)
        got, ref = k13.exp_fixed(torch.from_numpy(x)), np.exp(x.astype(float))
    elif name == "log":
        x = np.concatenate([
            np.exp(np.linspace(-103, 88, 400_001)),
            rng.uniform(0.5, 1.0, 100_000) * 2.0 ** rng.integers(
                -149, 127, 100_000)]).astype(np.float32)
        x = x[x > 0]
        got, ref = k13.log_fixed(torch.from_numpy(x)), np.log(x.astype(float))
    else:
        x = np.concatenate([np.linspace(-12, 12, 400_001),
                            rng.uniform(-1, 1, 100_000) * 2.0 ** rng.integers(
                                -40, 2, 100_000)]).astype(np.float32)
        got, ref = k13.tanh_fixed(torch.from_numpy(x)), np.tanh(x.astype(float))
    assert _ulps(got.numpy(), ref).max() <= 2.0


def test_fixed_routines_edges():
    inf, nan = float("inf"), float("nan")
    x = torch.tensor([89.0, 1e30, inf, -104.0, -1e30, -inf, -103.9, nan, 0.0])
    e = k13.exp_fixed(x)
    assert torch.isinf(e[:3]).all() and (e[:3] > 0).all()
    assert (e[3:6] == 0).all()
    assert e[6].item() == 2.0**-149 and torch.isnan(e[7]) and e[8] == 1.0
    s = torch.tensor([0.0, inf, nan, 1.0, 2.0**-149, -1.0])
    lg = k13.log_fixed(s)
    assert lg[0] == -inf and lg[1] == inf and torch.isnan(lg[2])
    assert lg[3] == 0.0 and torch.isnan(lg[5])
    assert abs(lg[4].item() - np.log(2.0**-149)) < 1e-4
    t = k13.tanh_fixed(torch.tensor([50.0, -50.0, inf, -inf, nan, 0.0]))
    assert t[:4].tolist() == [1.0, -1.0, 1.0, -1.0] and torch.isnan(t[4])


def test_hs_bins_overflow_and_underflow_bins(jax_model):
    """exp overflow → +inf → bin 63; underflow → 0 → log −inf → bin 0;
    JAX's h_s_bins gives the same."""
    model, params, flat = jax_model
    pm = _port_model(flat)
    z = np.zeros((1, 2, 2, N), np.float32)
    for bias, want in ((200.0, 63), (-200.0, 0)):
        with torch.no_grad():
            pm.h_s.convs[2].bias.fill_(bias)
        sigma, bins = k13.hs_bins_plain(_nchw(z), k13.hs_weights(pm.h_s))
        assert (bins == want).all()
        assert (sigma == (float("inf") if want else 0.0)).all()
        p = jax.tree.map(lambda a: a, params)
        p["params"]["h_s"]["MatmulConv_0"]["bias"] = jnp.full((M,), bias)
        jb = np.asarray(_jax_codec((model, p, flat))._h_s_bins(
            jnp.asarray(z)))
        assert (jb == want).all()


def test_codec_round_trip_equals_evaluate(jax_model):
    """Port compress → port decompress gives the trainer's evaluate x̂
    exactly (64×64, and 80×48 edge-padded to 128×64), with K13's bins
    (one launch of its wrapper per compress and per decompress)."""
    _, _, flat = jax_model
    tr = HyperpriorTrainer(n=N, m=M, lam=LAM, patch=64, batch=1,
                           device="cpu")
    hyperprior_from_jax(tr.model, flat)
    codec = HyperpriorCodec(tr)
    for img in (_images()[0], _images()[2]):
        psnr, bpp, x_eval = tr.evaluate(img)
        blob = codec.compress(img)
        assert blob["y_shape"][0] == 1 and blob["y_shape"][-1] == M
        assert blob["z_shape"][-1] == N
        x_hat = codec.decompress(blob)
        assert x_hat.shape == img.shape
        np.testing.assert_array_equal(x_hat, x_eval)
        assert codec.num_bits(blob) > 0 and np.isfinite(psnr) and bpp > 0
    # the bf16 synthesis changes the reconstruction only, never the streams
    bf16 = HyperpriorCodec(tr, synthesis_dtype=torch.bfloat16)
    img = _images()[0]
    blob = codec.compress(img)
    assert bf16.compress(img) == blob
    np.testing.assert_allclose(bf16.decompress(blob), codec.decompress(blob),
                               atol=0.05, rtol=0)


def test_jax_nicx_decodes_in_port(jax_model, tmp_path):
    """A .nicx written by the JAX codec decodes in the port: every bin of
    the image agrees, ŷ/ẑ are JAX's and x̂ is within 1e-5 of JAX's."""
    model, params, flat = jax_model
    jcodec = _jax_codec(jax_model)
    tr = HyperpriorTrainer(n=N, m=M, patch=64, batch=1, device="cpu")
    hyperprior_from_jax(tr.model, flat)
    codec = HyperpriorCodec(tr)
    for img in (_images()[1], _images()[2]):
        path = str(tmp_path / "j.nicx")
        jbits.write_nicx(path, jcodec.compress(img),
                         {"n": N, "m": M,
                          "params_digest": jbits.params_digest(params)})
        blob, info = tbits.read_nicx(path)
        assert info["params_digest"] == tbits.params_digest(tr.jax_tree())
        y_hat, z_hat = codec.decode_latents(blob)
        want_bins = np.asarray(jcodec._h_s_bins(
            jnp.asarray(z_hat, np.float32))).reshape(-1)
        np.testing.assert_array_equal(codec.bins_y(z_hat), want_bins)
        np.testing.assert_allclose(codec.decompress(blob),
                                   jcodec.decompress(blob), atol=1e-5,
                                   rtol=0)


def _train_dir(directory):
    from PIL import Image

    os.makedirs(directory)
    img = (_images()[0] * 255).astype(np.uint8)
    Image.fromarray(img).save(os.path.join(directory, "a.png"))
    wide = (np.concatenate(_images()[:2], axis=1) * 255).astype(np.uint8)
    Image.fromarray(wide).save(os.path.join(directory, "b.png"))


def test_hyperprior_clis_on_cpu(tmp_path):
    """hyperprior_comp (4 steps, checkpoints), hyperprior_codec compress
    and decompress (the digest check), eval_rd --codec hyperprior."""
    from nic_torch.cli import eval_rd, hyperprior_codec, hyperprior_comp

    d, out = str(tmp_path / "imgs"), str(tmp_path / "out")
    _train_dir(d)
    small = ["--n", str(N), "--m", str(M)]
    res = hyperprior_comp.run(small + [
        "--device", "cpu", "--patch", "64", "--batch", "2", "--steps", "4",
        "--interval_print", "2", "--interval_checkpoint", "2",
        "--train_dir", d, "--eval_dir", d, "--output_root", out])
    ckpt = res["checkpoint_dir"]
    assert sorted(os.listdir(ckpt)) == ["ckpt_000000000002.npz",
                                        "ckpt_000000000004.npz"]
    assert [r["image"] for r in res["images"]] == ["a.png", "b.png"]
    assert all(r["bpp_bitstream"] > 0 for r in res["images"])
    nicx = str(tmp_path / "a.nicx")
    common = small + ["--ckpt", ckpt, "--device", "cpu"]
    enc = hyperprior_codec.run(["compress", os.path.join(d, "a.png"),
                                "--out", nicx] + common)
    assert enc["bytes"] == os.path.getsize(nicx)
    dec = hyperprior_codec.run(["decompress", nicx, "--out",
                                str(tmp_path / "a.png")] + common)
    assert dec["shape"] == [64, 64, 3]
    tr = HyperpriorTrainer(n=N, m=M, patch=64, batch=1, device="cpu")
    tr.load_checkpoint(os.path.join(ckpt, "ckpt_000000000004.npz"))
    from nic_torch.data.assets import load_rgb

    np.testing.assert_array_equal(
        dec["image"], tr.evaluate(load_rgb(os.path.join(d, "a.png")))[2])
    other = hyperprior_comp.run(small + [
        "--device", "cpu", "--patch", "64", "--batch", "1", "--steps", "1",
        "--interval_checkpoint", "1", "--seed", "3", "--train_dir", d, "--eval_dir", d,
        "--output_root", str(tmp_path / "other")])
    with pytest.raises(ValueError, match="allow_model_mismatch"):
        hyperprior_codec.run(["decompress", nicx] + small + [
            "--ckpt", other["checkpoint_dir"], "--device", "cpu"])
    rd = eval_rd.run(["--dir", d, "--codec", "hyperprior", "--ckpt", ckpt,
                      "--output_root", out, "DEVICE=cpu"] + small)
    assert rd["codec"] == "hyperprior"
    assert [r["bpp"] for r in rd["images"]] == [r["bpp"]
                                                for r in res["images"]]
    with open(os.path.join(out, "eval_rd_hyperprior_imgs.json")) as fh:
        assert json.load(fh)["mean_bpp_bitstream"] == rd["mean_bpp_bitstream"]


@pytest.mark.parametrize("cli", ["hyperprior_comp", "hyperprior_codec",
                                 "eval_rd"])
def test_hyperprior_clis_without_card_raise(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib

    mod = importlib.import_module(f"nic_torch.cli.{cli}")
    argv = {"hyperprior_comp": ["--output_root", str(tmp_path)],
            "hyperprior_codec": ["compress", "x.png", "--ckpt", "c"],
            "eval_rd": ["--codec", "hyperprior", "--ckpt", "c",
                        "--output_root", str(tmp_path)]}[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(argv)


@pytest.mark.cuda
def test_hs_bins_kernel_matches_plain_on_card(jax_model):
    """On a card: K13's σ and bins equal its plain version's on the CPU
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, _, flat = jax_model
    pm = _port_model(flat)
    z = torch.round(torch.randn(2, N, 8, 12,
                                generator=torch.Generator().manual_seed(2)) * 3)
    s_cpu, b_cpu = k13.hs_bins_plain(z, k13.hs_weights(pm.h_s))
    s_gpu, b_gpu = k13.hs_bins_kernel(z.cuda(),
                                      k13.hs_weights(pm.cuda().h_s))
    assert torch.equal(s_gpu.cpu().view(torch.int32), s_cpu.view(torch.int32))
    assert torch.equal(b_gpu.cpu(), b_cpu)
