"""nic_torch's conv-AE family against nic's, on the CPU: the quantizer's
straight-through form, both JAX parameter trees, every encoder and
decoder forward, codes and latent bytes, one noise step and one quantize
step fed JAX's noise (2D at 32², 3D at 8×16×16, the movie-label trainer
on 4 frames of 16²), checkpoints both ways with resume, the CLIs end to
end with ``--device cpu``, their refusals, the dispatcher, and the
committed fixtures decoded by the port against JAX."""

import functools
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)

from nic.core import quant as jquant
from nic.io import artifacts as jart
from nic.models import autoencoder as jae
from nic_torch.core import quant as tquant
from nic_torch.data import assets as tassets
from nic_torch.io import artifacts as tart
from nic_torch.train.conv_ae import ConvAETrainer
from nic_torch.train.movie_label import MovieLabelTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CPU tests' limits for one step against JAX
LOSS_REL, GRAD_REL, PARAM_ABS = 1e-5, 1e-4, 1e-6
CLIS = ["image_comp", "movie_lavel_comp", "movie_frame_comp",
        "movie_2d_comp", "movie_3d_comp", "pixel_comp", "pixel_pos_comp"]


def _flat(tree) -> dict:
    return {"/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                     for q in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _image(size=32) -> np.ndarray:
    rng = np.random.default_rng(0)
    img = tassets.load_image_mips(os.path.join(ROOT, "data", "sancho_512.png"),
                                  size, 0)[0].transpose(1, 2, 0)
    return np.clip(img + rng.normal(0, 0.01, img.shape), 0, 1).astype(
        np.float32)


def _clip(t=8, s=16) -> np.ndarray:
    movie = tassets.read_clip(os.path.join(ROOT, "data", "misty_64_64.avi"))
    return (movie[:t, ::64 // s, ::64 // s] / 255.0).astype(np.float32)


def _nc(a) -> torch.Tensor:
    """A JAX channels-last array → a channels-first tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a, np.float32), -1, 1)))


# kind → (JAX trainer's encoder and decoder per conv_impl, the asset in
# JAX's batched layout, the port trainer); the JAX trainers' modules and
# widths (image_comp 4-bit 8/16, movie_3d 8-bit 16/32, movie_label 8-bit
# 8/16 on flax's convs whatever conv_impl)
def _modules(kind: str, impl: str):
    if kind == "label":
        return jae.ConvEncoder2D(8, 16), jae.ConvDecoder2D(16, 3)
    lat, hid = (8, 16) if kind == "2d" else (16, 32)
    nd = kind[0]
    if impl == "matmul":
        return (getattr(jae, f"MatmulEncoder{nd}D")(lat, hid),
                getattr(jae, f"MatmulDecoder{nd}D")(hid, 3))
    return (getattr(jae, f"ConvEncoder{nd}D")(lat, hid),
            getattr(jae, f"ConvDecoder{nd}D")(hid, 3))


def _asset(kind: str) -> np.ndarray:
    return {"2d": lambda: _image()[None], "3d": lambda: _clip()[None],
            "label": lambda: _clip(4)}[kind]()


def _port(kind: str, **kw):
    if kind == "2d":
        return ConvAETrainer(_image(), num_bits=4, num_epochs=20,
                             device="cpu", **kw)
    if kind == "3d":
        return ConvAETrainer(_clip(), num_bits=8, latent_channels=16,
                             hidden_channels=32, num_epochs=20, device="cpu",
                             **kw)
    return MovieLabelTrainer(_clip(4), num_bits=8, num_epochs=20,
                             device="cpu", **kw)


def _bits(kind: str) -> int:
    return 4 if kind == "2d" else 8


def _jax_params(kind: str, impl: str, seed: int = 1) -> dict:
    """A JAX params tree of the trainer's shapes (flax's init traced, not
    run) filled from numpy: kernels N(0, 1/fan_in), biases N(0, 0.05²),
    the movie-label embedding N(0, 0.1²)."""
    enc, dec = _modules(kind, impl)
    x = _asset(kind)
    key = jax.random.PRNGKey(0)
    ep = jax.eval_shape(enc.init, key, x)
    z = jax.eval_shape(enc.apply, ep, x).shape
    zin = z[:-1] + (z[-1] + (kind == "label"),)
    dp = jax.eval_shape(dec.init, key, jnp.zeros(zin))
    tree = {"enc": ep, "dec": dp}
    if kind == "label":
        tree["emb"] = jax.ShapeDtypeStruct(z[:-1] + (1,), jnp.float32)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        sd = (0.05 if name == "bias" else 0.1 if name == "emb"
              else 1 / np.sqrt(np.prod(leaf.shape[:-1])))
        return rng.normal(0, sd, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _pair(kind: str, impl: str = "matmul"):
    """(JAX params, port trainer holding them)."""
    params = _jax_params(kind, impl)
    pt = _port(kind)
    pt.load_state_arrays(jart._flatten_tree(params, "params"))
    return params, pt


@functools.lru_cache(maxsize=None)
def _jax_fns(kind: str, impl: str = "matmul"):
    """JAX's jitted (encode latent, decode, two steps) for ``kind``: the
    JAX trainers' formulas (``nic.train.conv_ae`` / ``movie_label``
    ``_build_step``, ``encode``, ``decode``) on their modules, with the
    noise given instead of drawn; the steps are a noise step then a
    quantize step through ``optax.adam(1e-3)``."""
    enc, dec = _modules(kind, impl)
    x = jnp.asarray(_asset(kind))
    tx = optax.adam(1e-3)
    bits = _bits(kind)

    def dec_in(params, z):
        if kind == "label":
            z = jnp.concatenate([z, params["emb"]], axis=-1)
        return dec.apply(params["dec"], z)

    def loss_fn(params, noise, phase):
        z = enc.apply(params["enc"], x)
        z = z + noise if phase == "noise" else jquant.quantize(z, bits)
        return jnp.mean((dec_in(params, z) - x) ** 2)

    @jax.jit
    def steps(params, noise):
        opt = tx.init(params)
        out = []
        for phase in ("noise", "quantize"):
            loss, grads = jax.value_and_grad(loss_fn)(params, noise, phase)
            upd, opt = tx.update(grads, opt, params)
            params = optax.apply_updates(params, upd)
            out.append((loss, grads, params))
        return out, opt

    latent = jax.jit(lambda p: enc.apply(p["enc"], x))
    decode = jax.jit(dec_in)
    return latent, decode, steps


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_init_matches_flax_lecun_normal(kind):
    """The port's initial kernels (``init_convs_``) against flax's
    ``lecun_normal`` from the JAX trainer's modules, per layer over seeds
    0-5: the pooled std within 6% of flax's and of 1/√fan-in (fan-in
    kⁿ·Cin, the JAX kernel matrix's rows), and both truncated at 2σ. A
    fan-in taken from Cout or kⁿ alone misses by 29% or more."""
    enc, dec = _modules(kind, "matmul")
    x = jnp.asarray(_asset(kind))
    z = jax.eval_shape(enc.apply, jax.eval_shape(enc.init,
                                                 jax.random.PRNGKey(0), x), x)

    @jax.jit
    def init(key):  # the JAX trainer's split (nic.train.conv_ae)
        k1, k2, _ = jax.random.split(key, 3)
        return {"enc": enc.init(k1, x), "dec": dec.init(k2, jnp.zeros(
            z.shape))}

    seeds = range(6)
    jax_w = [_flat(init(jax.random.PRNGKey(s))) for s in seeds]
    port_w = [_port(kind, seed=s).params_to_jax() for s in seeds]
    kernels = [k for k in jax_w[0] if k.endswith("kernel")]
    assert len(kernels) == 4
    for k in kernels:
        key = k.replace("params/", "", 0)
        fan_in = int(np.prod(jax_w[0][k].shape[:-1]))
        got = np.stack([w[key] for w in port_w]).ravel() * np.sqrt(fan_in)
        want = np.stack([w[k] for w in jax_w]).ravel() * np.sqrt(fan_in)
        assert got.size == want.size
        for a in (got, want):
            assert abs(a.std() - 1.0) <= 0.06, (k, a.std())
            assert np.abs(a).max() <= 2.0 / 0.87962566103423978 * (1 + 1e-6)
        print(f"{kind} {k}: fan-in {fan_in}, std·√fan-in port "
              f"{got.std():.4f}, flax {want.std():.4f}")
        assert abs(got.std() / want.std() - 1.0) <= 0.06, k


def test_quantize_ste_matches_jax():
    x = np.random.default_rng(2).uniform(0, 1, 4096).astype(np.float32)
    jg = jax.grad(
        lambda v: jnp.sum(jquant.quantize_ste(v, 4) * jnp.arange(4096.0)))(
            jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    (tquant.quantize_ste(t, 4) * torch.arange(4096.0)).sum().backward()
    np.testing.assert_array_equal(tquant.quantize_ste(torch.from_numpy(x), 4),
                                  np.asarray(jquant.quantize_ste(x, 4)))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    # the hard quantizer passes a zero gradient, as JAX's floor
    q = torch.from_numpy(x).requires_grad_(True)
    tquant.quantize(q, 4).sum().backward()
    assert torch.equal(q.grad, torch.zeros_like(q))


KINDS = [("2d", "matmul"), ("2d", "xla"), ("3d", "matmul"), ("3d", "xla"),
         ("label", "xla")]


@pytest.mark.parametrize("kind,impl", KINDS)
def test_layouts_round_trip(kind, impl):
    """JAX params → port → JAX in the same tree, key for key and bit for
    bit; the port's own init writes the same keys and shapes as flax's."""
    params, pt = _pair(kind, impl)
    want = _flat(params)
    got = pt.params_to_jax(impl)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    own = _port(kind, seed=3).params_to_jax(impl)
    assert {k: v.shape for k, v in own.items()} == {
        k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("kind,impl", KINDS)
def test_forward_matches_jax(kind, impl):
    """Encoder and decoder forwards on the same inputs (rtol 1e-5); for the
    movie-label model the decoder takes the embedding plane too."""
    params, pt = _pair(kind, impl)
    latent, decode, _ = _jax_fns(kind, impl)
    z = np.asarray(latent(params))
    zq = np.random.default_rng(3).uniform(0, 1, z.shape).astype(np.float32)
    out = np.asarray(decode(params, zq))
    with torch.no_grad():
        pz = pt.encoder(pt.movie if kind == "label" else pt.image)
    np.testing.assert_allclose(pz.movedim(1, -1).numpy(), z, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(pt._decode(torch.from_numpy(zq)).numpy(), out,
                               rtol=1e-5, atol=1e-7)


def test_codes_bit_for_bit(tmp_path):
    """Codes from the same latent equal JAX's (truncate(q·(2^b − 1)) in
    fp32), at every rounding boundary and its neighbours; the trained
    path's encode and decode; the saved latent's bytes."""
    params, pt = _pair("2d")
    for bits in (4, 8):
        s = 2.0**bits - 1.0
        edges = ((np.arange(2**bits) + 0.5) / s).astype(np.float32)
        z = np.concatenate([
            edges, np.nextafter(edges, 0), np.nextafter(edges, 1),
            np.arange(2**bits, dtype=np.float32) / s,
            np.random.default_rng(4).uniform(0, 1, 20000).astype(np.float32)])
        z = np.clip(z, 0, 1)
        want = np.asarray(jax.jit(lambda v: jquant.quantize(v, bits))(z)
                          * (2.0**bits - 1.0)).astype(np.uint8)
        pt.num_bits = bits
        np.testing.assert_array_equal(pt._codes(torch.from_numpy(z)), want)
    pt.num_bits = 4
    latent, decode, _ = _jax_fns("2d")
    z = np.asarray(latent(params))
    codes = np.asarray(jax.jit(lambda v: jquant.quantize(v, 4))(z)
                       * 15.0).astype(np.uint8)  # JAX's encode
    got = pt.encode()
    assert got.shape == codes.shape == (1, 8, 8, 8) and got.dtype == np.uint8
    far = np.abs(z * 15.0 - np.floor(z * 15.0) - 0.5) > 1e-4
    np.testing.assert_array_equal(got[far], codes[far])
    want = np.asarray(decode(params, jnp.asarray(codes, jnp.float32) / 15.0))
    np.testing.assert_allclose(pt.decode(codes), want[0], rtol=1e-5,
                               atol=1e-7)
    jart.save_latent(str(tmp_path / "j.npy"), codes, 4)
    tart.save_latent(str(tmp_path / "t.npy"), codes, 4)
    assert (tmp_path / "j.npy").read_bytes() == (tmp_path / "t.npy").read_bytes()
    np.testing.assert_array_equal(
        tart.load_latent(str(tmp_path / "t.npy"), 4).numpy(),
        np.asarray(jart.load_latent(str(tmp_path / "j.npy"), 4)))


def _steps_against_jax(kind: str, params: dict, pt, seed: int) -> None:
    """A noise step then a quantize step from ``params`` with JAX's noise:
    loss, every leaf's grad and every param after Adam, each against
    JAX's; in the quantize step the encoder's grads are zeros (not None)
    and Adam still moves it on its momentum."""
    latent, _, steps = _jax_fns(kind)
    zshape = latent(params).shape
    noise = jquant.qat_noise(jax.random.PRNGKey(seed), zshape, _bits(kind))
    jout, _ = steps(params, noise)
    for phase, (loss, grads, new) in zip(("noise", "quantize"), jout):
        before = pt.params_to_jax()
        got = pt.step_core(phase, _nc(noise) if phase == "noise" else None)
        assert abs(float(got) - float(loss)) <= LOSS_REL * abs(float(loss))
        tgrads = pt.grads_to_jax()
        for k, g in _flat(grads).items():
            scale = max(float(np.abs(g).max()), 1e-30)
            assert float(np.abs(tgrads[k] - g).max()) / scale <= GRAD_REL, k
        after = pt.params_to_jax()
        for k, v in _flat(new).items():
            np.testing.assert_allclose(after[k], v, atol=PARAM_ABS, rtol=0,
                                       err_msg=f"{phase} {k}")
    for k, (p, _, _) in pt.leaves().items():
        if k.startswith("enc/"):
            assert p.grad is not None and not p.grad.any(), k
            assert np.abs(after[k] - before[k]).max() > 0, k


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_steps_match_jax(kind):
    _steps_against_jax(kind, *_pair(kind), seed=5)


def test_movie_label_steps_and_decode():
    params, pt = _pair("label")
    _steps_against_jax("label", params, pt, seed=7)
    _, decode, _ = _jax_fns("label")
    codes = np.random.default_rng(8).integers(0, 256, (4, 4, 4, 8)).astype(
        np.uint8)
    new = pt.params_to_jax()
    want = decode(_nest(new), jnp.asarray(codes, jnp.float32) / 255.0)
    np.testing.assert_allclose(pt.decode(codes), np.asarray(want),
                               rtol=1e-5, atol=1e-7)
    assert pt.encode().shape == (4, 4, 4, 8)


@pytest.mark.parametrize("epochs", [20, 21])
def test_phase_boundary(epochs):
    """train_step's step < 0.95·epochs (JAX's ``train_step``) and
    train_many's ⌈0.95·epochs⌉ (JAX's ``train_many``) give the same phases:
    19 noise steps of 20, 20 of 21."""
    pt = ConvAETrainer(_image(16), num_epochs=epochs, device="cpu")
    seen = []

    def record(phase, *draws):
        seen.append(phase)
        pt.step += 1
        return torch.zeros(())

    pt.step_core = record
    pt.train_many(epochs, chunk=7)
    assert seen.count("noise") == {20: 19, 21: 20}[epochs]
    assert seen == ["noise" if i < epochs * 0.95 else "quantize"
                    for i in range(epochs)]
    pt.step = 0
    for i in range(epochs):
        assert pt.phase() == seen[i]
        pt.step += 1


def test_checkpoints_interchange_and_resume(tmp_path):
    """A JAX checkpoint (params and Adam after a step) restores in the port
    and the port's in JAX's load_checkpoint, key for key; the port resumes
    from it and steps as JAX does from the same state."""
    params, _ = _pair("2d")
    latent, _, steps = _jax_fns("2d")
    noise = jquant.qat_noise(jax.random.PRNGKey(9), latent(params).shape, 4)
    (_, (_, _, p2)), opt = steps(params, noise)
    jpath = str(tmp_path / "jax.ckpt.npz")
    jart.save_checkpoint(jpath, 2, p2, opt)
    pt = _port("2d")
    assert pt.load_checkpoint(jpath) == 2
    want = {**jart._flatten_tree(p2, "params"),
            **jart._flatten_tree(opt, "opt")}
    got = pt.state_arrays()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    tpath = str(tmp_path / "port.ckpt.npz")
    pt.save_checkpoint(tpath)
    step, jp, jo = jart.load_checkpoint(tpath, p2, opt)
    assert step == 2
    for k, v in {**jart._flatten_tree(jp, "params"),
                 **jart._flatten_tree(jo, "opt")}.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    # one more noise step from the restored state, against optax's
    tx = optax.adam(1e-3)
    decode = _jax_fns("2d")[1]

    @jax.jit
    def step(p, o):
        grads = jax.grad(lambda q: jnp.mean(
            (decode(q, latent(q) + noise) - _asset("2d")) ** 2))(p)
        return optax.apply_updates(p, tx.update(grads, o, p)[0])

    new = _flat(step(jp, jo))
    pt.step_core("noise", _nc(noise))
    for k, v in pt.params_to_jax().items():
        np.testing.assert_allclose(v, new[k], atol=PARAM_ABS, rtol=0,
                                   err_msg=k)
    with pytest.raises(ValueError, match="mismatch"):
        _port("2d", latent_channels=4).load_checkpoint(jpath)


def test_movie_label_checkpoint_interchanges(tmp_path):
    params, pt = _pair("label")
    opt = optax.adam(1e-3).init(params)
    path = str(tmp_path / "label.ckpt.npz")
    jart.save_checkpoint(path, 0, params, opt)
    pt.load_checkpoint(path)
    pt.step_core("noise", torch.zeros(pt.latent_shape()))
    pt.save_checkpoint(path)
    step, jp, jo = jart.load_checkpoint(path, params, opt)
    assert step == 1 and int(jo[0].count) == 1
    got = pt.state_arrays()
    for k, v in {**jart._flatten_tree(jp, "params"),
                 **jart._flatten_tree(jo, "opt")}.items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)


# ---- the CLIs ----------------------------------------------------------

@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """A 16-frame 16² clip (a 64² sheet) and an 8-frame one for 3D."""
    d = tmp_path_factory.mktemp("clips")
    paths = {}
    for name, t in (("sheet", 16), ("vol", 8)):
        paths[name] = str(d / f"misty_{name}.avi")
        tassets.write_timelaps((_clip(t) * 255).round().astype(np.uint8),
                               paths[name])
    return paths


def _only(directory, suffix) -> str:
    (f,) = [os.path.join(directory, f) for f in os.listdir(directory)
            if f.endswith(suffix)]
    return f


@pytest.mark.parametrize("cli,extra,latent_shape,out_ext", [
    ("image_comp", ["--image_size", "32"], (1, 8, 8, 8), ".png"),
    ("movie_lavel_comp", ["--image_size", "32"], (1, 8, 8, 8), ".png"),
    ("movie_lavel_comp", ["--label_embedding", "true", "CLIP:sheet"],
     (16, 4, 4, 8), ".avi"),
    ("movie_frame_comp", ["CLIP:sheet"], (1, 16, 16, 16), ".avi"),
    ("movie_2d_comp", ["CLIP:sheet"], (1, 16, 16, 16), ".avi"),
    ("movie_3d_comp", ["CLIP:vol"], (1, 2, 4, 4, 16), ".avi"),
])
def test_cli_end_to_end_on_cpu(tmp_path, clips, cli, extra, latent_shape,
                               out_ext):
    """Each CLI as ``python -m nic_torch.cli <name>`` would run it, 10
    epochs with ``--device cpu``: the latent (uint8, its shape), the
    reconstruction file, the scalars and a checkpoint JAX's loader
    reads."""
    from nic_torch.cli.__main__ import main

    argv = []
    for a in extra:
        argv += ["--image_path", clips[a[5:]]] if a.startswith("CLIP:") else [a]
    main([cli, "--device", "cpu", "--num_epochs", "10", "--interval_print",
          "5", "--output_root", str(tmp_path)] + argv)
    latent = np.load(_only(tmp_path / "comp", ".npy"))
    assert latent.shape == latent_shape and latent.dtype == np.uint8
    assert os.path.getsize(_only(tmp_path / "image", out_ext)) > 0
    if "--label_embedding" in extra:
        return  # the label trainer's loop keeps no scalars or checkpoint
    assert os.path.getsize(_only(tmp_path / "log", "_scalars.csv")) > 0
    ckpt = _only(tmp_path / "model", ".ckpt.npz")
    with np.load(ckpt) as z:
        assert json.loads(bytes(z["__meta__"]).decode())["step"] == 10
        assert any(k.startswith("params/enc/params/MatmulConv_0")
                   for k in z.files)


def test_cli_resumes_a_checkpoint(tmp_path):
    """--interval_checkpoint names the checkpoint by epoch, as JAX's;
    --resume_step picks it up and the run continues from its step."""
    from nic_torch.cli import image_comp

    base = ["--device", "cpu", "--image_size", "32", "--num_epochs", "6",
            "--output_root", str(tmp_path)]
    image_comp.run(base + ["--interval_checkpoint", "4"])
    assert os.path.exists(tmp_path / "model" /
                          "image_tpu_sancho_512.png_6_4_3.ckpt.npz")
    image_comp.run(base + ["--resume_step", "3"])
    logs = sorted(os.listdir(tmp_path / "printlog"))
    with open(tmp_path / "printlog" / logs[-1]) as f:
        assert "at step 4" in f.read()


def test_cli_flags_are_jax_flags_plus_device():
    from nic.cli import common as jcommon
    from nic_torch.cli import common as tcommon

    def flags(p):
        return {s for a in p._actions for s in a.option_strings}

    assert flags(tcommon.standard_parser("")) == flags(
        jcommon.standard_parser("")) | {"--device"}


@pytest.mark.parametrize("cli", CLIS)
def test_cli_defaults_to_the_card(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"nic_torch.cli.{cli}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(["--output_root", str(tmp_path)])


@pytest.mark.parametrize("cli", ["image_comp", "movie_3d_comp",
                                 "pixel_comp"])
def test_data_parallel_refuses(tmp_path, clips, cli):
    """``--data_parallel true`` no longer refuses (queue 1, item 13 is
    ported): without a launcher the conv-AE workloads train one rank and
    say so; the per-pixel workload, which has no mesh path in JAX either,
    trains on one device and says so."""
    mod = importlib.import_module(f"nic_torch.cli.{cli}")
    size = (["--image_path", clips["vol"]] if cli == "movie_3d_comp"
            else ["--image_size", "32"])
    mod.run(["--device", "cpu", "--data_parallel", "true", "--num_epochs",
             "2", "--output_root", str(tmp_path)] + size)
    (log,) = os.listdir(tmp_path / "printlog")
    with open(tmp_path / "printlog" / log) as f:
        text = f.read()
    assert ("no mesh path" if cli == "pixel_comp"
            else "no launcher: one rank") in text


def test_dispatcher_lists_the_jax_workloads():
    from nic.cli.__main__ import WORKLOADS as JAX_WORKLOADS
    from nic_torch.cli.__main__ import WORKLOADS

    assert list(WORKLOADS) == list(JAX_WORKLOADS)
    for name, module in WORKLOADS.items():
        assert module == f"nic_torch.cli.{name}"
        assert callable(importlib.import_module(module).run), name


def test_family_imports_no_jax_and_no_nic():
    """The family's modules import neither JAX nor the JAX package."""
    import subprocess
    import sys

    mods = ["nic_torch.cli.__main__", "nic_torch.train.spatiotemporal",
            "nic_torch.train.pixel", "nic_torch.train.movie_label",
            "nic_torch.models.autoencoder", "nic_torch.cli.common"] + [
                f"nic_torch.cli.{c}" for c in CLIS]
    code = (f"import sys\nfor m in {mods!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'nic'))\n"
            "print(','.join(bad)); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)


# ---- the committed fixtures ---------------------------------------------

def _fixture(workload):
    with np.load(os.path.join(ROOT, "tests", "fixtures",
                              f"convae_{workload}.npz")) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        return meta, {k: z[k] for k in z.files if k != "__meta__"}


def _nest(flat: dict) -> dict:
    """{"enc/params/…": array} → the JAX params tree."""
    from nic_torch.io.bitstream import nest

    return jax.tree.map(jnp.asarray, nest(flat))


@pytest.mark.parametrize("workload", ["image_comp", "movie_3d_comp"])
def test_fixture_decodes_as_in_jax(workload):
    """The fixture's JAX latent through its JAX weights (the JAX trainer's
    decode: dequantize, the im2col decoder): the port's decode on the CPU
    within 1e-5 of JAX's, and its PSNR within 0.05 dB of the one the JAX
    CLI logged."""
    from nic_torch.cli.common import report_image, report_video

    meta, arrays = _fixture(workload)
    if workload == "image_comp":
        asset = tassets.load_image_mips(os.path.join(ROOT, "data",
                                                     "sancho_512.png"),
                                        512, 0)[0].transpose(1, 2, 0)
        pt = ConvAETrainer(asset, num_bits=4, device="cpu")
        dec, report = jae.MatmulDecoder2D(16, 3), report_image
    else:
        asset = tassets.read_clip(os.path.join(
            ROOT, "data", "misty_64_64.avi")).astype(np.float32) / 255.0
        pt = ConvAETrainer(asset, num_bits=8, latent_channels=16,
                           hidden_channels=32, device="cpu")
        dec, report = jae.MatmulDecoder3D(32, 3), report_video
    pt.load_state_arrays(arrays)
    params = _nest({k[len("params/"):]: v for k, v in arrays.items()
                    if k.startswith("params/")})
    z = jnp.asarray(arrays["latent"], jnp.float32) / (
        2.0**meta["num_bits"] - 1.0)
    want = np.asarray(jax.jit(dec.apply)(params["dec"], z))[0]
    got = pt.decode(arrays["latent"])
    assert got.shape == asset.shape
    assert float(np.abs(got - want).max()) <= 1e-5
    assert abs(report(lambda *_: None, asset, want, None)
               - meta["psnr"]) <= 1e-4
    assert abs(report(lambda *_: None, asset, got, None)
               - meta["psnr"]) <= 0.05
