"""nic_torch's pixel-decode trainer against nic's, on the CPU (32², latent
8, MLP hidden 16, 64 pixels a step): both JAX parameter trees, the
lattice encoder, ``pixel_patch_features``, the folded decode with and
without the PE, a noise step and a quantize step from JAX's own jitted
step with its key's draws fed to the port, codes, checkpoints both ways,
the pixel CLIs end to end with ``--device cpu``, and the committed 512²
fixture decoded by the port against JAX."""

import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nic.core import quant as jquant
from nic.io import artifacts as jart
from nic.models import autoencoder as jae
from nic.train.pixel import PixelTrainer as JaxPixel
from nic.train.pixel import pixel_patch_features as jax_patch_features
from nic_torch.data import assets as tassets
from nic_torch.train.pixel import PixelTrainer, pixel_patch_features

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, C, H, NB, PE, BITS = 32, 8, 16, 64, 4, 8
LOSS_REL, GRAD_REL, PARAM_ABS = 1e-5, 1e-4, 1e-6


def _flat(tree) -> dict:
    return {"/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                     for q in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _image(size=S) -> np.ndarray:
    return tassets.load_image_mips(os.path.join(ROOT, "data",
                                                "sancho_512.png"),
                                   size, 0)[0].transpose(1, 2, 0)


def _encoder(impl: str):
    return (jae.MatmulPixelEncoder(C, 16) if impl == "matmul"
            else jae.PixelLatentEncoder(C, 16))


def _jax_params(impl: str, use_pe: bool, seed: int = 1) -> dict:
    """A JAX params tree of the trainer's shapes (flax's init traced, not
    run) from numpy: conv kernels N(0, 1/fan_in), biases N(0, 0.05²), MLP
    weights U(±1/√fan_in)."""
    ep = jax.eval_shape(_encoder(impl).init, jax.random.PRNGKey(0),
                        jnp.zeros((1, S, S, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        sd = (0.05 if str(path[-1].key) == "bias"
              else 1 / np.sqrt(np.prod(leaf.shape[:-1])))
        return rng.normal(0, sd, leaf.shape).astype(np.float32)

    f = 4 * C + (2 * PE if use_pe else 0)
    mlp = {}
    for i, (fi, fo) in enumerate(((f, H), (H, H), (H, 3)), 1):
        b = 1 / np.sqrt(fi)
        mlp[f"w{i}"] = rng.uniform(-b, b, (fi, fo)).astype(np.float32)
        mlp[f"b{i}"] = rng.uniform(-b, b, (fo,)).astype(np.float32)
    return {"enc": jax.tree_util.tree_map_with_path(fill, ep), "mlp": mlp}


def _port(use_pe: bool, **kw) -> PixelTrainer:
    return PixelTrainer(_image(), num_bits=BITS, latent_channels=C, hidden=H,
                        num_epochs=20, batch_pixels=NB, use_pe=use_pe,
                        pe_channels=PE, device="cpu", **kw)


def _pair(impl: str = "matmul", use_pe: bool = False):
    params = _jax_params(impl, use_pe)
    pt = _port(use_pe)
    pt.load_state_arrays(jart._flatten_tree(params, "params"))
    return params, pt


def _jax_self(use_pe: bool, impl: str = "matmul"):
    """A stand-in ``self`` for the JAX trainer's own step and decode
    builders (``PixelTrainer._build_step``, ``_decode_impl``): the fields
    they read."""
    ns = types.SimpleNamespace(
        encoder=_encoder(impl), num_bits=BITS, image_size=S,
        batch_pixels=NB, _tx=optax.adam(1e-3), qat_ste=False,
        use_pe=use_pe, pe_channels=PE, dtype=jnp.float32)
    ns._pe_of = functools.partial(JaxPixel._pe_of, ns)
    return ns


@functools.lru_cache(maxsize=None)
def _jax_steps(use_pe: bool):
    ns = _jax_self(use_pe)
    return {p: JaxPixel._build_step(ns, p, jit=True)
            for p in ("noise", "quantize")}


@functools.lru_cache(maxsize=None)
def _jax_grads(use_pe: bool, phase: str):
    """value_and_grad of the JAX step's loss with its draws given (the
    ``_build_step`` loss_fn, the key split out)."""
    ns = _jax_self(use_pe)

    def loss_fn(params, image, xs, ys, noise):
        latent = ns.encoder.apply(params["enc"], image)[0]
        ex, ey = xs // 4, ys // 4
        cells = [latent[ex + dx, ey + dy] for dx in (0, 1) for dy in (0, 1)]
        feat = jnp.stack(cells, axis=1).transpose(0, 2, 1).reshape(NB, -1)
        feat = feat + noise if phase == "noise" else jquant.quantize(
            feat, BITS)
        if use_pe:
            feat = jnp.concatenate([feat, ns._pe_of(xs, ys)], axis=1)
        from nic.models.mlp import apply_mlp

        out = apply_mlp(params["mlp"], feat)
        return jnp.mean((out - image[0, xs, ys]) ** 2)

    return jax.jit(jax.value_and_grad(loss_fn))


@pytest.mark.parametrize("impl", ["matmul", "xla"])
def test_layouts_round_trip(impl):
    params, pt = _pair(impl)
    want = _flat(params)
    got = pt.params_to_jax(impl)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    own = _port(False, seed=3).params_to_jax(impl)
    assert {k: v.shape for k, v in own.items()} == {
        k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("impl", ["matmul", "xla"])
def test_encoder_matches_jax(impl):
    """The (S/4 + 1)² lattice (pad 2 first): 9² at 32², rtol 1e-5; 129² at
    512² in both packages."""
    params, pt = _pair(impl)
    enc = _encoder(impl)
    want = np.asarray(jax.jit(enc.apply)(params["enc"], _image()[None]))
    with torch.no_grad():
        got = pt.encoder(pt.image)
    assert want.shape == (1, 9, 9, C)
    np.testing.assert_allclose(got.movedim(1, -1).numpy(), want, rtol=1e-5,
                               atol=1e-7)
    big = jax.eval_shape(enc.apply, params["enc"],
                         jnp.zeros((1, 512, 512, 3))).shape
    with torch.no_grad():
        port_big = pt.encoder(torch.zeros(1, 3, 512, 512)).shape
    assert big == (1, 129, 129, C) and tuple(port_big) == (1, C, 129, 129)


def test_patch_features_match_jax():
    lat = np.random.default_rng(2).uniform(0, 1, (9, 9, C)).astype(
        np.float32)
    want = np.asarray(jax_patch_features(jnp.asarray(lat), S))
    got = pixel_patch_features(torch.from_numpy(lat), S)
    assert got.shape == (S, S, 4 * C)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("use_pe", [False, True])
def test_folded_decode_matches_jax(use_pe):
    """The folded decode against JAX's ``_decode_impl`` (rtol 1e-5), and
    against the port's own per-pixel MLP on the patch features."""
    params, pt = _pair(use_pe=use_pe)
    lat = np.random.default_rng(3).integers(0, 256, (9, 9, C)).astype(
        np.float32) / 255.0
    ns = _jax_self(use_pe)
    want = np.asarray(jax.jit(functools.partial(JaxPixel._decode_impl, ns))(
        params["mlp"], jnp.asarray(lat)))
    with torch.no_grad():
        got = pt.decode_latent(torch.from_numpy(lat))
        feat = pixel_patch_features(torch.from_numpy(lat), S).reshape(S * S,
                                                                      -1)
        if use_pe:
            ys, xs = np.meshgrid(np.arange(S), np.arange(S))
            feat = torch.cat([feat, pt._pe_of(
                torch.from_numpy(xs.reshape(-1)),
                torch.from_numpy(ys.reshape(-1)))], dim=1)
        per_pixel = pt.mlp(feat).reshape(S, S, 3)
    assert got.shape == (S, S, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.numpy(), per_pixel.numpy(), rtol=1e-5,
                               atol=1e-6)
    codes = (lat * 255.0).round().astype(np.uint8)
    np.testing.assert_array_equal(pt.decode(codes), got.numpy())


@pytest.mark.parametrize("use_pe", [False, True])
def test_steps_match_jax(use_pe):
    """A noise step then a quantize step: the JAX trainer's own jitted step
    (its key's pixel draws and noise) against the port's step core fed
    those draws; loss, every leaf's grad, every param after Adam; in the
    quantize step the encoder's grads are zeros and Adam still moves it."""
    params, pt = _pair(use_pe=use_pe)
    image = jnp.asarray(_image()[None])
    opt = optax.adam(1e-3).init(params)
    key = jax.random.PRNGKey(11)
    for phase in ("noise", "quantize"):
        key, sub = jax.random.split(key)
        k_xy, k_noise = jax.random.split(sub)
        xy = jax.random.randint(k_xy, (2, NB), 0, S)
        noise = jquant.qat_noise(k_noise, (NB, 4 * C), BITS)
        loss, grads = _jax_grads(use_pe, phase)(params, image, xy[0], xy[1],
                                                noise)
        params, opt, jloss = _jax_steps(use_pe)[phase](
            jax.tree.map(jnp.array, params), opt, image, sub)
        assert float(jloss) == pytest.approx(float(loss), rel=1e-6)
        before = pt.params_to_jax()
        xs, ys = (torch.from_numpy(np.asarray(v, np.int64)) for v in xy)
        got = pt.step_core(phase, xs, ys,
                           torch.from_numpy(np.array(noise))
                           if phase == "noise" else None)
        assert abs(float(got) - float(loss)) <= LOSS_REL * abs(float(loss))
        tgrads = pt.grads_to_jax()
        for k, g in _flat(grads).items():
            scale = max(float(np.abs(g).max()), 1e-30)
            assert float(np.abs(tgrads[k] - g).max()) / scale <= GRAD_REL, k
        after = pt.params_to_jax()
        for k, v in _flat(params).items():
            np.testing.assert_allclose(after[k], v, atol=PARAM_ABS, rtol=0,
                                       err_msg=f"{phase} {k}")
    for k, (p, _, _) in pt.leaves().items():
        if k.startswith("enc/"):
            assert p.grad is not None and not p.grad.any(), k
            assert np.abs(after[k] - before[k]).max() > 0, k


def test_codes_and_draws():
    """Encode: [9, 9, C] uint8, JAX's codes of the same params wherever the
    latent is not at a rounding edge; two trainers from one seed draw the
    same pixels and noise and give the same losses."""
    params, pt = _pair()
    z = np.asarray(jax.jit(_encoder("matmul").apply)(
        params["enc"], _image()[None]))[0]
    want = np.asarray(jquant.quantize(z, BITS) * 255.0).astype(np.uint8)
    got = pt.encode()
    assert got.shape == (9, 9, C) and got.dtype == np.uint8
    far = np.abs(z * 255.0 - np.floor(z * 255.0) - 0.5) > 1e-4
    np.testing.assert_array_equal(got[far], want[far])
    runs = [_port(False, seed=4).train_many(6) for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])


def test_checkpoints_interchange(tmp_path):
    params, pt = _pair(use_pe=True)
    opt = optax.adam(1e-3).init(params)
    path = str(tmp_path / "jax.ckpt.npz")
    jart.save_checkpoint(path, 0, params, opt)
    pt.load_checkpoint(path)
    pt.train_step()
    pt.save_checkpoint(path)
    step, jp, jo = jart.load_checkpoint(path, params, opt)
    assert step == 1 and int(jo[0].count) == 1
    got = pt.state_arrays()
    want = {**jart._flatten_tree(jp, "params"),
            **jart._flatten_tree(jo, "opt")}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    back = _port(True)
    assert back.load_checkpoint(path) == 1
    for k, v in back.state_arrays().items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)


@pytest.mark.parametrize("cli", ["pixel_comp", "pixel_pos_comp"])
def test_pixel_cli_end_to_end_on_cpu(tmp_path, cli):
    from nic_torch.cli.__main__ import main

    main([cli, "--device", "cpu", "--image_size", "32", "--num_epochs", "10",
          "--hidden", "16", "--batch_pixels", "32", "--interval_print", "5",
          "--output_root", str(tmp_path)])
    (latent,) = os.listdir(tmp_path / "comp")
    codes = np.load(tmp_path / "comp" / latent)
    assert codes.shape == (9, 9, 8) and codes.dtype == np.uint8
    (png,) = os.listdir(tmp_path / "image")
    assert png.endswith(".png")
    ckpts = os.listdir(tmp_path / "model")
    with np.load(tmp_path / "model" / ckpts[0]) as z:
        want = 40 if cli == "pixel_pos_comp" else 32
        assert z["params/mlp/w1"].shape == (want, 16)


def test_fixture_decodes_as_in_jax():
    """The 512² fixture's JAX latent through its JAX weights: the port's
    folded decode on the CPU within 1e-5 of JAX's ``_decode_impl``, its
    PSNR within 0.05 dB of the one the JAX CLI logged."""
    from nic_torch.cli.common import report_image
    from nic_torch.io.bitstream import nest

    with np.load(os.path.join(ROOT, "tests", "fixtures",
                              "convae_pixel_comp.npz")) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    image = _image(512)
    pt = PixelTrainer(image, num_bits=8, hidden=64, device="cpu")
    pt.load_state_arrays(arrays)
    mlp = nest({k[len("params/mlp/"):]: jnp.asarray(v)
                for k, v in arrays.items() if k.startswith("params/mlp/")})
    ns = types.SimpleNamespace(image_size=512, use_pe=False, pe_channels=4,
                               dtype=jnp.float32)
    latent = arrays["latent"]
    want = np.asarray(jax.jit(functools.partial(JaxPixel._decode_impl, ns))(
        mlp, jnp.asarray(latent, jnp.float32) / 255.0))
    got = pt.decode(latent)
    assert got.shape == (512, 512, 3)
    assert float(np.abs(got - want).max()) <= 1e-5
    assert abs(report_image(lambda *_: None, image, want, None)
               - meta["psnr"]) <= 1e-4
    assert abs(report_image(lambda *_: None, image, got, None)
               - meta["psnr"]) <= 0.05
