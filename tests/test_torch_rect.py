"""Rectangular 2D images (IMAGE_SIZE_W) in nic_torch against nic on the
CPU, at 64×96 and 96×64 (the Kodak geometry's shape class, from the
bundled sancho image resized):

- the trainer's set-up (per-axis grids, the mip map from the shorter
  axis, the engine each LOD's gates pick in mip mode) and its crop
  origins (per axis on [0, d − n]; a square image's draws unchanged);
- one step of each engine from identical params, with JAX's own draws at
  origins that reach the last row and the last column, replayed through
  the port's step core (loss and grads at ``TOL``);
- ``trainer.decode(mip)`` at every mip against the JAX trainer's;
- a coarsest G1 one node short of a long axis (64×80 here, 512×768 at
  mip 8): JAX reads NaN, the port a zero node, JAX's value on padded
  grids;
- the training CLI's artifact through both decode CLIs at every mip, the
  decode CLI's ``--backend xla`` on it, and ``eval_rd --native-geometry``.

The JAX kernels run in Pallas interpret mode, as the JAX suite runs them.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
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

BASE = dict(image_path="data/sancho_512.png", sdc_guard_train=False)
HW = {"64x96": (64, 96), "96x64": (96, 64)}
# (loss rel, grad rel), as tests/test_torch_ntc_train.py holds the square
# steps: fp32 summation order only; bf16 dot inputs flip a rounding
TOL = {32: (1e-5, 1e-4), 16: (1e-4, 1e-2)}


def _pair(hw, **kw):
    kw = {**BASE, "image_size": hw[0], "image_size_w": hw[1], **kw}
    jcfg = JConfig(**kw)
    tcfg = TConfig(device="cpu", **kw)
    jlines, tlines = [], []
    jtr = jntc.NTCTrainer(jcfg, j_load_asset(jcfg), log=jlines.append)
    ttr = tntc.NTCTrainer(tcfg, t_load_asset(tcfg), log=tlines.append)
    with torch.no_grad():
        for dst, src in zip(ttr.state.fp, jtr.state.fp):
            dst.copy_(torch.from_numpy(np.array(src)))
        for k in PARAM_NAMES:
            ttr.state.mlp[k].copy_(torch.from_numpy(np.array(
                jtr.state.mlp[k])))
    return jtr, ttr, jlines, tlines


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.mark.parametrize("hw", list(HW), ids=list(HW))
def test_setup_matches_jax(hw):
    """Grids, images, mip map and the engine per (LOD, forward) in mip
    mode, as JAX's."""
    h, w = HW[hw]
    for forward in ("kernel3", "kernel2", "kernel"):
        jtr, ttr, _, _ = _pair(HW[hw], tf_no_mip=False, max_mip_level=6,
                               crop_mip_level=4, train_forward=forward)
        shapes = [tuple(g.shape) for g in ttr.state.fp]
        assert shapes == [tuple(g.shape) for g in jtr.state.fp]
        want = [(12, h // 4 + 1, w // 4 + 1), (12, h // 8 + 1, w // 8 + 1)]
        assert shapes[:2] == want
        assert ttr.mip_to_level == jtr.mip_to_level
        assert ttr.levels == jtr.levels
        assert [tuple(im.shape) for im in ttr.images] == [
            (3, h >> i, w >> i) for i in range(7)]
        for lod in range(7):
            jtr._build_step(lod, False, jit=False)
            plan = ttr._plan(lod, False)
            assert plan.mode == jtr._forward_mode, (forward, lod)
        # the coarse LODs' steps are 2, so kernel3 runs at some LODs only
        if forward == "kernel3":
            assert {p.mode for p in ttr._plans.values()} == {"kernel3",
                                                            "kernel"}


def test_rect_is_2d_only_and_crops_must_fit():
    """A 3D rectangular configuration raises, as in JAX; so does a crop
    larger than an axis of the image (JAX's crop slice raises there)."""
    kw = dict(image_size=16, image_size_w=32, image_dimension=3,
              compression_method=3, image_path="data/misty_64_64.avi")
    with pytest.raises(ValueError, match="2D-only"):
        jntc.NTCTrainer(JConfig(**kw), [np.zeros((3, 16, 16, 16),
                                                 np.float32)])
    with pytest.raises(ValueError, match="2D-only"):
        tntc.NTCTrainer(TConfig(device="cpu", **kw),
                        [np.zeros((3, 16, 16, 16), np.float32)])
    kw = dict(BASE, image_size=64, image_size_w=32, crop_mip_level=6,
              num_epochs=4)
    jtr = jntc.NTCTrainer(JConfig(**kw), j_load_asset(JConfig(**kw)))
    with pytest.raises(TypeError):
        jtr.train_many(1, chunk=1)
    tcfg = TConfig(device="cpu", **kw)
    ttr = tntc.NTCTrainer(tcfg, t_load_asset(tcfg))
    with pytest.raises(ValueError, match="do not fit"):
        ttr.train_many(1)


def test_origins_per_axis_and_square_stream_unchanged():
    """Rectangular draws cover [0, d − n] on each axis, the last row and
    the last column included; a square image's draws are the one
    ``torch.randint(0, high, (crops, 2))`` call of the seed's stream."""
    _, ttr, _, _ = _pair((64, 96), crop_mip_level=4, num_epochs=100)
    got = torch.cat([ttr._draws(0, True)[0] for _ in range(60)])
    assert got.min() == 0
    assert got.max(dim=0).values.tolist() == [64 - 16, 96 - 16]

    cfg = TConfig(device="cpu", image_size=64, crop_mip_level=4, seed=3,
                  **BASE)
    tr = tntc.NTCTrainer(cfg, t_load_asset(cfg))
    gen = torch.Generator(device="cpu").manual_seed(cfg.seed + 2)
    for frozen in (True, True, False, True):
        origins, kw = tr._draws(0, frozen)
        want = torch.randint(0, 64 - 16 + 1, (cfg.num_crops, 2),
                             generator=gen)
        assert torch.equal(origins, want)
        if "seed" in kw:  # kernel3's seed words follow in the stream
            torch.randint(-2**31, 2**31, (2,), dtype=torch.int64,
                          generator=gen)


def _edge_key(jtr, n, data_hw):
    """The first of JAX's per-step keys (split from the trainer's key)
    whose crop draw (ntc.py:761-765) reaches the last row and the last
    column, with those origins."""
    cfg = jtr.cfg
    keys = jax.random.split(jtr._key, 4096)
    high = jnp.asarray([d - n + 1 for d in data_hw], jnp.int32)

    @jax.jit
    def draw(key):  # one key at a time: rbg keys do not vmap bit for bit
        k_crop, _ = jax.random.split(key)
        return jax.random.randint(k_crop, (cfg.num_crops, 2), 0, high)

    last = np.asarray(data_hw) - n
    for key in keys:
        org = np.array(draw(key))
        if (org == last).any(0).all():
            return key, org
    raise AssertionError("no key reaches the last row and column")


def _jax_noise(cfg, n, key, forward):
    _, k_noise = jax.random.split(key)
    if forward == "kernel3":
        return {"seed": torch.from_numpy(np.array(
            jntc._k3_seed(k_noise, jnp.int32(0))))}
    from nic.core.quant import qat_noise

    return {"eps": torch.from_numpy(np.array(qat_noise(
        k_noise, (cfg.num_crops * n * n, cfg.decoder_input_channels),
        cfg.fp_bits, jnp.float32)))}


@pytest.mark.parametrize("hw,forward,dtype", [
    ("64x96", "kernel3", 32), ("64x96", "kernel3", 16),
    ("64x96", "kernel2", 32), ("64x96", "kernel", 32),
    ("64x96", "gather", 32), ("96x64", "kernel3", 16)])
def test_one_step_matches_jax(hw, forward, dtype):
    jtr, ttr, _, tlines = _pair(HW[hw], train_forward=forward,
                                mlp_num_dtype=dtype, num_epochs=100,
                                crop_mip_level=4)
    _, n, _ = jtr._geometry(0)
    fn = jtr._build_step(0, False, jit=False)
    assert jtr._forward_mode == forward
    key, origins = _edge_key(jtr, n, HW[hw])
    s = jtr.state
    with pltpu.force_tpu_interpret_mode():
        fp, mlp, opt_fp, opt_mlp, jloss, _ = fn(s.fp, s.mlp, s.opt_fp,
                                                s.opt_mlp, key)
    loss, _ = ttr.step_core(0, torch.from_numpy(origins),
                            **_jax_noise(jtr.cfg, n, key, forward))
    assert ttr._forward_mode == forward
    assert f"frozen=False): {forward}" in tlines[0]

    tol_loss, tol_grad = TOL[dtype]
    assert abs(float(loss) - float(jloss)) / float(jloss) < tol_loss
    ts = ttr.state
    for params, jmu, opt in (
            ([ts.mlp[k] for k in PARAM_NAMES],
             [opt_mlp[0].mu[k] for k in PARAM_NAMES], ts.opt_mlp),
            (list(ts.fp), list(opt_fp[0].mu), ts.opt_fp)):
        for i, (p, mu) in enumerate(zip(params, jmu)):
            # Adam's first moment after one update: (1 − b1)·grad
            assert _rel(opt.state[p]["exp_avg"].numpy(), mu) < tol_grad, i
    # the active grids' last node column took gradient in both
    g0 = np.asarray(opt_fp[0].mu[0])
    assert np.abs(g0[:, :, -1]).max() > 0


@pytest.mark.parametrize("hw", list(HW), ids=list(HW))
def test_trainer_decodes_match_jax(hw):
    """Every mip, mip mode with max mip 6 (the last mip is 1×1, square),
    the default backend (the fold, ``folded-xla rect``) and ``xla`` (the
    fold again for a rectangular mip) against JAX's; the port's ``pallas``
    (K1's plain version on the CPU, ``fused-v2 rect``) against JAX's
    fold, which the JAX suite holds its kernel to at 2e-5."""
    h, w = HW[hw]
    recs, labels = {}, {}
    for backend in ("auto", "xla", "pallas"):
        jtr, ttr, jlines, tlines = _pair(
            HW[hw], tf_no_mip=False, max_mip_level=6, crop_mip_level=4,
            decode_backend=backend)
        for mip in range(7):
            got = ttr.decode(mip).numpy()
            assert got.shape == (h >> mip, w >> mip, 3), (backend, mip)
            if backend != "pallas":
                want = np.asarray(jtr.decode(mip))
                np.testing.assert_allclose(got, want, atol=2e-5,
                                           err_msg=f"{backend} mip {mip}")
                recs[(backend, mip)] = want
            else:
                np.testing.assert_allclose(got, recs[("auto", mip)],
                                           atol=2e-5, err_msg=f"mip {mip}")
        labels[backend] = [ln.split(": ")[1].split(" [")[0] for ln in tlines
                           if "decode backend gate" in ln]
        if backend != "pallas":
            assert labels[backend] == [
                ln.split(": ")[1].split(" [")[0] for ln in jlines
                if "decode backend gate" in ln]
    assert labels["auto"] == ["folded-xla rect"] * 6 + ["folded-xla"]
    assert labels["xla"] == ["folded-xla rect"] * 6 + ["xla gather"]
    assert labels["pallas"][:3] == ["fused-v2 rect"] * 3


def _pad_level(fp, level, axis=2, by=1):
    """JAX grids with grid ``level`` given ``by`` zero nodes at the end of
    ``axis`` (1 rows, 2 columns)."""
    widths = [(0, 0)] * 3
    widths[axis] = (0, by)
    return tuple(jnp.pad(g, widths) if i == level else g
                 for i, g in enumerate(fp))


def test_coarsest_g1_short_of_a_long_axis_reads_zero():
    """64×80 (G0 16×20 nodes − 1): the coarsest G1, level 1's [12, 3, 3],
    spans 16 of the 20 column cells, so mip 4's 5 columns and LOD 4's
    crops in column 4 put a weight-0 corner on node 3 (512×768 does this
    at mip and LOD 8). JAX reads NaN there; the port reads a zero node, so
    its decode and step are JAX's on the grids zero-padded by one column,
    and equal to JAX's wherever JAX's are finite."""
    jtr, ttr, _, _ = _pair((64, 80), tf_no_mip=False, max_mip_level=6,
                           crop_mip_level=4, num_epochs=100, mlp_num_dtype=32)
    assert [tuple(g.shape) for g in ttr.state.fp] == [
        (12, 17, 21), (12, 9, 11), (12, 5, 6), (12, 3, 3)]
    from nic.grids.fastdecode import fast_decode as jfast
    from nic.grids.pyramid import pyramid_quantize_all

    # the decode's grids: hard-quantized, as both trainers decode them
    padded = _pad_level(pyramid_quantize_all(jtr.state.fp, 8), 3)

    nan_mips = []
    for mip in (3, 4, 5):
        got = ttr.decode(mip).numpy()
        want = np.asarray(jtr.decode(mip))
        assert got.shape == want.shape == (64 >> mip, 80 >> mip, 3)
        assert np.isfinite(got).all()
        if not np.isfinite(want).all():
            nan_mips.append(mip)
            want = np.asarray(jfast(
                padded, jtr.state.mlp, mip,
                image_size=64, mip_to_level=jtr.mip_to_level, pe_channels=6,
                n=(64 >> mip, 80 >> mip)))
        np.testing.assert_allclose(got, want, atol=2e-5, err_msg=str(mip))
    assert nan_mips == [4]

    # LOD 4: 1×1 crops of the 4×5 image, one in column 4; the frozen
    # gather step's loss against JAX's rows on the padded grids
    from nic.grids.sample import decoder_input as jrows
    from nic.models.mlp import apply_mlp as jmlp

    lod = 4
    ttr.freeze_and_quantize()
    fl, n, step = jtr._geometry(lod)
    origins = np.array([[0, 0], [3, 4], [1, 4], [2, 1], [0, 3], [3, 0],
                        [2, 2], [1, 1]])
    kw = dict(pe_channels=6, mip_level=lod, ndim=2, use_tri_pe=True,
              sparse_g0=False)
    qfp = pyramid_quantize_all(jtr.state.fp, 8)
    raw = np.concatenate([np.asarray(jrows(qfp, fl, o, step, n, **kw))
                          for o in origins])
    rows = jnp.concatenate([jrows(padded, fl, o, step, n, **kw)
                            for o in origins])
    assert np.isnan(raw[1:3]).any(axis=1).all()
    assert np.isfinite(raw[[0, 3, 4, 5, 6, 7]]).all()
    tgt = np.stack([np.asarray(jtr.images[lod])[:, r, c] for r, c in origins])
    jloss = float(np.mean((np.asarray(jmlp(jtr.state.mlp, rows)) - tgt) ** 2))
    loss, _ = ttr.step_core(lod, torch.from_numpy(origins))
    assert abs(float(loss) - jloss) <= 1e-5 * jloss
    assert all(np.isfinite(g.detach().numpy()).all() for g in ttr.state.fp)


# ---- the CLIs --------------------------------------------------------------

RECT_ARGS = ["DEVICE=cpu", "IMAGE_SIZE=64", "IMAGE_SIZE_W=96",
             "CROP_MIP_LEVEL=5", "NUM_EPOCHS=20", "TF_NO_MIP=False",
             "MAX_MIP_LEVEL=6"]


@pytest.fixture(scope="module")
def rect_cli(tmp_path_factory):
    from nic_torch.cli import image_compression as tcli

    root = tmp_path_factory.mktemp("rect_cli")
    return root, tcli.run(RECT_ARGS + [f"OUTPUT_ROOT={root}"])


def test_cli_artifact_decodes_in_both_runtimes(rect_cli):
    """The training CLI's rectangular artifact: its config keeps
    image_size_w; each mip's PSNR is against that mip's image; bpp is the
    payload over H·W; the PNGs are H rows of W pixels; and both decode
    CLIs decode it at every mip to the JAX fold (2e-5)."""
    from PIL import Image

    from nic.cli.decode import run as jdecode
    from nic.io.artifacts import compressed_num_bits
    from nic_torch.cli.decode import run as tdecode
    from nic_torch.data.assets import load_image_mips
    from nic_torch.io.artifacts import load_compressed

    root, res = rect_cli
    art = res["artifact"]
    _, _, meta = load_compressed(art, device="cpu")
    assert meta["config"]["image_size_w"] == 96
    assert len(res["psnr"]) == 7 and np.isfinite(res["psnr"]).all()
    assert res["bpp"] == compressed_num_bits(art) / (64 * 96)
    png0 = [os.path.join(r, f) for r, _, fs in os.walk(
        os.path.join(root, "image")) for f in fs if f.endswith("_0_000.png")]
    (png0,) = png0
    u8 = np.asarray(Image.open(png0)).astype(np.float32)
    assert u8.shape == (64, 96, 3)
    tgt = np.moveaxis(load_image_mips("data/sancho_512.png", 64, 0,
                                      image_size_w=96)[0], 0, -1) * 255.0
    mse = float(np.mean((u8 - tgt) ** 2))
    assert abs(res["psnr"][0] - 10 * np.log10(256.0**2 / mse)) < 1e-3
    for mip in range(7):
        want = jdecode([art, "--mip", str(mip)])
        got = tdecode([art, "--mip", str(mip), "--device", "cpu"])
        assert got.shape == want.shape == (64 >> mip, 96 >> mip, 3)
        np.testing.assert_allclose(got, want, atol=2e-5, err_msg=str(mip))
    out = os.path.join(root, "mip1.png")
    tdecode([art, "--mip", "1", "--device", "cpu", "--out", out])
    assert np.asarray(Image.open(out)).shape == (32, 48, 3)


def test_decode_cli_xla_backend_on_rect_artifact(tmp_path):
    """``--backend xla`` on a rectangular artifact (a random 64×96
    flagship-width model) decodes [H, W, 3] through the fold, as the JAX
    runtime routes it; both runtimes agree (mips 0, 2 and 6, the last
1×1)."""
    from nic.cli.decode import run as jdecode
    from nic_torch.cli.decode import run as tdecode
    from nic_torch.grids.pyramid import create_pyramid, pyramid_quantize_all
    from nic_torch.io.artifacts import save_compressed
    from nic_torch.models.mlp import init_mlp

    gen = torch.Generator(device="cpu").manual_seed(0)
    fp, _ = create_pyramid(gen, (16, 24), 12, 8, 2, device="cpu",
                           no_mip=False)
    mlp = init_mlp(gen, 12 * 5 + 2 * 6 + 1, 64, 3, device="cpu")
    art = str(tmp_path / "rect.npz")
    save_compressed(art, mlp, pyramid_quantize_all(fp, 8), 8, {
        "save_name": "rect", "config": {
            "image_size": 64, "image_size_w": 96, "pe_channels": 6,
            "tf_use_tri_pe": True, "tf_no_mip": False,
            "compression_method": 1, "image_dimension": 2}})
    for mip in (0, 2, 6):
        want = jdecode([art, "--mip", str(mip), "--backend", "xla"])
        got = tdecode([art, "--mip", str(mip), "--device", "cpu",
                       "--backend", "xla"])
        assert got.shape == want.shape == (64 >> mip, 96 >> mip, 3)
        np.testing.assert_allclose(got, want, atol=2e-5, err_msg=str(mip))


def test_rect_cli_on_cuda_without_a_card_raises(tmp_path):
    from nic_torch.cli import image_compression as tcli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="DEVICE=cpu"):
        tcli.run(RECT_ARGS[1:] + [f"OUTPUT_ROOT={tmp_path}"])


def _rd_images(directory):
    from PIL import Image

    os.makedirs(directory)
    rng = np.random.default_rng(0)
    # one landscape, one portrait, both multiples of 4
    for name, (h, w) in (("a.png", (48, 64)), ("b.png", (64, 48))):
        arr = (rng.uniform(0, 1, (h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(directory, name))


def test_eval_rd_native_geometry_matches_jax(tmp_path):
    """The same JSON keys and protocol as JAX's, and each image's bpp
    exactly; PSNR only above a floor (the crop and noise streams
    differ)."""
    from nic.cli.eval_rd import run as jeval
    from nic_torch.cli.eval_rd import run as teval

    d = str(tmp_path / "imgs")
    _rd_images(d)
    args = ["--dir", d, "--codec", "ntc", "--native-geometry",
            "NUM_EPOCHS=20", "CROP_MIP_LEVEL=5", "QAT_NOISE_WHERE=node"]
    want = jeval(args + ["--out", str(tmp_path / "j.json"), "--output_root",
                         str(tmp_path / "j")])
    got = teval(args + ["--out", str(tmp_path / "t.json"), "--output_root",
                        str(tmp_path / "t"), "DEVICE=cpu"])
    with open(tmp_path / "t.json") as fh:
        assert json.load(fh) == got
    assert sorted(got) == sorted(want)
    assert got["protocol"] == want["protocol"]
    assert got["protocol"]["geometry"].startswith("native")
    assert [r["image"] for r in got["images"]] == ["a.png", "b.png"]
    assert [r["bpp"] for r in got["images"]] == [r["bpp"]
                                                 for r in want["images"]]
    assert all(r["psnr"] > 9.0 for r in got["images"])


def test_eval_rd_square_protocol_and_refusals(tmp_path):
    """Without --native-geometry each image is center-cropped and resized
    to IMAGE_SIZE; ENTROPY_CODE_GRIDS=True counts each image's bits with
    its grids rANS-coded (JAX's harness's bpp for the same codes); the
    hyperprior codec refuses without a checkpoint."""
    from nic_torch.cli.eval_rd import run as teval

    d = str(tmp_path / "imgs")
    _rd_images(d)
    common = ["--dir", d, "--output_root", str(tmp_path), "DEVICE=cpu"]
    res = teval(common + ["IMAGE_SIZE=32", "CROP_MIP_LEVEL=4",
                          "NUM_EPOCHS=4"])
    assert res["protocol"]["geometry"].startswith("center-crop")
    assert [r["bpp"] for r in res["images"]] == [res["images"][0]["bpp"]] * 2
    assert os.path.exists(os.path.join(
        tmp_path, "eval_rd_ntc_imgs_fp8.json"))
    ent = teval(common + ["IMAGE_SIZE=32", "CROP_MIP_LEVEL=4",
                          "NUM_EPOCHS=4", "ENTROPY_CODE_GRIDS=True",
                          "--out", str(tmp_path / "e.json")])
    assert ent["protocol"]["entropy_code_grids"] is True
    assert [r["psnr"] for r in ent["images"]] == [r["psnr"]
                                                  for r in res["images"]]
    assert all(e["bpp"] != r["bpp"] for e, r in zip(ent["images"],
                                                    res["images"]))
    with pytest.raises(SystemExit, match="--ckpt"):
        teval(common + ["--codec", "hyperprior"])
