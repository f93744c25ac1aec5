"""nic_torch's mesh (``nic_torch.parallel``, one process a rank over
torch.distributed) against nic's device mesh, on the CPU with gloo.

Without spawning: the backend and rank → device rule; kernel3's feature
noise split at the data ranks' pixel bases equal bit for bit to one
rank's stream; the sharded decode's per-rank blocks equal bit for bit to
the whole decode (2D square, rectangular, int16 planes, 3D dense and
sparse G0) and, gathered, to JAX's ``decode_*_fused_sharded`` on the
conftest's virtual mesh within the fp32 limit of
``tests/test_multidevice.py``.

One spawned group (rendezvous through a file under ``tmp_path``; CPU
ranks, one thread each): 2 ranks running NTC gather and kernel3 steps,
hyperprior steps (clipped after the reduce) and conv-AE sheet steps (the
recomputed halo), each fed the draws of JAX's 2-device mesh trainer and
held to it; and hyperprior, movie-label and conv-AE steps from their own
seeds, held to one rank. The other spawned groups are in
``tests/test_torch_parallel_entry.py``.

Post-Adam params: Adam's first steps move a parameter by about
lr·g/|g|, so an element whose gradient is the near-cancelling sum of
many terms moves by lr times that sum's relative rounding. So each
step's gradients are held to the grad limits of
``tests/test_torch_ntc_train.py`` (max|Δ|/max|g|: 1e-4 with fp32 dots,
1e-2 with bf16 dot inputs, the configuration's default: each rank rounds
its share of a weight's gradient to bf16, as the backward of the bf16
cast does, before the ranks' shares are summed), and the params to JAX's
atol 1e-5 plus the difference that Adam, replayed in float64 from the
two runs' gradients, makes of them.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parallel_ranks as ranks
from torch_parallel_ranks import check_steps
from nic.config import CompressionConfig as JConfig
from nic.parallel.mesh import make_mesh as j_make_mesh
from nic.train import ntc as jntc
from nic_torch.kernels import decode_fused_3d as t3d
from nic_torch.kernels import decode_fused_v2 as t2d
from nic_torch.kernels import decode_sharded as tds
from nic_torch.kernels.train_fused_ff import _noise
from nic_torch.parallel import mesh as tmesh
from nic_torch.parallel.mesh import run_ranks
from test_torch_fastdecode import PE, both, make_model
from test_torch_ntc_train import _jax_draws

requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
STEPS = 3


def test_backend_rule_and_rank_devices():
    assert tmesh.backend_for("cpu", 4, 0) == "gloo"
    # one card each: NCCL; ranks sharing a card: gloo (NCCL refuses two
    # ranks on one device)
    assert tmesh.backend_for("cuda", 4, 4) == "nccl"
    assert tmesh.backend_for("cuda", 1, 1) == "nccl"
    assert tmesh.backend_for("cuda", 2, 1) == "gloo"
    assert tmesh.backend_for("cuda", 8, 4) == "gloo"
    assert tmesh.rank_device("cpu", 3, 0) == torch.device("cpu")
    assert [tmesh.rank_device("cuda", r, 1) for r in range(2)] == [
        torch.device("cuda", 0)] * 2
    assert [tmesh.rank_device("cuda", r, 4).index for r in range(6)] == [
        0, 1, 2, 3, 0, 1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.rank_device("cuda", 0, 0)
    # no launcher, no mesh
    assert tmesh.init_from_env("cpu") is None
    x = torch.arange(8)
    assert tmesh.shard_rows(x, None) is x


def test_kernel3_noise_splits_at_the_pixel_base():
    """Each data rank's in-kernel ε, drawn at pixel base rank·local
    pixels, is its rows of one rank's stream, bit for bit."""
    crops, npix, nfeat = 8, 16 * 16, 29
    seed = torch.tensor([123456789, -987654321, 0, 0], dtype=torch.int32)
    whole = _noise(crops * npix, nfeat, seed, 8, "cpu")
    for parts in (2, 4):
        local = crops // parts * npix
        blocks = []
        for k in range(parts):
            s = seed.clone()
            s[2] = k * local
            blocks.append(_noise(local, nfeat, s, 8, "cpu"))
        assert torch.equal(torch.cat(blocks), whole)


@requires_8
def test_mesh_gates_match_jax():
    """Under a 2-rank data mesh the port's gates pick the engine JAX's
    mesh gates pick (kernel3_sharded → kernel2_sharded → gather, on the
    local crop count; TRAIN_FORWARD=kernel runs gather) at every LOD of a
    mip-mode configuration."""
    from nic_torch.config import CompressionConfig as TConfig
    from nic_torch.train import ntc as tntc

    mesh = j_make_mesh(2, data_axis=2)
    rank = tmesh.Mesh(data=2, pixel=1, rank=0, device=torch.device("cpu"),
                      backend="gloo")
    img = ranks.toy_image(32)
    seen = set()
    for forward in ("kernel3", "kernel2", "kernel", "gather"):
        for crops, tri in ((8, True), (4, True), (2, False)):
            kw = dict(ranks.NTC_KW, tf_no_mip=False, max_mip_level=3,
                      train_forward=forward, num_crops=crops,
                      tf_use_tri_pe=tri)
            with mesh:
                jtr = jntc.NTCTrainer(JConfig(**kw), [img], mesh=mesh)
            ttr = tntc.NTCTrainer(TConfig(device="cpu", **kw),
                                  [img[:, ::2**i, ::2**i] for i in range(4)])
            ttr.mesh = rank  # the gates read only the data axis
            for lod in range(4):
                with mesh:
                    jtr._build_step(lod, False, jit=False)
                mode = ttr._plan(lod, False).mode
                assert mode == jtr._forward_mode, (forward, crops, lod)
                seen.add(mode)
    assert seen == {"kernel3_sharded", "kernel2_sharded", "gather"}


def _decode_2d(size, dtype):
    base = size // 4 if isinstance(size, int) else tuple(s // 4 for s in size)
    fp, mlp = make_model(7, base=base)
    _, (tfp, tmlp) = both(fp, mlp)
    smin = size if isinstance(size, int) else min(size)
    m2l = jntc.fp_lib.pyramid_mip_levels(smin, smin // 4, False)
    return tfp, tmlp, dict(image_size=size, mip_to_level=m2l,
                           pe_channels=PE, use_tri_pe=True, dtype=dtype)


def _model_3d(sparse, size=16):
    from nic_torch.grids.pyramid import create_pyramid, pyramid_mip_levels
    from nic_torch.models.mlp import init_mlp

    gen = torch.Generator().manual_seed(5)
    fp, _ = create_pyramid(gen, size // 4, 4, 8, 3, device="cpu")
    fp = tuple(g.detach() for g in fp)
    mlp = init_mlp(gen, 4 * (5 if sparse else 9) + 4 * 3 + 1, 16, 3,
                   device="cpu")
    for p in mlp.parameters():
        p.requires_grad_(False)
    return fp, mlp, pyramid_mip_levels(size, size // 4)


@pytest.mark.parametrize("case", ["square", "rect", "i16", "bf16"])
def test_image_blocks_are_the_whole_decode(case):
    size = (64, 96) if case == "rect" else 64
    dtype = {"i16": "i16", "bf16": torch.bfloat16}.get(case)
    fp, mlp, kw = _decode_2d(size, dtype)
    for mip in (0, 1, 2):
        whole = t2d.decode_image_fused_v2(fp, mlp, mip, **kw)
        for parts in (2, 4):
            blocks = [tds.decode_image_block(fp, mlp, mip, k, parts, **kw)
                      for k in range(parts)]
            if blocks[0] is None:  # JAX's fallback: rows too few to split
                assert (64 >> mip) // parts % 8
                continue
            assert torch.equal(torch.cat(blocks), whole), (mip, parts)


@pytest.mark.parametrize("sparse", [False, True])
def test_volume_blocks_are_the_whole_decode(sparse):
    fp, mlp, m2l = _model_3d(sparse)
    kw = dict(image_size=16, mip_to_level=m2l, pe_channels=4,
              use_tri_pe=False, sparse_g0=sparse)
    for mip, dtype in ((0, None), (1, None), (0, "i16")):
        whole = t3d.decode_volume_fused(fp, mlp, mip, dtype=dtype, **kw)
        for parts in (2, 4):
            blocks = [tds.decode_volume_block(fp, mlp, mip, k, parts,
                                              dtype=dtype, **kw)
                      for k in range(parts)]
            assert torch.equal(torch.cat(blocks), whole), (mip, parts)


@requires_8
@pytest.mark.parametrize("ndim", [2, 3])
def test_sharded_decode_matches_jax_mesh(ndim):
    """The 4 ranks' blocks, gathered, against JAX's sharded decode on a
    4-device mesh (Pallas interpret mode) within tests/test_multidevice.py's
    fp32 limit."""
    from jax.experimental.pallas import tpu as pltpu

    from nic.kernels.decode_sharded import (decode_image_fused_sharded,
                                            decode_volume_fused_sharded)

    if ndim == 2:
        fp, mlp, kw = _decode_2d(32, None)
        kw.pop("dtype")
        got = torch.cat([tds.decode_image_block(fp, mlp, 0, k, 4, **kw)
                         for k in range(4)])
        entry = decode_image_fused_sharded
    else:
        fp, mlp, m2l = _model_3d(False, 8)
        kw = dict(image_size=8, mip_to_level=m2l, pe_channels=4,
                  use_tri_pe=False)
        got = torch.cat([tds.decode_volume_block(fp, mlp, 0, k, 4, **kw)
                         for k in range(4)])
        entry = decode_volume_fused_sharded
    jfp = tuple(jnp.asarray(g.numpy()) for g in fp)
    jmlp = {k: jnp.asarray(mlp[k].detach().numpy())
            for k in ranks.PARAM_NAMES}
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(entry(jfp, jmlp, 0, j_make_mesh(4, data_axis=4),
                                **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


# ---- spawned groups ---------------------------------------------------------

def _jax_mesh_run(forward, num_crops, devices, data_axis, path,
                  monkeypatch):
    """JAX's trainer on a mesh for STEPS steps; writes its initial params
    and each step's whole draws to ``path`` → (losses, each step's
    gradients, params)."""
    import nic.kernels.train_fused_ff as jff

    cfg = JConfig(train_forward=forward, num_crops=num_crops,
                  **ranks.NTC_KW)
    img = ranks.toy_image(32)
    init = _tree(jntc.NTCTrainer(cfg, [img]).state)[0]
    mesh = j_make_mesh(devices, data_axis=data_axis)
    # the classic Pallas interpreter under shard_map, as __graft_entry__'s
    # dry run takes it
    monkeypatch.setattr(jff, "INTERPRET", True)
    draws = {"origins": [], "eps": [], "seed": []}
    losses, grads, mu = [], [], None
    with mesh:
        jtr = jntc.NTCTrainer(cfg, [img], mesh=mesh)
        for _ in range(STEPS):
            sub = jax.random.split(jtr._key)[1]
            origins, kw = _jax_draws(cfg, 16, sub, False, forward)
            draws["origins"].append(origins.numpy())
            for k, v in kw.items():
                draws[k].append(v.numpy())
            losses.append(float(jtr.train_step()[0]))
            # the step's gradient from Adam's first moments
            new = _tree(jtr.state)[1]
            prev = [0.0] * len(new) if mu is None else mu
            grads.append([(m - 0.9 * m0) / 0.1 for m, m0 in zip(new, prev)])
            mu = new
    assert jtr._forward_mode == {"kernel3": "kernel3_sharded"}.get(
        forward, forward)
    np.savez(path, **{k: np.stack(v) for k, v in draws.items() if v},
             **{f"param{i}": p for i, p in enumerate(init)})
    return np.array(losses), grads, _tree(jtr.state)[0]


def _tree(state):
    """JAX trainer state → (params, Adam's first moments) as float64
    arrays, grids then the MLP."""
    params = list(state.fp) + [state.mlp[k] for k in ranks.PARAM_NAMES]
    mus = list(state.opt_fp[0].mu) + [state.opt_mlp[0].mu[k]
                                      for k in ranks.PARAM_NAMES]
    return ([np.asarray(p, np.float32) for p in params],
            [np.asarray(m, np.float64) for m in mus])


def _flat(tree) -> dict:
    return {"/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                     for q in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _save(path, params: dict, **draws) -> None:
    np.savez(path, **draws, **{"param:" + k.replace("/", ":"): v
                               for k, v in params.items()})


def _jax_hyperprior_mesh_run(path, steps: int = 2):
    """JAX's hyperprior trainer on make_mesh(2, data_axis=2) for
    ``steps`` steps; writes its initial params and each step's whole batch and
    noise (the draws its step takes from its key) to ``path`` →
    (losses, params)."""
    from nic.train.hyperprior import HyperpriorTrainer as JHyperprior

    jtr = JHyperprior(**ranks.HP_KW, mesh=j_make_mesh(2, data_axis=2))
    init = _flat(jtr.params["params"])
    model, hp = jtr.model, ranks.HP_KW
    x = jnp.zeros((hp["batch"], hp["patch"], hp["patch"], 3))
    y = jax.eval_shape(lambda p: model.apply(p, x, method=model.analysis),
                       jtr.params)
    z = jax.eval_shape(lambda p: model.apply(
        p, jnp.zeros(y.shape), method=model.hyper_analysis), jtr.params)
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (96, 96, 3)).astype(np.float32)
    draws = {"batch": [], "uy": [], "uz": []}
    losses = []
    for _ in range(steps):
        batch = jtr.sample_patches([img], rng)
        ky, kz = jax.random.split(jax.random.split(jtr._key)[1])
        draws["batch"].append(batch)
        draws["uy"].append(np.asarray(jax.random.uniform(
            ky, y.shape, jnp.float32, -0.5, 0.5)))
        draws["uz"].append(np.asarray(jax.random.uniform(
            kz, z.shape, jnp.float32, -0.5, 0.5)))
        losses.append(float(jtr.train_step(batch)[0]))
    _save(path, init, **{k: np.stack(v) for k, v in draws.items()})
    return np.array(losses), _flat(jtr.params["params"])


def _jax_conv_ae_mesh_run(path):
    """JAX's conv-AE trainer (image_comp's widths) on a 32×16 sheet over
    make_mesh(2, data_axis=2) for STEPS steps, the last in the quantize
    phase; writes the sheet, its initial params and each step's
    whole-latent noise to ``path`` → (losses, params)."""
    from nic.core.quant import qat_noise
    from nic.train.conv_ae import ConvAETrainer as JConvAE

    asset = np.random.default_rng(1).uniform(0, 1, (32, 16, 3)).astype(
        np.float32)
    jtr = JConvAE(asset, num_bits=4, num_epochs=STEPS - 1,
                  mesh=j_make_mesh(2, data_axis=2))
    init = _flat(jtr.params)
    zshape = jax.eval_shape(lambda p, x: jtr.model.encoder.apply(p["enc"], x),
                            jtr.params, jtr.image).shape
    noise, losses = [], []
    for _ in range(STEPS):
        sub = jax.random.split(jtr._key)[1]
        noise.append(np.asarray(qat_noise(sub, zshape, 4)))
        losses.append(float(jtr.train_step()))
    _save(path, init, asset=asset, noise=np.stack(noise))
    return np.array(losses), _flat(jtr.params)


def test_two_ranks_match_jax_mesh_and_one_rank(tmp_path, monkeypatch):
    """One spawn of 2 ranks: NTC gather and kernel3 (plain) steps, the
    hyperprior step with its clip active and the conv-AE sheet step, each
    fed the draws of JAX's make_mesh(2, data_axis=2) trainer and held to
    it (the NTC also to the port's one-rank run); hyperprior, movie-label
    and conv-AE (2D sheet rows and 3D frames) steps from their own seeds
    against the port's one-rank run; params equal on both ranks."""
    paths, jax_runs = {}, {}
    for forward in ("gather", "kernel3"):
        paths[forward] = str(tmp_path / f"{forward}.npz")
        jax_runs[forward] = _jax_mesh_run(forward, 8, 2, 2, paths[forward],
                                          monkeypatch)
    paths["hyperprior"] = str(tmp_path / "hyperprior.npz")
    jax_hp = _jax_hyperprior_mesh_run(paths["hyperprior"])
    paths["conv_ae"] = str(tmp_path / "conv_ae.npz")
    jax_ae = _jax_conv_ae_mesh_run(paths["conv_ae"])
    two = run_ranks(ranks.two_ranks, 2, paths, device="cpu",
                    workdir=str(tmp_path), threads=1)
    for r in two:  # replicated params: the same bytes on every rank
        assert {k: v["digest"] for k, v in r.items()} == {
            k: v["digest"] for k, v in two[0].items()}
    got = two[0]
    for forward in ("gather", "kernel3"):
        g = got[forward]
        assert g["engine"] == {"kernel3": "kernel3_sharded"}.get(
            forward, forward)
        # JAX's own loss bound for its mesh step (tests/test_multidevice.py)
        check_steps(g, *jax_runs[forward], 1e-5, f"{forward} vs JAX")
        one = ranks.ntc_steps(None, paths[forward], forward, 8)
        check_steps(g, one["losses"], one["grads"], one["params"], 1e-6,
                     f"{forward} vs one rank")
    # the hyperprior step clipped by the global norm after the reduce, and
    # the conv-AE step with its recomputed halo, against JAX's sharded
    # steps fed the same draws (the one-rank limits of
    # tests/test_torch_hyperprior.py and tests/test_torch_conv_ae.py)
    hp = got["hyperprior jax"]
    np.testing.assert_allclose(hp["norms"], ranks.HP_KW["clip_grad_norm"],
                               rtol=1e-4)  # the clip acted in every step
    for name, (losses, params) in (("hyperprior jax", jax_hp),
                                   ("conv_ae jax", jax_ae)):
        np.testing.assert_allclose(got[name]["losses"], losses, rtol=1e-5,
                                   err_msg=name)
        assert got[name]["params"].keys() == params.keys()
        for k, v in params.items():
            np.testing.assert_allclose(got[name]["params"][k], v, atol=1e-6,
                                       rtol=0, err_msg=f"{name} {k}")
    for name, fn in (("hyperprior", ranks.hyperprior_steps),
                     ("movie_label", ranks.movie_label_steps),
                     ("conv_ae 2d", lambda m: ranks.conv_ae_steps(m, "2d")),
                     ("conv_ae 3d", lambda m: ranks.conv_ae_steps(m, "3d"))):
        one = fn(None)
        np.testing.assert_allclose(got[name]["losses"], one["losses"],
                                   rtol=1e-5, err_msg=name)
        for a, b in zip(got[name]["params"], one["params"]):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0,
                                       err_msg=name)
        if name == "movie_label":
            np.testing.assert_allclose(got[name]["recon"], one["recon"],
                                       atol=1e-5)
