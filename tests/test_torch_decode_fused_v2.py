"""nic_torch.kernels.decode_fused_v2 against nic.kernels.decode_fused_v2.

The JAX kernel runs in Pallas interpret mode on the CPU, as the JAX
suite runs it; the port runs the plain version of its CUDA kernel, which
a CPU tensor takes. The CUDA kernel itself is compared with that plain
version by the ``cuda``-marked test below and by ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)
from jax.experimental.pallas import tpu as pltpu

from nic.grids.pyramid import pyramid_mip_levels
from nic.kernels import decode_fused_v2 as jdf
from nic_torch.kernels import decode_fused_v2 as tdf
from test_torch_fastdecode import PE, both, make_model

JAX_DTYPES = {"fp32": None, "bf16": jnp.bfloat16, "i16": "i16",
              "surgical": "surgical"}
TORCH_DTYPES = {"fp32": None, "bf16": torch.bfloat16, "i16": "i16",
                "surgical": "surgical"}
# Plain torch body vs the JAX kernel on identical inputs. fp32 planes and
# dots: the two differ only in summation order and the erf/tanh/exp
# implementations (≤ 1e-6 measured), so the JAX suite's 2e-5 holds. With
# bf16 dot inputs, a last-bit difference in an fp32 GELU output can flip
# its bf16 rounding (2^-9 relative), which moves one output by up to
# |W|·|h|·2^-9 — a few 1e-4 at these widths; 2e-3 bounds it with margin
# and stays half an 8-bit step.
TOL = {"fp32": 2e-5, "bf16": 2e-3, "i16": 2e-3, "surgical": 2e-3}


def _model(seed, size, no_mip=False):
    base = size // 4
    fp, mlp = make_model(seed, base=base, no_mip=no_mip)
    return (*both(fp, mlp), pyramid_mip_levels(size, base, no_mip))


@pytest.mark.parametrize("hidden", [16, 64])
@pytest.mark.parametrize("size", [64, 128, 512, (64, 128), (512, 768)])
def test_kernel_covers_2d_matches_jax(size, hidden):
    smin = size if isinstance(size, int) else min(size)
    for no_mip in (False, True):
        m2l = pyramid_mip_levels(smin, smin // 4, no_mip)
        for mip in m2l:
            args = (mip, size, m2l, hidden)
            assert tdf.kernel_covers_2d(*args) == jdf.kernel_covers_2d(*args)


@pytest.mark.parametrize("mode", list(JAX_DTYPES))
def test_prepare_2d_matches_jax(mode):
    (jfp, jmlp), (tfp, tmlp), m2l = _model(21, 64)
    for mip in (0, 1, 2):
        kw = dict(image_size=64, mip_to_level=m2l, pe_channels=PE,
                  use_tri_pe=True)
        want = jdf._prepare_2d(jfp, jmlp, mip, dtype=JAX_DTYPES[mode],
                               block_rows=None, block_cols=None, **kw)
        got = tdf._prepare_2d(tfp, tmlp, mip, dtype=TORCH_DTYPES[mode], **kw)
        geom = got[-1]
        assert {k: want[-1][k] for k in geom} == geom
        names = ("pc", "c1v", "pe_u", "w2", "b2", "w3", "b3")
        for name, w, g in zip(names, want[:7], got[:7]):
            w = np.asarray(w)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), name
            # int16 codes may differ by one where the fp32 fold rounds a
            # value on the other side of a half step
            atol = 1 if g.dtype == torch.int16 else (
                2**-8 if g.dtype == torch.bfloat16 else 2e-6)
            np.testing.assert_allclose(
                g.detach().float().numpy(), w.astype(np.float32),
                atol=atol, rtol=2**-8 if g.dtype == torch.bfloat16 else 0,
                err_msg=name)
        if mode == "i16":
            assert float(got[7]) == pytest.approx(float(want[7]), rel=1e-6)
        else:
            assert got[7] is None and want[7] is None


def _compare_with_jax(seed, size, mip, mode, gelu, no_mip=False):
    (jfp, jmlp), (tfp, tmlp), m2l = _model(seed, size, no_mip)
    kw = dict(image_size=size, mip_to_level=m2l, pe_channels=PE, gelu=gelu)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jdf.decode_image_fused_v2(
            jfp, jmlp, mip, dtype=JAX_DTYPES[mode], **kw))
    before = tdf.decode_kernel_2d.launches
    with torch.inference_mode():
        got = tdf.decode_image_fused_v2(tfp, tmlp, mip,
                                        dtype=TORCH_DTYPES[mode], **kw)
    assert tdf.decode_kernel_2d.launches == before  # the CPU runs no kernel
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[mode], rtol=0)


@pytest.mark.parametrize("gelu", list(tdf.GELUS))
@pytest.mark.parametrize("mode", list(JAX_DTYPES))
def test_plain_kernel_matches_jax_kernel(mode, gelu):
    _compare_with_jax(31, 64, 0, mode, gelu)


@pytest.mark.parametrize("mip,mode,gelu", [(0, "fp32", "exact"),
                                           (1, "i16", "tanherf"),
                                           (2, "bf16", "poly")])
def test_plain_kernel_matches_jax_kernel_128(mip, mode, gelu):
    """128², no-mip: several JAX tiles, f ∈ {4, 2, 1}."""
    _compare_with_jax(41, 128, mip, mode, gelu, no_mip=True)


@pytest.mark.parametrize("gelu", list(tdf.GELUS))
def test_gelus_match_jax(gelu):
    x = np.linspace(-7, 7, 4001, dtype=np.float32)
    want = np.asarray(jdf._GELUS[gelu](jnp.asarray(x)))
    got = tdf.GELUS[gelu](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _prepared(mode="fp32", size=64, mip=0):
    _, (tfp, tmlp), m2l = _model(51, size)
    with torch.inference_mode():
        return tdf._prepare_2d(tfp, tmlp, mip, image_size=size,
                               mip_to_level=m2l, pe_channels=PE,
                               use_tri_pe=True, dtype=TORCH_DTYPES[mode])


@pytest.mark.parametrize("bad", ["shape", "dtype", "scale", "contiguous",
                                 "f", "gelu"])
def test_kernel_wrapper_refuses(bad):
    pc, c1v, pe_u, w2, b2, w3, b3, scale, geom = _prepared()
    kw = dict(f=geom["f"], f1=geom["f1"], gelu="exact")
    if bad == "shape":
        c1v = c1v[:-1]
    elif bad == "dtype":
        pc = pc.to(torch.bfloat16)
    elif bad == "scale":
        scale = torch.tensor(1.0)
    elif bad == "contiguous":
        pc = pc.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "f":
        kw["f"] = 3
    else:
        kw["gelu"] = "relu"
    with pytest.raises(ValueError):
        tdf.decode_kernel_2d(pc, c1v, pe_u, w2, b2, w3, b3, scale, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(TORCH_DTYPES))
def test_cuda_kernel_matches_plain(mode):
    """The hand-written kernel against its plain version on the card, at
    every GELU (tolerances as in chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    prep = _prepared(mode, size=128)
    pc, c1v, pe_u, w2, b2, w3, b3, scale, geom = (
        t.cuda() if isinstance(t, torch.Tensor) else t for t in prep)
    for gelu in tdf.GELUS:
        kw = dict(f=geom["f"], f1=geom["f1"], gelu=gelu)
        before = tdf.decode_kernel_2d.launches
        got = tdf.decode_kernel_2d(pc, c1v, pe_u, w2, b2, w3, b3, scale, **kw)
        torch.cuda.synchronize()
        assert tdf.decode_kernel_2d.launches == before + 1
        want = tdf.decode_kernel_2d_plain(pc, c1v, pe_u, w2, b2, w3, b3,
                                          scale, **kw)
        err = float((got - want).abs().max())
        assert err <= TOL[mode], (gelu, err)


# ---- K2: the z1-matmul per-pixel stage ----------------------------------

def test_z1mm_plain_matches_jax_z1mm_kernel():
    """JAX's z1-matmul kernel (explicit True, any width) in interpret mode
    at mip 0 (f = 4: [A0 | A1] is [8, 4])."""
    (jfp, jmlp), (tfp, tmlp), m2l = _model(81, 64)
    kw = dict(image_size=64, mip_to_level=m2l, pe_channels=PE)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jdf.decode_image_fused_v2(jfp, jmlp, 0,
                                                    z1_matmul=True, **kw))
    before = tdf.decode_kernel_z1mm.launches
    with torch.inference_mode():
        got = tdf.decode_image_fused_v2(tfp, tmlp, 0, z1_matmul=True, **kw)
    assert tdf.decode_kernel_z1mm.launches == before  # no kernel on the CPU
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("mip", [0, 1, 2])
@pytest.mark.parametrize("mode", ["fp32", "bf16", "surgical"])
def test_z1mm_plain_matches_k1_plain(mode, mip):
    """The dense [A0 | A1] product is the per-row interpolation, f ∈ {4,
    2, 1} (f = 1 adds P as it is); 128², several tiles."""
    _, (tfp, tmlp), m2l = _model(83, 128, no_mip=True)
    kw = dict(image_size=128, mip_to_level=m2l, pe_channels=PE,
              dtype=TORCH_DTYPES[mode])
    with torch.inference_mode():
        k1 = tdf.decode_image_fused_v2(tfp, tmlp, mip, **kw)
        k2 = tdf.decode_image_fused_v2(tfp, tmlp, mip, z1_matmul=True, **kw)
    np.testing.assert_allclose(k2.numpy(), k1.numpy(), atol=TOL[mode],
                               rtol=0)


def test_z1_matrix_matches_jax_rule():
    for R, f, f1 in ((8, 4, 8), (8, 2, 4), (8, 1, 2), (16, 8, 16),
                     (32, 16, 32)):
        a = tdf.z1_matrix(R, f, f1).numpy()
        k0 = R // f
        assert a.shape == (R, k0 + R // f1 + 1)
        np.testing.assert_array_equal(a[:, :k0].sum(1), 1.0)
        np.testing.assert_array_equal(a[:, k0:].sum(1), 1.0)
        for r in range(R):
            assert a[r, r // f] == 1.0
            assert a[r, k0 + r // f1] == 1.0 - (r % f1) / f1


def test_z1mm_auto_picks_as_jax(monkeypatch):
    """``"auto"`` takes K2 exactly where JAX's lane-packing predicate holds
    (read from JAX's own ``_prepare_2d``), and K1 under int16 planes;
    ``True`` with int16 planes raises in both packages."""
    calls = []
    for name in ("decode_kernel_2d", "decode_kernel_z1mm"):
        real = getattr(tdf, name)
        monkeypatch.setattr(tdf, name, lambda *a, _n=name, _r=real, **k: (
            calls.append(_n), _r(*a, **k))[1])
    seen = set()
    # (hidden, image size, grid base, mips): packed needs 2H == 128
    for hidden, size, base, mips in ((64, 64, 16, range(4)),
                                     (64, (32, 64), (8, 16), range(3)),
                                     (16, 64, 16, (0,))):
        (jfp, jmlp), (tfp, tmlp) = both(*make_model(
            85, base=base, hidden=hidden, no_mip=True))
        smin = size if isinstance(size, int) else min(size)
        m2l = pyramid_mip_levels(smin, smin // 4, True)
        kw = dict(image_size=size, mip_to_level=m2l, pe_channels=PE,
                  use_tri_pe=True)
        for mip in mips:
            want = jdf._prepare_2d(jfp, jmlp, mip, dtype=None,
                                   block_rows=None, block_cols=None,
                                   **kw)
            if want is None:
                continue
            for mode in ("fp32", "i16"):
                calls.clear()
                with torch.inference_mode():
                    tdf.decode_image_fused_v2(
                        tfp, tmlp, mip, dtype=TORCH_DTYPES[mode],
                        z1_matmul="auto", **kw)
                k2 = want[-1]["packed"] and mode == "fp32"
                assert calls == ["decode_kernel_z1mm" if k2
                                 else "decode_kernel_2d"], (size, mip)
                seen.add(k2)
    assert seen == {True, False}
    for pkg, (fp, mlp) in ((jdf, (jfp, jmlp)), (tdf, (tfp, tmlp))):
        with pytest.raises(ValueError, match="i16"):
            pkg.decode_image_fused_v2(fp, mlp, 0, dtype="i16",
                                      z1_matmul=True, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32", "bf16", "surgical"])
def test_cuda_z1mm_matches_plain(mode):
    """K2 against its plain version on the card at every GELU, mips 0-2
    of a 128² hidden-64 model (tolerances as in chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    fp, mlp = make_model(87, base=32, hidden=64, no_mip=True)
    _, (tfp, tmlp) = both(fp, mlp)
    m2l = pyramid_mip_levels(128, 32, True)
    tfp = tuple(g.cuda() for g in tfp)
    tmlp = {k: tmlp[k].detach().cuda() for k in ("w1", "b1", "w2", "b2",
                                                   "w3", "b3")}
    for mip in (0, 1, 2):
        with torch.inference_mode():
            prep = tdf._prepare_2d(tfp, tmlp, mip, image_size=128,
                                   mip_to_level=m2l, pe_channels=PE,
                                   use_tri_pe=True,
                                   dtype=TORCH_DTYPES[mode])
        pc, c1v, pe_u, w2, b2, w3, b3, _, geom = prep
        for gelu in tdf.GELUS:
            kw = dict(f=geom["f"], f1=geom["f1"], R=geom["R"], gelu=gelu)
            before = tdf.decode_kernel_z1mm.launches
            got = tdf.decode_kernel_z1mm(pc, c1v, pe_u, w2, b2, w3, b3, **kw)
            torch.cuda.synchronize()
            assert tdf.decode_kernel_z1mm.launches == before + 1
            want = tdf.decode_kernel_z1mm_plain(pc, c1v, pe_u, w2, b2, w3,
                                                b3, **kw)
            err = float((got - want).abs().max())
            assert err <= TOL[mode], (mip, gelu, err)
