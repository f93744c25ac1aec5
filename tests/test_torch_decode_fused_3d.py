"""nic_torch.kernels.decode_fused_3d (K5) and the 3D fold against the JAX
package.

The folded decode (``fast_decode``, ndim 3) is K5's plain oracle and is
held to JAX's at every mip; the frame and column stage is held to JAX's
``_prepare_3d`` in every plane mode; the plain version of the CUDA kernel,
which a CPU tensor takes, is held to the JAX kernel run in Pallas
interpret mode, as the JAX suite runs it (tests/test_kernels.py). Models
are numpy-seeded 3D pyramids (16³ from a base of 4, and 32³ from a base
of 8 with a second pyramid level; C=4, PE 4, H=64: the CUDA kernel's
width), methods 3 (eight G0 corners, triangular PE)
and 4 (four even-parity corners, sinusoidal PE). Tolerances as for the
2D decode (test_torch_decode_fused_v2.py): 2e-5 in fp32, 2e-3 with bf16
dot inputs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)
from jax.experimental.pallas import tpu as pltpu

from nic.core.quant import quant_range
from nic.grids import fastdecode as jfd
from nic.grids.pyramid import pyramid_levels, pyramid_mip_levels
from nic.kernels import decode_fused_3d as jdf
from nic_torch.grids import fastdecode as tfd
from nic_torch.io.convert import params_from_jax
from nic_torch.kernels import decode_fused_3d as tdf

SIZE, C, PE, HIDDEN = 16, 4, 4, 64
JAX_DTYPES = {"fp32": None, "bf16": jnp.bfloat16, "i16": "i16",
              "surgical": "surgical"}
TORCH_DTYPES = {"fp32": None, "bf16": torch.bfloat16, "i16": "i16",
                "surgical": "surgical"}
TOL = {"fp32": 2e-5, "bf16": 2e-3, "i16": 2e-3, "surgical": 2e-5}


def make_model3(seed, method, size=SIZE, no_mip=False):
    """Numpy 3D pyramid of a size³ volume (base size/4, 8-bit quantizer
    range) and MLP for ``method``; the same parameters for JAX and for the
    port, and the mip → level map."""
    rng = np.random.default_rng(seed)
    base = size // 4
    levels = 1 if no_mip else pyramid_levels(base)
    q_min, q_max = quant_range(8)
    fp = tuple(rng.uniform(q_min, q_max, (C,) + (base // 2**i + 1,) * 3)
               .astype(np.float32) for i in range(2 * levels))
    corners = 4 if method == 4 else 8
    dims = [C * (corners + 1) + 3 * PE + 1, HIDDEN, HIDDEN, 3]
    mlp = {}
    for i in range(3):
        bound = 2.0 / np.sqrt(dims[i])
        mlp[f"w{i + 1}"] = rng.uniform(-bound, bound, dims[i:i + 2]).astype(
            np.float32)
        mlp[f"b{i + 1}"] = rng.uniform(-bound, bound, dims[i + 1]).astype(
            np.float32)
    jfp = tuple(jnp.asarray(g) for g in fp)
    jmlp = {k: jnp.asarray(v) for k, v in mlp.items()}
    m2l = pyramid_mip_levels(size, base, no_mip)
    return (jfp, jmlp), params_from_jax(fp, mlp, device="cpu"), m2l


def _flags(method):
    return dict(use_tri_pe=method == 3, sparse_g0=method == 4)


@pytest.mark.parametrize("hidden", [16, 64])
@pytest.mark.parametrize("size", [16, 32, 64, 256])
def test_kernel_covers_3d_matches_jax(size, hidden):
    for no_mip in (False, True):
        m2l = pyramid_mip_levels(size, size // 4, no_mip)
        for mip in m2l:
            args = (mip, size, m2l, hidden)
            assert tdf.kernel_covers_3d(*args) == jdf.kernel_covers_3d(*args)


@pytest.mark.parametrize("method", [3, 4])
def test_fast_decode_3d_matches_jax(method):
    """The 3D fold of a 32³ model at every mip: e = −2, −1, 0 at level 0,
    then the thumbnails (e > 0, the step == 2 quirk at e = 1) and level
    1."""
    (jfp, jmlp), (tfp, tmlp), m2l = make_model3(60 + method, method, 32)
    for mip in m2l:
        kw = dict(image_size=32, mip_to_level=m2l, pe_channels=PE, ndim=3,
                  **_flags(method))
        want = np.asarray(jfd.fast_decode(jfp, jmlp, mip, **kw))
        with torch.inference_mode():
            got = tfd.fast_decode(tfp, tmlp, mip, **kw).numpy()
        assert got.shape == want.shape == (32 >> mip,) * 3 + (3,)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0,
                                   err_msg=f"mip {mip}")


@pytest.mark.parametrize("mode", list(JAX_DTYPES))
@pytest.mark.parametrize("method", [3, 4])
def test_prepare_3d_matches_jax(method, mode):
    """The frame and column stage's operands (int16 codes within one of
    JAX's, where the fp32 fold lands a value on the other side of a half
    step), the i16 scale and the geometry."""
    (jfp, jmlp), (tfp, tmlp), m2l = make_model3(70 + method, method)
    for mip in (0, 1, 2):
        kw = dict(image_size=SIZE, mip_to_level=m2l, pe_channels=PE,
                  **_flags(method))
        want = jdf._prepare_3d(jfp, jmlp, mip, dtype=JAX_DTYPES[mode],
                               block_rows=None, block_cols=None, **kw)
        got = tdf._prepare_3d(tfp, tmlp, mip, dtype=TORCH_DTYPES[mode], **kw)
        assert {k: want[-1][k] for k in got[-1]} == got[-1]
        names = ("pc", "c1v", "pe_u", "w2", "b2", "w3", "b3")
        for name, w, g in zip(names, want[:7], got[:7]):
            w = np.asarray(w)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), name
            bf = g.dtype == torch.bfloat16
            atol = 1 if g.dtype == torch.int16 else (2**-8 if bf else 2e-6)
            np.testing.assert_allclose(
                g.detach().float().numpy(), w.astype(np.float32), atol=atol,
                rtol=2**-8 if bf else 0, err_msg=name)
        if mode == "i16":
            assert float(got[7]) == pytest.approx(float(want[7]), rel=1e-6)
        else:
            assert got[7] is None and want[7] is None


@pytest.mark.parametrize("size,method,mip,mode,gelu", [
    (16, 3, 0, "fp32", "exact"), (16, 3, 1, "bf16", "poly"),
    (16, 3, 0, "i16", "tanherf"), (16, 4, 0, "fp32", "exact"),
    (16, 4, 0, "bf16", "exact"), (16, 4, 2, "i16", "exact"),
    (32, 3, 4, "fp32", "exact"), (32, 4, 1, "i16", "tanherf"),
])
def test_plain_kernel_matches_jax_kernel(size, method, mip, mode, gelu):
    """decode_volume_fused on the CPU (the kernel's plain version, no
    launch) against the JAX kernel in interpret mode; f = 4, 2, 1 and, at
    32³ mip 4, pyramid level 1."""
    (jfp, jmlp), (tfp, tmlp), m2l = make_model3(80 + mip, method, size)
    kw = dict(image_size=size, mip_to_level=m2l, pe_channels=PE, gelu=gelu,
              **_flags(method))
    assert tdf.kernel_covers_3d(mip, size, m2l, HIDDEN)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jdf.decode_volume_fused(
            jfp, jmlp, mip, dtype=JAX_DTYPES[mode], **kw))
    before = tdf.decode_kernel_3d.launches
    with torch.inference_mode():
        got = tdf.decode_volume_fused(tfp, tmlp, mip,
                                      dtype=TORCH_DTYPES[mode], **kw)
    assert tdf.decode_kernel_3d.launches == before  # the CPU runs no kernel
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[mode], rtol=0)


def test_uncovered_mip_and_surgical_decode_fp32():
    """A thumbnail mip (e > 0) goes to the fold, as in JAX; ``surgical`` is
    a 2D mode and decodes fp32 planes here."""
    (jfp, jmlp), (tfp, tmlp), m2l = make_model3(91, 3)
    kw = dict(image_size=SIZE, mip_to_level=m2l, pe_channels=PE)
    assert not tdf.kernel_covers_3d(3, SIZE, m2l, HIDDEN)
    with torch.inference_mode():
        got = tdf.decode_volume_fused(tfp, tmlp, 3, dtype="surgical", **kw)
        fold = tfd.fast_decode(tfp, tmlp, 3, ndim=3, **kw)
        torch.testing.assert_close(got, fold, rtol=0, atol=0)
        a = tdf.decode_volume_fused(tfp, tmlp, 1, dtype="surgical", **kw)
        b = tdf.decode_volume_fused(tfp, tmlp, 1, **kw)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    want = np.asarray(jfd.fast_decode(jfp, jmlp, 3, ndim=3, **kw))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def _prepared(mode="fp32", mip=0):
    _, (tfp, tmlp), m2l = make_model3(95, 3)
    with torch.inference_mode():
        return tdf._prepare_3d(tfp, tmlp, mip, image_size=SIZE,
                               mip_to_level=m2l, pe_channels=PE,
                               use_tri_pe=True, sparse_g0=False,
                               dtype=TORCH_DTYPES[mode])


@pytest.mark.parametrize("bad", ["frames", "rank", "contiguous", "f", "gelu"])
def test_kernel_wrapper_refuses(bad):
    pc, c1v, pe_u, w2, b2, w3, b3, scale, geom = _prepared()
    kw = dict(f=geom["f"], f1=geom["f1"], gelu="exact")
    if bad == "frames":
        c1v = c1v[:-1]
    elif bad == "rank":
        pc = pc[0]
    elif bad == "contiguous":
        pc = pc.transpose(0, 2).contiguous().transpose(0, 2)
    elif bad == "f":
        kw["f"] = 3
    else:
        kw["gelu"] = "relu"
    with pytest.raises(ValueError):
        tdf.decode_kernel_3d(pc, c1v, pe_u, w2, b2, w3, b3, scale, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32", "bf16", "i16"])
def test_cuda_kernel_matches_plain(mode):
    """K5 against its plain version on the card, one launch for the whole
    volume (chip_smoke.py holds it at 64³ and 256³)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    prep = _prepared(mode)
    pc, c1v, pe_u, w2, b2, w3, b3, scale, geom = (
        t.cuda() if isinstance(t, torch.Tensor) else t for t in prep)
    kw = dict(f=geom["f"], f1=geom["f1"], gelu="exact")
    before = tdf.decode_kernel_3d.launches
    got = tdf.decode_kernel_3d(pc, c1v, pe_u, w2, b2, w3, b3, scale, **kw)
    torch.cuda.synchronize()
    assert tdf.decode_kernel_3d.launches == before + 1
    want = tdf.decode_kernel_3d_plain(pc, c1v, pe_u, w2, b2, w3, b3, scale,
                                      **kw)
    assert float((got - want).abs().max()) <= TOL[mode]
