"""nic_torch.kernels.decode_fused (K3, the v1 decode) against the JAX
package: its plain version against JAX's gather decode (``decoder_input``
+ ``apply_mlp``) at every mip of a 64², base-16, C = 4, PE 4 pyramid with
triangular and sinusoidal PE, and against ``nic.kernels.decode_fused``
itself in Pallas interpret mode at two mips (e = −2, and e = 1, the raw
G1 sum). Tolerance 2e-5, the JAX suite's for its own v1 test: the two
differ in summation order and the erf (A&S 7.1.26 against XLA's, 1.5e-7).
The CUDA kernel is held to the plain version by the ``cuda``-marked test
and by ``chip_smoke.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)
from jax.experimental.pallas import tpu as pltpu

from nic.grids.pyramid import pyramid_mip_levels
from nic.grids.sample import decoder_input as j_decoder_input
from nic.kernels import decode_fused as jv1
from nic.models.mlp import apply_mlp as j_apply_mlp
from nic_torch.config import CompressionConfig
from nic_torch.kernels import decode_fused as tv1
from test_torch_fastdecode import BASE, PE, SIZE, both, make_model

M2L = pyramid_mip_levels(SIZE, BASE)


@pytest.fixture(scope="module")
def model():
    return both(*make_model(61))


def _e(mip):
    return mip - (M2L[mip] + 1) * 2


def _port(model, mip, use_tri_pe, dtype=None):
    _, (tfp, tmlp) = model
    with torch.inference_mode():
        return tv1.decode_image_fused(
            tfp, tmlp, mip, image_size=SIZE, mip_to_level=M2L,
            pe_channels=PE, use_tri_pe=use_tri_pe, dtype=dtype)


@pytest.mark.parametrize("use_tri_pe", [True, False])
@pytest.mark.parametrize("mip", range(7))
def test_plain_matches_jax_gather_decode(model, mip, use_tri_pe):
    """Every mip: e from −2 to 2, the e == 1 quirk included."""
    (jfp, jmlp), _ = model
    n = SIZE >> mip
    x = j_decoder_input(jfp, M2L[mip], jnp.zeros((2,), jnp.int32),
                        2.0 ** _e(mip), n, pe_channels=PE, mip_level=mip,
                        ndim=2, use_tri_pe=use_tri_pe)
    want = np.asarray(j_apply_mlp(jmlp, x)).reshape(n, n, 3)
    before = tv1.decode_kernel_v1.launches
    got = _port(model, mip, use_tri_pe)
    assert tv1.decode_kernel_v1.launches == before  # the CPU runs no kernel
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("mip", [0, 3])
def test_plain_matches_jax_v1_kernel(model, mip):
    """JAX's v1 kernel in interpret mode at e = −2 and at e = 1."""
    assert _e(mip) == (-2 if mip == 0 else 1)
    (jfp, jmlp), _ = model
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jv1.decode_image_fused(
            jfp, jmlp, mip, image_size=SIZE, mip_to_level=M2L,
            pe_channels=PE, use_tri_pe=True))
    got = _port(model, mip, True).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_fused_rows_per_block_matches_jax():
    for size in (1, 2, 4, 8, 16, 64, 100, 512, 2048, 4096):
        for e in range(-7, 4):
            assert (tv1.fused_rows_per_block(size, e, 12)
                    == jv1.fused_rows_per_block(size, e, 12)), (size, e)


def test_cfg_and_bf16(model):
    """``cfg=`` resolves the geometry as the explicit arguments do; bf16
    grids and dots stay within an 8-bit step of fp32 (the u8 envelope of
    the bf16 decode modes)."""
    cfg = CompressionConfig(image_size=SIZE, pe_channels=PE, tf_no_mip=False,
                            device="cpu")
    assert cfg.feature_pyramid_size == BASE
    _, (tfp, tmlp) = model
    with torch.inference_mode():
        got = tv1.decode_image_fused(tfp, tmlp, 1, cfg=cfg)
    want = _port(model, 1, True)
    assert torch.equal(got, want)
    bf16 = _port(model, 1, True, dtype=torch.bfloat16)
    assert bf16.dtype == torch.float32
    assert float((bf16 - want).abs().max()) < 8 / 255


@pytest.mark.parametrize("bad", ["dtype", "shape", "reach", "contiguous"])
def test_kernel_wrapper_refuses(model, bad):
    _, (tfp, tmlp) = model
    g0, g1 = tfp[0], tfp[1]
    w = [tmlp[k].detach() for k in ("w1", "b1", "w2", "b2", "w3", "b3")]
    kw = dict(e=-2, n=SIZE, pe_channels=PE, use_tri_pe=True, mip_level=0,
              rows=8)
    if bad == "dtype":
        g1 = g1.to(torch.bfloat16)
    elif bad == "shape":
        w[0] = w[0][:-1]
    elif bad == "reach":
        kw["n"] = 2 * SIZE
    else:
        g0 = g0.transpose(1, 2)
    with pytest.raises(ValueError):
        tv1.decode_kernel_v1(g0, g1, *w, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_cuda_kernel_matches_plain(model, dtype):
    """The hand-written kernel against its plain version on the card at
    every mip, both PE families (tolerances as in chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, (tfp, tmlp) = model
    fp = tuple(g.detach().cuda() for g in tfp)
    mlp = {k: tmlp[k].detach().cuda() for k in ("w1", "b1", "w2", "b2",
                                                   "w3", "b3")}
    tol = 2e-5 if dtype is None else 2e-3
    for mip in range(7):
        for tri in (True, False):
            kw = dict(image_size=SIZE, mip_to_level=M2L, pe_channels=PE,
                      use_tri_pe=tri, dtype=dtype)
            before = tv1.decode_kernel_v1.launches
            got = tv1.decode_image_fused(fp, mlp, mip, **kw)
            torch.cuda.synchronize()
            assert tv1.decode_kernel_v1.launches == before + 1
            want = tv1.decode_image_fused(
                tuple(g.cpu() for g in fp),
                {k: v.cpu() for k, v in mlp.items()}, mip, **kw)
            assert float((got.cpu() - want).abs().max()) <= tol, (mip, tri)
