"""nic_torch.kernels.decode_fused_v3 (K4, the v3 decode's MLP tail) and
nic_torch.models.mlp.apply_mlp_tail against the JAX package.

JAX's ``mlp_tail`` and ``decode_image_fused_v3`` run once each in Pallas
interpret mode; the port runs the plain version of its CUDA kernel, which a
CPU tensor takes. Tolerance 1e-5, the JAX suite's for its v3 test: the two
differ in summation order and the erf (A&S 7.1.26 in both kernels). The
CUDA kernel is held to the plain version by the ``cuda``-marked test and by
``chip_smoke.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)
from jax.experimental.pallas import tpu as pltpu

from nic.grids.pyramid import pyramid_mip_levels
from nic.kernels import decode_fused_v3 as jv3
from nic.models.mlp import apply_mlp_tail as j_apply_mlp_tail
from nic_torch.grids.fastdecode import fast_decode
from nic_torch.kernels import decode_fused_v3 as tv3
from nic_torch.models.mlp import apply_mlp_tail
from test_torch_fastdecode import BASE, HIDDEN, PE, SIZE, both, make_model

M2L = pyramid_mip_levels(SIZE, BASE)


@pytest.fixture(scope="module")
def model():
    return both(*make_model(71))


def _acc(seed, shape):
    return np.random.default_rng(seed).normal(0, 1.5, shape).astype(
        np.float32)


def test_plain_tail_matches_jax_mlp_tail(model):
    (_, jmlp), (_, tmlp) = model
    acc = _acc(0, (32, 32, HIDDEN))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jv3.mlp_tail(jnp.asarray(acc), jmlp["w2"],
                                       jmlp["b2"], jmlp["w3"], jmlp["b3"]))
    w = [tmlp[k].detach() for k in ("w2", "b2", "w3", "b3")]
    before = tv3.mlp_tail.launches
    got = tv3.mlp_tail(torch.from_numpy(acc), *w)
    assert tv3.mlp_tail.launches == before  # the CPU runs no kernel
    assert got.shape == want.shape == (32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_decode_v3_matches_jax(model):
    (jfp, jmlp), (tfp, tmlp) = model
    kw = dict(image_size=SIZE, mip_to_level=M2L, pe_channels=PE,
              use_tri_pe=True)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jv3.decode_image_fused_v3(jfp, jmlp, 0, **kw))
    with torch.inference_mode():
        got = tv3.decode_image_fused_v3(tfp, tmlp, 0, **kw)
        fold = fast_decode(tfp, tmlp, 0, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), fold.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("matmul_dtype", [None, "bf16"])
def test_apply_mlp_tail_matches_jax(model, matmul_dtype):
    """The folded forward's tail, with and without bf16 dot inputs."""
    (_, jmlp), (_, tmlp) = model
    acc = _acc(1, (512, HIDDEN))
    want = np.asarray(j_apply_mlp_tail(
        jmlp, jnp.asarray(acc),
        matmul_dtype=None if matmul_dtype is None else jnp.bfloat16))
    with torch.inference_mode():
        got = apply_mlp_tail(
            tmlp, torch.from_numpy(acc),
            matmul_dtype=None if matmul_dtype is None else torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-5 if matmul_dtype is None else 2e-3,
                               rtol=0)


@pytest.mark.parametrize("bad", ["acc", "w3", "dtype", "contiguous"])
def test_tail_refuses(model, bad):
    _, (_, tmlp) = model
    acc = torch.from_numpy(_acc(2, (8, 8, HIDDEN)))
    w = [tmlp[k].detach() for k in ("w2", "b2", "w3", "b3")]
    if bad == "acc":
        acc = acc.reshape(64, HIDDEN)
    elif bad == "w3":
        w[2] = w[2][:, :2].contiguous()
    elif bad == "dtype":
        acc = acc.double()
    else:
        acc = acc.transpose(0, 1)
    with pytest.raises(ValueError):
        tv3.mlp_tail(acc, *w)


@pytest.mark.cuda
@pytest.mark.parametrize("acc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(model, acc_dtype, dot_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, (_, tmlp) = model
    acc = torch.from_numpy(_acc(3, (96, 80, HIDDEN))).to(acc_dtype).cuda()
    w = [tmlp[k].detach().to(dot_dtype).cuda() for k in ("w2", "w3")]
    b = [tmlp[k].detach().cuda() for k in ("b2", "b3")]
    args = (acc, w[0], b[0], w[1], b[1])
    before = tv3.mlp_tail.launches
    got = tv3.mlp_tail(*args, block=1024)
    torch.cuda.synchronize()
    assert tv3.mlp_tail.launches == before + 1
    want = tv3.mlp_tail_plain(*args)
    tol = 2e-5 if dot_dtype == torch.float32 else 2e-3
    assert float((got - want).abs().max()) <= tol
