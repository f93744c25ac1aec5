"""nic_torch.io against nic.io.artifacts: an artifact written by either
package loads in the other to identical arrays, and the payload bit
counts agree."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)

from nic.core.quant import quantize
from nic.io import artifacts as jart
from nic_torch.io import artifacts as tart
from nic_torch.io.convert import params_from_jax, params_to_jax
from test_torch_decode_fused_3d import make_model3
from test_torch_fastdecode import make_model

META = {"save_name": "t", "config": {"image_size": 64, "pe_channels": 4}}


def _quantized_model(bits, seed=61):
    fp, mlp = make_model(seed)
    fp = tuple(np.asarray(quantize(jnp.asarray(g), bits)) for g in fp)
    return fp, mlp


def _assert_same(jax_loaded, torch_loaded):
    jmlp, jfp, jmeta = jax_loaded
    tmlp, tfp, tmeta = torch_loaded
    assert jmeta == tmeta
    assert len(jfp) == len(tfp)
    for jg, tg in zip(jfp, tfp):
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    for k in ("w1", "b1", "w2", "b2", "w3", "b3"):
        np.testing.assert_array_equal(tmlp[k].detach().numpy(),
                                      np.asarray(jmlp[k]))


@pytest.mark.parametrize("store", [32, 16])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_jax_artifact_loads_in_torch(tmp_path, bits, store):
    fp, mlp = _quantized_model(bits)
    path = str(tmp_path / "jax.npz")
    jbits = jart.save_compressed(path, {k: jnp.asarray(v) for k, v in
                                        mlp.items()},
                                 tuple(jnp.asarray(g) for g in fp), bits,
                                 META, mlp_store_bits=store)
    assert tart.compressed_num_bits(path) == jart.compressed_num_bits(path)
    assert tart.compressed_num_bits(path) == jbits
    _assert_same(jart.load_compressed(path),
                 tart.load_compressed(path, device="cpu"))


@pytest.mark.parametrize("store", [32, 16])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_torch_artifact_loads_in_jax(tmp_path, bits, store):
    fp, mlp = _quantized_model(bits)
    tfp, tmlp = params_from_jax(fp, mlp, device="cpu")
    path = str(tmp_path / "torch.npz")
    tbits = tart.save_compressed(path, tmlp, tfp, bits, META,
                                 mlp_store_bits=store)
    assert jart.compressed_num_bits(path) == tbits
    loaded = tart.load_compressed(path, device="cpu")
    _assert_same(jart.load_compressed(path), loaded)
    # the grid codes survive the round trip exactly
    for g, want in zip(loaded[1], fp):
        np.testing.assert_array_equal(g.numpy(), want)
    # the same parameters written by JAX give the same bytes
    jpath = str(tmp_path / "jax.npz")
    jart.save_compressed(jpath, mlp, tuple(jnp.asarray(g) for g in fp), bits,
                         META, mlp_store_bits=store)
    with np.load(path) as zt, np.load(jpath) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for key in zt.files:
            np.testing.assert_array_equal(zt[key], zj[key], err_msg=key)


@pytest.mark.parametrize("method", [3, 4])
def test_3d_artifact_crosses_both_ways(tmp_path, method):
    """A 3D pyramid ([C, s, s, s] grids, methods 3 and 4): JAX's artifact
    loads in the port and the port's in JAX to identical arrays, and both
    write the same bytes."""
    (jfp, jmlp), _, _ = make_model3(90 + method, method)
    jfp = tuple(quantize(g, 8) for g in jfp)
    meta = {"save_name": "v", "config": {
        "image_size": 16, "pe_channels": 4, "image_dimension": 3,
        "compression_method": method, "tf_no_mip": False}}
    jpath = str(tmp_path / "jax.npz")
    jbits = jart.save_compressed(jpath, jmlp, jfp, 8, meta)
    loaded = tart.load_compressed(jpath, device="cpu")
    assert loaded[1][0].dim() == 4
    _assert_same(jart.load_compressed(jpath), loaded)
    assert tart.compressed_num_bits(jpath) == jbits
    tpath = str(tmp_path / "torch.npz")
    assert tart.save_compressed(tpath, loaded[0], loaded[1], 8, meta) == jbits
    _assert_same(jart.load_compressed(tpath),
                 tart.load_compressed(tpath, device="cpu"))
    with np.load(tpath) as zt, np.load(jpath) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for key in zt.files:
            np.testing.assert_array_equal(zt[key], zj[key], err_msg=key)


def test_params_round_trip():
    fp, mlp = make_model(71)
    tfp, tmlp = params_from_jax(fp, mlp, device="cpu")
    assert tmlp.w1.shape == mlp["w1"].shape  # [in, out], not transposed
    assert not any(p.requires_grad for p in tmlp.parameters())
    back_fp, back_mlp = params_to_jax(tfp, tmlp)
    for a, b in zip(back_fp, fp):
        np.testing.assert_array_equal(a, b)
    for k, v in mlp.items():
        np.testing.assert_array_equal(back_mlp[k], v)
    x = np.random.default_rng(0).normal(size=(5, mlp["w1"].shape[0]))
    from nic.models.mlp import apply_mlp

    want = np.asarray(apply_mlp({k: jnp.asarray(v) for k, v in mlp.items()},
                                jnp.asarray(x, jnp.float32)))
    got = tmlp(torch.from_numpy(x.astype(np.float32))).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def _entropy_pair(tmp_path, fp, mlp, bits):
    """The same codes saved entropy-coded by JAX and by the port."""
    tfp, tmlp = params_from_jax(fp, mlp, device="cpu")
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tbits = tart.save_compressed(tpath, tmlp, tfp, bits, META,
                                 entropy_coded=True)
    jbits = jart.save_compressed(jpath, {k: jnp.asarray(v) for k, v in
                                         mlp.items()},
                                 tuple(jnp.asarray(g) for g in fp), bits,
                                 META, entropy_coded=True)
    return tpath, jpath, tbits, jbits


def _assert_entropy_pair(tpath, jpath, tbits, jbits):
    """Grid blobs and histograms byte-identical, the same rans_format, each
    package loads the other's artifact, and the bit counts agree."""
    with np.load(tpath) as t, np.load(jpath) as j:
        for key in j.files:
            if key.startswith(("grid", "hist")):
                np.testing.assert_array_equal(t[key], j[key])
                assert t[key].dtype == j[key].dtype
        import json

        tmeta = json.loads(bytes(t["__meta__"]).decode())
        jmeta = json.loads(bytes(j["__meta__"]).decode())
    assert tmeta == jmeta and tmeta["entropy_coded"]
    assert tbits == jbits
    for path in (tpath, jpath):
        assert tart.compressed_num_bits(path) == jart.compressed_num_bits(
            path) == tbits
    _assert_same(jart.load_compressed(tpath),
                 tart.load_compressed(jpath, device="cpu"))
    _assert_same(jart.load_compressed(jpath),
                 tart.load_compressed(tpath, device="cpu"))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_entropy_coded_interchanges_with_jax(tmp_path, bits):
    """ENTROPY_CODE_GRIDS artifacts (each grid rANS-coded against its own
    histogram) are the JAX package's bytes, both ways."""
    fp, mlp = _quantized_model(bits)
    tpath, *rest = _entropy_pair(tmp_path, fp, mlp, bits)
    _assert_entropy_pair(tpath, *rest)
    with np.load(tpath) as t:
        assert b"NR2" in {bytes(t[k][:3]) for k in t.files
                          if k.startswith("grid")}


def test_entropy_coded_trained_fixture_interchanges_with_jax(tmp_path):
    """The trained sancho fixture's codes entropy-coded by either package
    (its grids take stream format 3; the small models' above, format
    2)."""
    import os

    fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                           "ntc_sancho512_fp8.npz")
    mlp, fp, meta = jart.load_compressed(fixture)
    fp = tuple(np.asarray(g) for g in fp)
    mlp = {k: np.asarray(v) for k, v in mlp.items()}
    tpath, jpath, tbits, jbits = _entropy_pair(tmp_path, fp, mlp,
                                               meta["fp_bits"])
    _assert_entropy_pair(tpath, jpath, tbits, jbits)
    with np.load(tpath) as t:
        formats = {bytes(t[k][:3]) for k in t.files if k.startswith("grid")}
    assert formats == {b"NR3"}
