"""nic_torch's rANS coder and CDF tables against nic's: the port's
``nic_torch.native`` (its own build of ``rans.cpp``) writes the bytes of
``nic.native.rans_encode`` and of the pure-Python coders, in stream
formats 2 and 3 across the 16384-symbol threshold, and each decodes the
other's streams; legacy format 1 still reads."""

import numpy as np
import pytest

from nic.io import entropy as jec
from nic import native as jnative
from nic_torch import native as tnative
from nic_torch.io import entropy as tec


def _stream(n: int, seed: int):
    """n symbols of a Gaussian-table source: bins over the 64 scale rows,
    alphabet ±a."""
    rng = np.random.default_rng(seed)
    a = 12
    bins = rng.integers(0, tec.NUM_SCALE_BINS, n).astype(np.int32)
    sigma = tec.scale_table()[bins]
    sym = np.clip(np.round(rng.normal(0, sigma)), -a, a).astype(np.int32) + a
    return sym, bins, tec.gaussian_cdf_table(a)


def test_tables_match_jax():
    for a in (1, 7, 40):
        np.testing.assert_array_equal(tec.gaussian_cdf_table(a),
                                      jec.gaussian_cdf_table(a))
    rng = np.random.default_rng(3)
    mu, log_s = rng.normal(0, 1, 16), rng.normal(0, 0.5, 16)
    np.testing.assert_array_equal(tec.logistic_cdf_table(mu, log_s, 9),
                                  jec.logistic_cdf_table(mu, log_s, 9))
    for pmf in (rng.uniform(0, 1, 256), np.bincount(
            rng.integers(0, 20, 999), minlength=256).astype(float)):
        np.testing.assert_array_equal(tec.quantize_pmf(pmf),
                                      jec.quantize_pmf(pmf))
    s = np.exp(rng.uniform(-4, 5, 1000))
    np.testing.assert_array_equal(tec.scale_bin_indices(s),
                                  jec.scale_bin_indices(s))


@pytest.mark.parametrize("n", [1000, 16383, 16384, 40000])
def test_rans_bytes_match_jax_and_python(n):
    """Format 2 (8 lanes) below 16384 symbols, format 3 at and above: the
    same bytes as JAX's native coder and as the pure-Python coders."""
    sym, bins, cdf = _stream(n, seed=n)
    got = tnative.rans_encode(sym, bins, cdf)
    assert got == jnative.rans_encode(sym, bins, cdf)
    if n >= 16384:
        assert got[:4] == b"NR3\x01"
        assert got[4:] == tec.rans_encode_ilv3_py(sym, bins, cdf)
    else:
        import struct

        assert got[:4] == b"NR2\x01"
        payload, lens = tec.rans_encode_ilv_py(sym, bins, cdf)
        assert got == (b"NR2\x01" + struct.pack("<B8I", 8, *lens) + payload)
    np.testing.assert_array_equal(tnative.rans_decode(got, bins, cdf), sym)
    np.testing.assert_array_equal(jnative.rans_decode(got, bins, cdf), sym)


@pytest.mark.parametrize("n", [300, 20000])
def test_decodes_jax_streams(n):
    """JAX's streams (its native coder's and its pure-Python format-2
    coder's) decode in the port."""
    import struct

    sym, bins, cdf = _stream(n, seed=7 + n)
    np.testing.assert_array_equal(
        tnative.rans_decode(jnative.rans_encode(sym, bins, cdf), bins, cdf),
        sym)
    payload, lens = jec.rans_encode_ilv_py(sym, bins, cdf)
    py2 = b"NR2\x01" + struct.pack("<B8I", 8, *lens) + payload
    np.testing.assert_array_equal(tnative.rans_decode(py2, bins, cdf), sym)
    np.testing.assert_array_equal(
        tec.rans_decode_ilv_py(payload, lens, bins, cdf), sym)


def test_legacy_format1_reads():
    """A headerless format-1 stream (old entropy-coded artifacts) decodes
    with legacy=True and by default; legacy=False refuses it."""
    sym, bins, cdf = _stream(2000, seed=5)
    old = jec.rans_encode_py(sym, bins, cdf)
    np.testing.assert_array_equal(
        tnative.rans_decode(old, bins, cdf, legacy=True), sym)
    np.testing.assert_array_equal(tnative.rans_decode(old, bins, cdf), sym)
    np.testing.assert_array_equal(tec.rans_decode_py(old, bins, cdf), sym)
    with pytest.raises(ValueError, match="header"):
        tnative.rans_decode(old, bins, cdf, legacy=False)


def test_symbol_outside_its_row_raises():
    sym, bins, cdf = _stream(100, seed=9)
    sym[5] = cdf.shape[1]  # past the alphabet
    with pytest.raises(ValueError, match="out of CDF range"):
        tnative.rans_encode(sym, bins, cdf)


def test_built_library_and_decode_path():
    """The library is built under build/nic_torch/<key>/ and names the
    format-3 decode path of this host."""
    lib = tnative.load()
    assert lib is tnative.load()
    assert tnative.decode_path() in ("avx512", "scalar")
    assert (tnative.BUILD_ROOT / tnative._key() / tnative.LIB_NAME).exists()


def _code(path: str) -> str:
    """A source's code without its comments and docstrings: the text of a
    C++ file below its leading comment block, the AST of a Python module
    with docstrings dropped and ``__all__`` left out."""
    import ast
    import os

    full = os.path.join(os.path.dirname(os.path.dirname(__file__)), path)
    with open(full, encoding="utf-8") as fh:
        text = fh.read()
    if not path.endswith(".py"):
        lines = text.splitlines(keepends=True)
        while lines and lines[0].startswith("//"):
            lines.pop(0)
        return "".join(lines)
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body.pop(0)
    tree.body = [n for n in tree.body if not (
        isinstance(n, ast.Assign)
        and any(getattr(t, "id", None) == "__all__" for t in n.targets))]
    return ast.dump(tree)


@pytest.mark.parametrize("port, jax_src", [
    ("nic_torch/native/rans.cpp", "nic/native/rans.cpp"),
    ("nic_torch/io/entropy.py", "nic/io/entropy.py")])
def test_copies_track_the_jax_sources(port, jax_src):
    """The port's copies of the coder and the CDF tables keep the JAX
    package's code: an edit to one copy alone fails here, whether or not
    it changes bytes the other tests cover."""
    assert _code(port) == _code(jax_src)
