"""The port's decoder-only runtime on the committed trained artifacts
(tests/fixtures, made by scripts/make_torch_port_fixture.py: the 512²
flagship and the misty 64³ method-3 volume), held to the JAX fold's
decode of the same artifact."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nic_torch.cli import decode as tcli
from nic_torch.core.metrics import psnr
from nic_torch.data.assets import load_volume, read_clip, save_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
ART = os.path.join(FIXTURES, "ntc_sancho512_fp8.npz")
ART3 = os.path.join(FIXTURES, "ntc_misty64_m3_fp8.npz")


@pytest.fixture(scope="module")
def ref():
    with np.load(os.path.join(FIXTURES, "ntc_sancho512_fp8_ref.npz")) as z:
        return dict(z)


def _u8(rec):
    return np.floor(rec * 255.0 + 0.5).astype(np.uint8)


@pytest.mark.parametrize("mip", range(10))
def test_decode_matches_jax_fold(ref, mip):
    rec = tcli.run([ART, "--mip", str(mip), "--device", "cpu"])
    u8 = _u8(rec)
    want = ref[f"dec{mip}"]
    assert u8.shape == want.shape == (512 >> mip, 512 >> mip, 3)
    assert np.abs(u8.astype(int) - want.astype(int)).max() <= 1
    got_psnr = float(psnr(torch.from_numpy(ref[f"orig{mip}"]).float(),
                          torch.from_numpy(u8).float()))
    assert abs(got_psnr - ref["psnr"][mip]) <= 0.01


@pytest.fixture(scope="module")
def ref3():
    with np.load(os.path.join(FIXTURES, "ntc_misty64_m3_fp8_ref.npz")) as z:
        return dict(z)


@pytest.mark.parametrize("mip", range(7))
def test_decode_3d_matches_jax_fold(ref3, mip):
    """The misty 64³ method-3 artifact at every mip: within 1 u8 LSB of the
    JAX fold, the per-mip PSNR against the clip at stride 2^mip within
    0.01 dB of the fold's."""
    rec = tcli.run([ART3, "--mip", str(mip), "--device", "cpu"])
    u8 = _u8(rec)
    want = ref3[f"dec{mip}"]
    assert u8.shape == want.shape == (64 >> mip,) * 3 + (3,)
    assert np.abs(u8.astype(int) - want.astype(int)).max() <= 1
    clip = load_volume("data/misty_64_64.avi") / 256.0 * 255.0
    s = 2**mip
    got_psnr = float(psnr(torch.from_numpy(clip[::s, ::s, ::s]),
                          torch.from_numpy(u8).double()))
    assert abs(got_psnr - ref3["psnr"][mip]) <= 0.01


def test_3d_avi_written_reads_back(tmp_path, capsys):
    out = str(tmp_path / "v.avi")
    rec = tcli.run([ART3, "--mip", "1", "--device", "cpu", "--dtype",
                    "surgical", "--out", out])
    assert "applies to the cuda backend only" in capsys.readouterr().out
    np.testing.assert_array_equal(read_clip(out),
                                  (rec * 255 + 0.5).astype(np.uint8))


def test_png_written_reads_back(tmp_path, capsys):
    from PIL import Image

    out = str(tmp_path / "d.png")
    rec = tcli.run([ART, "--mip", "2", "--device", "cpu", "--dtype", "bf16",
                    "--out", out])
    assert "applies to the cuda backend only" in capsys.readouterr().out
    np.testing.assert_array_equal(np.asarray(Image.open(out)),
                                  (rec * 255 + 0.5).astype(np.uint8))
    rng = np.random.default_rng(0)
    for shape in ((7, 5, 3), (1, 1, 3), (300, 2, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        save_png(img, str(tmp_path / "x.png"))
        np.testing.assert_array_equal(
            np.asarray(Image.open(str(tmp_path / "x.png"))), img)
    with pytest.raises(ValueError):
        save_png(img[:, :, 0], str(tmp_path / "y.png"))


def test_backend_xla_matches_jax_cli(capsys):
    """``--backend xla``, the gather decode at full size, against the JAX
    runtime's own ``--backend xla`` on the same artifact (the two differ in
    summation order and the erf: atol 2e-5)."""
    from nic.cli import decode as jcli

    want = jcli.run([ART, "--mip", "1", "--backend", "xla"])
    rec = tcli.run([ART, "--mip", "1", "--device", "cpu", "--backend",
                    "xla"])
    assert "backend=xla" in capsys.readouterr().out
    assert rec.shape == want.shape == (256, 256, 3)
    np.testing.assert_allclose(rec, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("argv", [
    # --devices splits the kernel decode, which the fold does not run
    ["--device", "cpu", "--devices", "2", "--backend", "xla"],
    ["--device", "cpu", "--backend", "cuda"],
])
def test_refusals(argv, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.run([ART, *argv])
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert "has no split" in err if "--devices" in argv else "cuda" in err


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        tcli.run([ART])  # --device defaults to cuda: no CPU fallback


def test_port_imports_no_jax_and_no_nic():
    code = ("import sys, nic_torch, nic_torch.cli.decode, "
            "nic_torch.kernels.decode_fused_v2, nic_torch.io.convert, "
            "nic_torch.config, nic_torch.train.ntc, "
            "nic_torch.kernels.train_fused_ff, "
            "nic_torch.kernels.train_fused_ff3, "
            "nic_torch.kernels.decode_fused_3d, nic_torch.data.assets, "
            "nic_torch.kernels.decode_fused, nic_torch.kernels.decode_fused_v3, "
            "nic_torch.grids.sample, nic_torch.cli.image_compression, "
            "nic_torch.cli.eval_rd, nic_torch.obs.trace, "
            "nic_torch.cli.hyperprior_comp, nic_torch.cli.hyperprior_codec, "
            "nic_torch.train.hyperprior, nic_torch.models.hyperprior, "
            "nic_torch.kernels.hs_bins, nic_torch.io.bitstream, "
            "nic_torch.io.entropy, nic_torch.io.artifacts, nic_torch.native\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'nic'))\n"
            "print(','.join(bad)); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)


def test_port_sources_name_no_jax_and_no_nic():
    """No source of the port, and not chip_smoke.py, imports jax or the
    JAX package, by a grep of every import statement."""
    import re

    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|nic)(\.|\s|$)",
                         re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, files in os.walk(
            os.path.join(ROOT, "nic_torch")) for f in files
        if f.endswith(".py")]
    assert len(paths) > 30
    bad = {p: m.group(0).strip() for p in paths
           for m in [pattern.search(open(p).read())] if m}
    assert not bad, bad
