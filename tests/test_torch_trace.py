"""nic_torch.obs.trace, the counterpart of nic.obs.trace: span timers,
a torch.profiler trace written to a directory, annotations on it and
autograd's NaN checks (the port's side of tests/test_trace_resume.py's
trace tests); and the training CLI's PROFILE_DIR on the CPU. The
profiler runs in a child process, so its threads never share a process
with the JAX tests that follow in the same worker."""

import glob
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)

from nic_torch.obs.trace import SpanTimer, enable_nan_checks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child(code: str) -> None:
    # one torch thread, as in this process (tests/torch_threads.py)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])


def test_span_timer():
    t = SpanTimer()
    with t.span("a"):
        pass
    with t.span("a"):
        pass
    with t.span("b"):
        pass
    rep = t.report()
    assert rep["a"]["count"] == 2 and rep["b"]["count"] == 1
    assert rep["a"]["total_s"] >= 0
    assert set(rep["a"]) == {"total_s", "count", "mean_s"}


def _events(directory):
    (path,) = glob.glob(os.path.join(directory, "*.pt.trace.json"))
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def test_profile_trace_writes_files(tmp_path):
    d = str(tmp_path / "trace")
    _child(f"""
        import torch
        from nic_torch.obs.trace import annotate, profile_trace

        with profile_trace({d!r}) as prof:
            with annotate("nic_span"):
                torch.ones(128, 128) @ torch.ones(128, 128)
        assert any(a.key == "aten::mm" for a in prof.key_averages())
        """)
    files = glob.glob(os.path.join(d, "**", "*"), recursive=True)
    assert any(os.path.isfile(f) for f in files)
    names = {e.get("name") for e in _events(d)}
    assert "nic_span" in names and "aten::mm" in names


def test_nan_checks_toggle():
    x = torch.tensor([0.0], requires_grad=True)
    enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(x) * 0.0).sum().backward()
    finally:
        enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    (torch.sqrt(x) * 0.0).sum().backward()  # off: the NaN passes unseen
    assert torch.isnan(x.grad).all()


def test_cli_profile_dir_traces_the_second_chunk(tmp_path):
    """PROFILE_DIR traces exactly the second training chunk (10 steps of
    INTERVAL_PRINT=10) and the log line names the directory; a run of one
    chunk writes no trace, as in JAX."""
    args = ["DEVICE=cpu", "IMAGE_SIZE=32", "CROP_MIP_LEVEL=4",
            "INTERVAL_PRINT=10"]
    prof, one = str(tmp_path / "prof"), str(tmp_path / "one")
    _child(f"""
        from nic_torch.cli import image_compression as tcli

        tcli.run({args!r} + ["NUM_EPOCHS=20", "PROFILE_DIR={prof}",
                             "OUTPUT_ROOT={tmp_path / 'a'}"])
        tcli.run({args!r} + ["NUM_EPOCHS=10", "PROFILE_DIR={one}",
                             "OUTPUT_ROOT={tmp_path / 'b'}"])
        """)
    steps = [e for e in _events(prof)
             if e.get("name", "").startswith("aten::randint")]
    assert len(steps) == 10  # one crop draw per traced step
    (log,) = glob.glob(str(tmp_path / "a" / "printlog" / "*.txt"))
    with open(log) as fh:
        assert f"torch.profiler trace (10 steps) → {prof}" in fh.read()
    assert not os.path.exists(one)
