"""Profiling and tracing utilities (port of ``nic.obs.trace``).

- :class:`SpanTimer` — named wall-clock spans accumulated into a report;
- :func:`profile_trace` — a ``torch.profiler`` context that writes a trace
  of the host and, where a CUDA device is present, of the device's
  kernels into a directory, as a ``*.pt.trace.json`` file that TensorBoard
  (its PyTorch profiler plugin) and Chrome's ``chrome://tracing`` or
  Perfetto load;
- :func:`annotate` — a named range on that timeline
  (``torch.profiler.record_function``);
- :func:`enable_nan_checks` — autograd's anomaly mode.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

__all__ = ["SpanTimer", "profile_trace", "annotate", "enable_nan_checks"]


class SpanTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict[str, dict]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_s": self.totals[k] / max(1, self.counts[k])}
            for k in self.totals
        }


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace the enclosed code with ``torch.profiler`` (CPU activity, and
    CUDA activity when a CUDA device is present) and write the trace under
    ``logdir`` as ``<host>_<pid>.<ms>.pt.trace.json``. Pending device work
    is waited for before the trace stops, so the enclosed code's kernels
    are in it. Yields the profiler (``key_averages()`` and the like)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        try:
            yield prof
        finally:
            if cuda and torch.cuda.is_initialized():
                torch.cuda.synchronize()


def annotate(name: str):
    """A named host range that appears on the profiler's timeline (a
    context manager, ``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def enable_nan_checks(enable: bool = True) -> None:
    """Turn autograd's anomaly mode on or off for the whole process. It
    catches a NaN produced in a backward pass: the backward function that
    returned it raises, naming the forward operation it came from. It
    does not look at forward values, nor at code outside autograd (the
    CUDA kernels' own outputs, a decode under ``no_grad``), where the JAX
    package's ``jax_debug_nans`` checks every jitted operation's output."""
    torch.autograd.set_detect_anomaly(enable)
