"""Run logs (port of ``nic.obs.log``): a console + file logger with timed
spans, versioned file names, a scalar writer with the reference's tags
(tensorboardX where importable, always mirrored to CSV) and tensor
audits."""

from __future__ import annotations

import contextlib
import csv
import glob
import math
import os
import re
import time

__all__ = ["make_filename_by_seq", "RunLog", "ScalarWriter",
           "log_safe_statistics"]


def make_filename_by_seq(dirname: str, filename: str,
                         seq_digit: int = 3) -> str:
    """Next free ``{dirname}/{stem}_NNN{ext}``."""
    os.makedirs(dirname, exist_ok=True)
    stem, ext = os.path.splitext(filename)
    prog = re.compile(rf"{re.escape(stem)}_([0-9]+){re.escape(ext)}$")
    max_seq = -1
    for f in glob.glob(os.path.join(dirname, f"{stem}_*{ext}")):
        m = prog.match(os.path.basename(f))
        if m:
            max_seq = max(max_seq, int(m.group(1)))
    return os.path.join(dirname, f"{stem}_{max_seq + 1:0{seq_digit}}{ext}")


class RunLog:
    """Print to the console and append to a per-run text log; with
    ``echo=False`` and no path it is silent (a mesh rank other than 0)."""

    def __init__(self, path: str | None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def __call__(self, msg) -> None:
        if self.echo:
            print(msg, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                print(msg, file=f)

    @contextlib.contextmanager
    def span(self, label: str):
        """Timed span; logs ``{label}: {seconds}`` on exit."""
        start = time.perf_counter()
        yield
        self(f"{label}: {time.perf_counter() - start}")


class ScalarWriter:
    """Step scalars: tensorboardX (if importable) plus a CSV mirror."""

    def __init__(self, logdir: str | None, csv_path: str | None = None):
        self._tb = None
        if logdir:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(logdir)
            except Exception:
                self._tb = None
        self._csv_file = None
        self._csv = None
        if csv_path:
            os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
            self._csv_file = open(csv_path, "w", newline="")
            self._csv = csv.writer(self._csv_file)
            self._csv.writerow(["tag", "step", "value"])

    def add_scalar(self, tag: str, value, step: int) -> None:
        value = float(value)
        # TensorBoard refuses non-finite scalars; the CSV keeps them
        if self._tb is not None and math.isfinite(value):
            self._tb.add_scalar(tag, value, step)
        if self._csv is not None:
            self._csv.writerow([tag, step, value])

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._csv_file is not None:
            self._csv_file.close()


def log_safe_statistics(x, log: RunLog) -> dict:
    """Audit a tensor and log the reference-style lines."""
    from nic_torch.core.metrics import safe_statistics

    stats = safe_statistics(x)
    if stats["num_valid"] == 0:
        log("No valid numbers in the tensor.")
    else:
        log(f"Max: {stats['max']}")
        log(f"Min: {stats['min']}")
        log(f"Mean: {stats['mean']}")
        log(f"Variance: {stats['var']}")
    log(f"Contains NaN: {stats['has_nan']}")
    log(f"Contains Inf: {stats['has_inf']}")
    return stats
