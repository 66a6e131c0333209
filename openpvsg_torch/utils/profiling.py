"""Timing and tracing: the port of ``openpvsg_tpu/utils/profiling.py``.

``Timer`` is the reference's wall-clock fps timer (reference:
models/unitrack/utils/meter.py:1-48), ``StageTimer`` a named per-stage
accumulator, both copies of the JAX package's. ``trace(log_dir)`` wraps
``torch.profiler`` where the JAX package wraps ``jax.profiler``: it records
the CPU and, when there is one, the CUDA activity of the block and writes
a Chrome trace (``trace.json``, which chrome://tracing and Perfetto open)
into ``log_dir``; None makes it a no-op.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class Timer:
    """Running-average wall-clock timer (reference Timer surface:
    tic/toc/average_time)."""

    def __init__(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff

    def clear(self):
        self.__init__()


class StageTimer:
    """Named per-stage accumulator for pipeline profiling."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"total_s": self.totals[name], "calls": self.counts[name],
                   "mean_s": self.totals[name] / max(self.counts[name], 1)}
            for name in self.totals
        }

    def report(self) -> str:
        return " | ".join(
            f"{k}: {v['total_s']:.2f}s ({v['calls']}x)"
            for k, v in self.summary().items())


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` into
    ``log_dir/trace.json``. No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
