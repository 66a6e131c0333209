"""Reading a ``torch.profiler`` trace: device intervals and their union, the
host's kernel launches, device time by kernel name, and idle gaps labelled by
what the host was doing.

Device time is the union of the intervals in which any operation (a kernel,
a copy or a fill) ran on a device, so two streams that overlap (NCCL beside
compute, a copy beside a kernel) count once; a sum of kernel times would
count them twice.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LAUNCH_NAMES = ("LaunchKernel", "GraphLaunch")
SPAN_PREFIX = "bench."


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of ``merged`` inside [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def gaps(merged: Sequence[Tuple[float, float]], lo: float, hi: float):
    """[(start, end)] of [lo, hi] not covered by ``merged``."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


class Trace:
    """The events of one profiled window, in seconds on the profiler's
    clock. ``device_ops`` [(name, start, end, device)]; ``host_ops`` the
    top-level host operations [(name, start, end)]; ``spans`` the
    benchmark's own spans [(name, start, end)]; ``launches`` the number of
    kernel launches the host issued; ``window`` (start, end) of the span
    named ``window``."""

    def __init__(self, device_ops, host_ops, spans, launches: int, window):
        self.device_ops = device_ops
        self.host_ops = host_ops
        self.spans = spans
        self.launches = launches
        self.window = window

    @classmethod
    def from_events(cls, events, window: str = "window") -> "Trace":
        """From the profiler's raw events (``prof.profiler.kineto_results
        .events()``): a benchmark span (``bench.<name>``) on the host, and
        its image on the device's timeline, which is no operation; another
        event on a CUDA device is a device operation (kernel, copy or fill);
        on the host, a launch call or a host operation."""
        dev, cpu, spans, launches = [], [], [], 0
        for e in events:
            name = e.name()
            s = e.start_ns() * 1e-9
            end = s + e.duration_ns() * 1e-9
            on_device = "CUDA" in str(e.device_type())
            if name.startswith(SPAN_PREFIX):
                if not on_device:
                    spans.append((name[len(SPAN_PREFIX):], s, end))
            elif on_device:
                dev.append((name, s, end, e.device_index()))
            elif any(k in name for k in LAUNCH_NAMES):
                launches += 1
            else:
                cpu.append((name, s, end))
        win = [(s, e) for n, s, e in spans if n == window]
        if not win:
            raise ValueError(f"the trace holds no span '{window}'")
        lo, hi = min(s for s, _ in win), max(e for _, e in win)
        top, end = [], float("-inf")
        for name, s, e in sorted(cpu, key=lambda x: x[1]):
            if s >= end:
                top.append((name, s, e))
                end = e
        return cls(dev, top, spans, launches, (lo, hi))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def devices(self) -> List[int]:
        return sorted({d for *_, d in self.device_ops})

    def busy_s(self, device: Optional[int] = None) -> float:
        """Seconds of the window in which an operation ran on ``device`` (the
        mean over the devices seen when None)."""
        devs = self.devices() if device is None else [device]
        if not devs:
            return 0.0
        lo, hi = self.window
        return sum(covered(union((s, e) for _, s, e, d in self.device_ops if d == dv), lo, hi)
                   for dv in devs) / len(devs)

    def kernel_s(self, patterns: Sequence[str]) -> float:
        """Summed device seconds of the operations whose name holds one of
        ``patterns``, inside the window."""
        lo, hi = self.window
        return sum(max(0.0, min(e, hi) - max(s, lo)) for n, s, e, _ in self.device_ops
                   if any(p in n for p in patterns))

    def top_device_ops(self, n: int = 10) -> List[List]:
        lo, hi = self.window
        tot: Dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.device_ops:
            tot[name[:120]] += max(0.0, min(e, hi) - max(s, lo))
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    @staticmethod
    def _active(items, starts, t: float) -> Optional[str]:
        """The one of the top-level (non-overlapping, sorted) ``items``
        running at ``t``, if any."""
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and items[i][1] <= t < items[i][2]:
            return items[i][0]
        return None

    def idle_gaps(self, n: int = 10, device: Optional[int] = None) -> List[List]:
        """Idle seconds of the window on ``device`` (the first seen when
        None), summed by what the host was doing when each gap began: the
        benchmark span (spans other than the window do not nest) and the
        top-level host operation."""
        devs = self.devices()
        if not devs:
            return []
        dv = devs[0] if device is None else device
        lo, hi = self.window
        merged = union((s, e) for _, s, e, d in self.device_ops if d == dv)
        spans = sorted([x for x in self.spans if x[0] != "window"], key=lambda x: x[1])
        span_starts = [s for _, s, _ in spans]
        starts = [s for _, s, _ in self.host_ops]
        tot: Dict[str, float] = defaultdict(float)
        for s, e in gaps(merged, lo, hi):
            span = self._active(spans, span_starts, s) or "window"
            op = self._active(self.host_ops, starts, s) or "python"
            tot[f"{span} / {op}"] += e - s
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def profile(run, work, frames: int) -> None:
    """Runs ``work()`` (``frames`` frames of the cell's traffic) under
    ``torch.profiler`` inside a span named 'window', the run's spans
    annotated, and leaves the reading in ``run``: the trace, the device's
    busy and window seconds, and the breakdown."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    run.spans.annotate = True
    try:
        with torch_profile(activities=acts) as prof:
            with run.spans("window"):
                work()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
    finally:
        run.spans.annotate = False
    tr = Trace.from_events(prof.profiler.kineto_results.events())
    run.trace = tr
    run.counters["trace_frames"] = frames
    run.busy_s, run.window_s = tr.busy_s(), tr.window_s
    run.breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
