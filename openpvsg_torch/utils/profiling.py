"""Timing and tracing: the port of ``openpvsg_tpu/utils/profiling.py``.

``Timer`` is the reference's wall-clock fps timer (reference:
models/unitrack/utils/meter.py:1-48), a copy of the JAX package's.

``RECORDER`` holds the program's flat spans and counters. It records only
while a ``torch.profiler`` session is active: otherwise ``span`` returns a
shared no-op context and ``count`` returns at once, one flag check each.
While it records, a span is also a host operation named ``openpvsg.<name>``
in the profiler's trace, and is kept as ``(name, start_ns, end_ns, request,
batch)`` on ``time.time_ns()``, the clock of the profiler's events, so a
span can be laid over the device's timeline directly. Spans are flat: on
one thread no span encloses another. ``request`` numbers the calls of
``run_query_tube_vps`` in the process and ``batch`` is the batch within one;
both are -1 outside such a call.

``trace(log_dir)`` wraps ``torch.profiler`` where the JAX package wraps
``jax.profiler``: it records the CPU and, when there is one, the CUDA
activity of the block, writes a Chrome trace (``trace.json``, which
chrome://tracing and Perfetto open) and the recorder's spans and counters
(``spans.json``) into ``log_dir``; None makes it a no-op.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

# A host-only range: ``torch.profiler.record_function`` opens a user range
# that the trace also draws on the device's timeline, over the kernels it
# launched, where a reader of the trace takes it for device work; this one
# is a plain host operation, and costs about an eighth as much.
_HostRange = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


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


class _Span:
    __slots__ = ("rec", "name", "ids", "range", "t0")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name
        self.ids = (rec.request, rec.batch)
        self.range = _HostRange("openpvsg." + name)

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.range.__exit__(*exc)
        self.rec.spans.append((self.name, self.t0, t1, *self.ids))


class Recorder:
    """The spans and counters of one process (see the module docstring):
    one per process, as the profiler session that switches it on is."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int, int, int]] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self.request = self.batch = -1
        self._requests = 0

    @property
    def active(self) -> bool:
        """Whether a ``torch.profiler`` session runs, so that it records."""
        return _autograd_profiler._is_profiler_enabled

    def span(self, name: str):
        """A context manager: the block as the span ``name``, under the
        current request and batch."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        if _autograd_profiler._is_profiler_enabled:
            self.counters[name] += n

    def copy(self, device: torch.device, nbytes: int) -> None:
        """Counts a copy of ``nbytes`` between the host and ``device``,
        called where it is enqueued: ``copies``, ``copy_bytes``, and
        ``copies_drained`` when the device's current stream had no work
        left. On the card the copies do not block the host, so one that is
        not drained is queued behind work that the host does not wait for.
        A CPU device has no stream, so its copies, which block, always
        count."""
        if not _autograd_profiler._is_profiler_enabled:
            return
        c = self.counters
        c["copies"] += 1
        c["copy_bytes"] += nbytes
        if device.type != "cuda" or torch.cuda.current_stream(device).query():
            c["copies_drained"] += 1

    def begin_request(self) -> int:
        """Numbers a new request, makes it current, and returns its id."""
        self._requests += 1
        self.request, self.batch = self._requests, -1
        return self.request

    def end_request(self) -> None:
        self.request = self.batch = -1

    def reset(self) -> None:
        self.spans.clear()
        self.counters.clear()

    def snapshot(self) -> dict:
        """{'spans': [(name, start_ns, end_ns, request, batch)], 'counters':
        {name: count}}, copies of what was recorded."""
        return {"spans": list(self.spans), "counters": dict(self.counters)}

    def totals(self) -> Dict[str, Dict[str, float]]:
        """{name: {'total_s', 'calls'}} of the recorded spans."""
        out: Dict[str, Dict[str, float]] = {}
        for name, t0, t1, *_ in self.spans:
            tot = out.setdefault(name, {"total_s": 0.0, "calls": 0})
            tot["total_s"] += (t1 - t0) * 1e-9
            tot["calls"] += 1
        return out


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` into ``log_dir/trace.json``,
    and the spans and counters it recorded into ``log_dir/spans.json``.
    No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    RECORDER.reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(RECORDER.snapshot(), f)
