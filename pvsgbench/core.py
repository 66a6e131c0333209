"""The harness: one run of one cell.

``python3 pvsgbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` reads ``workloads/<cell>.json``, its configuration
``configs/<config>.json`` and its driver ``drivers/<driver>.py``, and runs
the driver, which sets up, warms up, measures for ``--seconds``, and
compares what the timed path produced with the plain reference. It then
reads each of the cell's metrics through ``metrics/<metric>.py``
(``--trace 0``: the end-to-end ones, ``--trace 1``: the per-layer ones) and
prints one JSON line. A new cell, configuration, metric or driver is a new
file: nothing here names one.

Exit codes: 0 a result was printed (``correct`` may be false); 3 the cell
needs more CUDA devices than there are; 4 JAX or the JAX package was
loaded. An exception exits 1. Neither prints a result.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "openpvsg_tpu")
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH_DIR, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    modname = f"pvsgbench.{kind}.{name.replace('.', '__')}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def process_age() -> float:
    """Seconds since this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def set_env() -> None:
    """Before torch and numpy load: build and kernel caches inside the
    checkout, at fixed paths, so that only the first run of a checkout
    builds (the port's own libraries land in ``openpvsg_torch/build/``);
    nothing loads JAX through a library; and one host thread for the math
    libraries, so that the host-bound cells are not at the mercy of thread
    pools contending for the host's cores."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE_DIR, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE_DIR, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for name in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(name, "1")


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Spans:
    """Host-clock spans around the calls into each layer, kept as totals and
    counts (and, where asked, every duration). With ``annotate`` each span is
    also a ``record_function`` range named ``bench.<name>`` in the trace."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name: str, keep: bool = False):
        ctx = contextlib.nullcontext()
        if self.annotate:
            from torch.profiler import record_function
            ctx = record_function(f"bench.{name}")
        with ctx:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.total[name] += dt
                self.count[name] += 1
                if keep:
                    self.samples[name].append(dt)


class Run:
    """What one run knows: its arguments, cell and configuration, and what
    the driver measured. Metric readers take it and read what they need;
    one that finds nothing returns None."""

    def __init__(self, args, workload: dict, config: dict):
        self.args = args
        self.seed: int = args.seed
        self.seconds: float = args.seconds
        self.trace_on: bool = bool(args.trace)
        self.workload = workload
        self.config = config
        self.spans = Spans()
        self.values: Dict[str, float] = {}     # end-to-end readings
        self.counters: Dict[str, float] = {}
        self.trace = None                      # a trace.Trace of the traced window
        self.checks: List[dict] = []
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.device_count = int(workload["chips"])
        self.device_kind = ""
        self.breakdown: Optional[dict] = None
        self.busy_s: Optional[float] = None
        self.window_s: Optional[float] = None
        # set by the CPU tests and by ``control.py``, never by a run of the
        # benchmark: the device the driver runs on, and whether it also
        # judges the control (its checks then land in ``control_run``); the
        # driver's comparisons by side, for ``control.py``'s readings
        self.device: Optional[str] = None
        self.control = False
        self.control_run: Optional["Run"] = None
        self.verdicts: Dict[str, object] = {}

    def check(self, name: str, value: float, limit: float, at_least: bool = False) -> None:
        """A number compared with its limit: the run is correct only when
        every one is at or under its limit (``at_least``: at or over it)."""
        self.checks.append({"name": name, "value": float(value), "limit": float(limit),
                            "at_least": at_least})

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(passes(c) for c in self.checks)


def passes(c: dict) -> bool:
    return c["value"] >= c["limit"] if c["at_least"] else c["value"] <= c["limit"]


def parse_args(argv):
    p = argparse.ArgumentParser(prog="pvsgbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def read_metrics(run: Run, names: List[str]) -> Dict[str, dict]:
    out = {}
    for name in names:
        mod = load_module("metrics", name)
        value = mod.read(run)
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out


def result_line(run: Run) -> dict:
    w = run.workload
    names = w["per_layer"] if run.trace_on else w["end_to_end"]
    device = {"platform": "gpu", "kind": run.device_kind, "count": run.device_count,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace_on:
        device["busy_s"] = run.busy_s
        device["window_s"] = run.window_s
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": read_metrics(run, names), "device": device}
    if run.trace_on and run.breakdown is not None:
        out["breakdown"] = run.breakdown
    out["checks"] = {c["name"]: {"value": _finite(c["value"]), "limit": c["limit"],
                                 **({"at_least": True} if c["at_least"] else {})}
                     for c in run.checks}
    return out


def _finite(x: float) -> float:
    """JSON has no infinity: a reading with no bound (a segment without a
    feature, a frame without an answer) prints as 1e300."""
    return x if math.isfinite(x) else 1e300


def main(argv=None) -> int:
    args = parse_args(argv)
    workload = load_json("workloads", args.workload)
    config = load_json("configs", workload["config"])
    set_env()
    import torch

    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"pvsgbench: {args.workload} needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3
    run = Run(args, workload, config)
    run.device_kind = torch.cuda.get_device_name(0)
    load_module("drivers", workload["driver"]).run(run)
    loaded = forbidden_modules()
    if loaded:
        print(f"pvsgbench: loaded {', '.join(loaded)}: the benchmark runs without JAX",
              file=sys.stderr)
        return 4
    line = result_line(run)
    for c in run.checks:
        print(f"check {c['name']} {c['value']!r} {'at least' if c['at_least'] else 'limit'} "
              f"{c['limit']!r} {'ok' if passes(c) else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
