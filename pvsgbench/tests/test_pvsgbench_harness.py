"""The harness on the CPU: names and units, cells found by name, the trace's
idle share, and the import rule."""
from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from pvsgbench import core
from pvsgbench.trace import Trace, union

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ROOT = core.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "openpvsg_tpu"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units_use_the_allowed_characters():
    b = _bench()
    for c in b["configs"]:
        assert NAME.match(c["name"]), c["name"]
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]


def test_benchmark_agrees_with_its_files():
    """Every cell has its file, every metric its reader with the same unit
    and source, and every per-layer metric moves an end-to-end metric that
    each of its cells reports."""
    b = _bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        mod = core.load_module("metrics", m["name"])
        assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"], m["name"]
    cells = {}
    for w in b["workloads"]:
        f = core.load_json("workloads", w["name"])
        assert f["config"] == w["config"] and f["chips"] == w["chips"] and f["why"] == w["why"]
        assert w["traffic"] == w["name"]
        core.load_json("configs", f["config"])
        cells[w["name"]] = f
    for m in b["per_layer"]:
        mod = core.load_module("metrics", m["name"])
        assert m["moves"] in e2e and mod.MOVES == m["moves"] and mod.LAYER == m["layer"]
        for cell in m["workloads"]:
            assert m["name"] in cells[cell]["per_layer"]
            assert m["moves"] in cells[cell]["end_to_end"]
    for name, f in cells.items():
        assert "setup_s" in f["end_to_end"] and len(f["end_to_end"]) >= 2
        assert f["per_layer"], name


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A copy of the benchmark with one configuration, cell, driver and
    metric added as files runs the cell and reports the metric; no file that
    was there changes."""
    dst = tmp_path / "pvsgbench"
    shutil.copytree(os.path.join(ROOT, "pvsgbench"), dst,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in dst.rglob("*") if p.is_file()}
    (dst / "configs" / "toy.json").write_text(json.dumps({"name": "toy", "model": {}}))
    (dst / "workloads" / "toy.echo.json").write_text(json.dumps({
        "config": "toy", "driver": "echo", "chips": 1, "why": "a toy",
        "traffic": {"n": 3}, "end_to_end": ["echo_per_s", "setup_s"],
        "per_layer": ["echo_count.toy"], "check": {}}))
    (dst / "drivers" / "echo.py").write_text(textwrap.dedent("""
        def run(run):
            n = run.workload["traffic"]["n"]
            run.values.update(echo_per_s=float(n), setup_s=0.5)
            run.counters["echo"] = n
            run.attempted = n
            run.check("echo", 0.0, 0.0)
    """))
    (dst / "metrics" / "echo_per_s.py").write_text(
        'UNIT = "1/s"\nSOURCE = "host_clock"\ndef read(run):\n    return run.values.get("echo_per_s")\n')
    (dst / "metrics" / "echo_count.toy.py").write_text(
        'UNIT = "1"\nSOURCE = "program_counter"\nLAYER = "toy"\nMOVES = "echo_per_s"\n'
        'def read(run):\n    return run.counters.get("echo")\n')
    code = textwrap.dedent("""
        import json, sys, types
        from pvsgbench import core
        for trace in (0, 1):
            w = core.load_json("workloads", "toy.echo")
            args = types.SimpleNamespace(seed=1, seconds=1.0, trace=trace)
            run = core.Run(args, w, core.load_json("configs", w["config"]))
            core.load_module("drivers", w["driver"]).run(run)
            print(json.dumps(core.result_line(run)))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, check=True, env={**os.environ, "PYTHONPATH": str(tmp_path)})
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    assert lines[0]["metrics"]["echo_per_s"]["value"] == 3.0 and lines[0]["correct"]
    assert lines[1]["metrics"]["echo_count.toy"] == {"value": 3.0, "unit": "1"}
    assert all(p.read_bytes() == data for p, data in before.items())


class _Ev:
    def __init__(self, kind, name, start_us, dur_us, dev=0):
        self.k, self.n, self.s, self.d, self.dev = kind, name, start_us, dur_us, dev

    def device_type(self):
        return "DeviceType.CUDA" if self.k == "kernel" else "DeviceType.CPU"

    def name(self):
        return self.n

    def start_ns(self):
        return int(self.s * 1000)

    def duration_ns(self):
        return int(self.d * 1000)

    def device_index(self):
        return self.dev


def test_idle_share_takes_the_union_of_two_streams():
    """Compute on one stream and a collective on another overlap for 20 of
    their 60 us: busy is 60 of the 100-us window, not their 80-us sum."""
    ev = [_Ev("user_annotation", "bench.window", 0, 100),
          _Ev("user_annotation", "bench.segmenter", 0, 50),
          _Ev("kernel", "bench.segmenter", 0, 50),      # the span's image on the device
          _Ev("kernel", "gemm", 10, 40), _Ev("kernel", "ncclAllReduce", 30, 40),
          _Ev("cuda_runtime", "cudaLaunchKernel", 5, 1), _Ev("cuda_runtime", "cudaLaunchKernel", 25, 1),
          _Ev("cpu_op", "aten::mm", 4, 3)]
    tr = Trace.from_events(ev)
    assert tr.busy_s() == pytest.approx(60e-6)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.launches == 2
    assert tr.kernel_s(["gemm", "nccl"]) == pytest.approx(80e-6)
    gaps = dict(tr.idle_gaps())
    assert gaps == pytest.approx({"segmenter / python": 10e-6, "window / python": 30e-6})
    assert union([(0, 1), (0.5, 2), (3, 4)]) == [(0, 2), (3, 4)]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    base = os.path.join(ROOT, "pvsgbench", sub)
    for d, _, files in os.walk(base):
        if "__pycache__" in d or ".cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: set(_imports(p)) & FORBIDDEN for p in _sources()}
    assert not any(found.values()), {p: v for p, v in found.items() if v}


def test_the_reference_imports_nothing_of_the_program():
    for p in _sources("reference"):
        assert "openpvsg_torch" not in set(_imports(p)), p


def test_a_run_exits_without_a_result_where_no_device_is():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "pvsgbench", "run.py"),
                          "--workload", "vps_offline.r50_axial", "--seed", str(2 ** 31 + 5),
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
