"""Readings that a cell's limits are set from, on the chip, in one process:
the program's sound runs over many seeds, and the control's.

    python3 pvsgbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 4 [--control 3] [--reach 0.3,0.45,0.6] [--out readings.jsonl]

Each seed runs the cell as the benchmark does (set-up, a short window at
the cell's load, the comparison) and prints the numbers compared. With
``--control n`` the first n seeds also judge the control: the plain
reference put in the program's place with its products in float8 e4m3,
the precision below the configuration's bfloat16, judged on a Run of its
own. ``--reach`` also gives ``feat_gap`` at each of those ``segment_gap``
limits, for either side. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pvsgbench import core  # noqa: E402


def one(workload: str, seed: int, seconds: float, control: bool, reach) -> dict:
    import torch

    w = core.load_json("workloads", workload)
    run = core.Run(types.SimpleNamespace(seed=seed, seconds=seconds, trace=0), w,
                   core.load_json("configs", w["config"]))
    run.control = control
    t0 = time.perf_counter()
    core.load_module("drivers", w["driver"]).run(run)
    torch.cuda.empty_cache()
    out = {"workload": workload, "seed": seed, "correct": run.correct,
           "attempted": run.attempted, "failed": run.failed,
           "checks": {c["name"]: c["value"] for c in run.checks},
           "counters": {k: v for k, v in run.counters.items()
                        if k.startswith(("control.", "reading.", "judged"))},
           "values": run.values, "seconds": time.perf_counter() - t0}
    if run.control_run is not None:
        out["control_correct"] = run.control_run.correct
        out["control_checks"] = {c["name"]: c["value"] for c in run.control_run.checks}
    for side, verdict in run.verdicts.items():
        out["counters"].update({f"{side}.feat_gap@{r}": verdict.readings(r)["feat_gap"]
                                for r in reach})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--reach", default="")
    p.add_argument("--out")
    a = p.parse_args(argv)
    core.set_env()
    seeds = [int(s) for s in a.seeds.split(",")]
    reach = [float(r) for r in a.reach.split(",") if r]
    rows = []
    for i, seed in enumerate(seeds):
        rows.append(one(a.workload, seed, a.seconds, i < a.control, reach))
        print(json.dumps(rows[-1]), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
