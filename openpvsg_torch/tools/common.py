"""Shared CLI plumbing of the port's tools (config loading, logging,
single-process work splitting), after ``tools/common.py``.

The tools take the JAX tools' arguments. The multi-process ones
(``--dist-init``, ``--dist-coordinator``, ``--dist-num-processes``,
``--dist-process-id``, ``--n-time`` above 1) are refused: the port runs one
process on one device (ROADMAP.md A13 ports ``torch.distributed``).
``--device`` picks the device: the GPU unless the caller asks for ``cpu``.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional

from openpvsg_torch.config import (PVSGConfig, apply_overrides, get_config,
                                   parse_set_args)


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", default="mask2former_ips",
                   help="config preset name, or the path of a config.json")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--anno-file", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted config overrides (the --cfg-options equivalent)")
    p.add_argument("--device", default=None,
                   help="torch device; the GPU unless 'cpu' is asked for")
    # accepted so that a JAX tool's command line parses; refused when used
    p.add_argument("--dist-init", action="store_true",
                   help="not ported: multi-process runs (ROADMAP.md A13)")
    p.add_argument("--dist-coordinator", default=None, metavar="HOST:PORT",
                   help="not ported (ROADMAP.md A13)")
    p.add_argument("--dist-num-processes", type=int, default=None,
                   help="not ported (ROADMAP.md A13)")
    p.add_argument("--dist-process-id", type=int, default=None,
                   help="not ported (ROADMAP.md A13)")
    p.add_argument("--n-time", type=int, default=1, metavar="K",
                   help="mesh 'time'-axis size; only 1 (ROADMAP.md A13)")
    return p


def reject_distributed(args) -> None:
    """Raise NotImplementedError for any multi-process flag."""
    used = [flag for flag, value in (
        ("--dist-init", args.dist_init),
        ("--dist-coordinator", args.dist_coordinator),
        ("--dist-num-processes", args.dist_num_processes),
        ("--dist-process-id", args.dist_process_id)) if value]
    if used:
        raise NotImplementedError(
            f"{', '.join(used)}: multi-process runs are not ported to "
            "openpvsg_torch (ROADMAP.md A13); run one process on one device")


def reject_unused_n_time(args) -> None:
    """The port has no device mesh: --n-time must stay 1."""
    if getattr(args, "n_time", 1) != 1:
        raise SystemExit(
            "--n-time > 1 needs a (data, time) device mesh, which is not "
            "ported to openpvsg_torch (ROADMAP.md A13)")


def partition_videos(videos):
    """Per-process share of the work list: all of it, since the port runs
    one process (the rank-strided split is ROADMAP.md A13)."""
    return list(videos)


def collect_rank_results(work_dir: str, name: str, payload):
    """Results of every process: [payload] from the one process."""
    return [payload]


def load_config(args) -> PVSGConfig:
    reject_distributed(args)
    cfg = get_config(args.config)
    cfg = apply_overrides(cfg, parse_set_args(args.set))
    if args.work_dir:
        cfg = apply_overrides(cfg, {"data.work_dir": args.work_dir})
    if args.data_dir:
        cfg = apply_overrides(cfg, {"data.data_dir": args.data_dir})
    if args.anno_file:
        cfg = apply_overrides(cfg, {"data.anno_file": args.anno_file})
    return cfg


def setup_logging(work_dir: str, name: str) -> logging.Logger:
    os.makedirs(work_dir, exist_ok=True)
    ts = time.strftime("%Y%m%d_%H%M%S")
    logger = logging.getLogger("openpvsg_torch")
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    fh = logging.FileHandler(os.path.join(work_dir, f"{ts}_{name}.log"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    for h in logger.handlers:
        h.close()
    logger.handlers = [fh, sh]
    return logger


SUMMARY_PREFIX = "summary: "


def log_summary(logger: logging.Logger, summary: dict) -> None:
    """One log line ``summary: {json}`` with a run's counts and timings;
    ``parse_summary`` reads it back from the log."""
    logger.info(SUMMARY_PREFIX + json.dumps(summary))


def parse_summary(text: str) -> dict:
    """The last ``summary:`` line of a tool's log output, as a dict."""
    lines = [ln for ln in text.splitlines() if SUMMARY_PREFIX in ln]
    if not lines:
        raise ValueError("no summary line in the tool's output")
    return json.loads(lines[-1].split(SUMMARY_PREFIX, 1)[1])


def kernel_launches(since: Optional[dict] = None) -> dict:
    """The launch counts of every kernel wrapper of the inference path, less
    the counts ``since`` holds (a tool passes those it found at its start, so
    a run in a process that launched kernels before counts only its own)."""
    from openpvsg_torch.kernels import fpn, fusion

    since = since or {}
    return {fn.__name__: fn.launches - since.get(fn.__name__, 0)
            for fn in fpn.KERNEL_WRAPPERS + fusion.KERNEL_WRAPPERS}
