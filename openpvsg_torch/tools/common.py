"""Shared CLI plumbing of the port's tools (config loading, logging,
process groups, work splitting), after ``tools/common.py``.

The tools take the JAX tools' arguments. ``--device`` picks the device:
the GPU unless the caller asks for ``cpu``. Multi-process runs
(``--dist-coordinator HOST:PORT --dist-num-processes N --dist-process-id
I``, or ``--dist-init`` under ``torchrun``) join a ``torch.distributed``
process group. The train CLI steps in lockstep over it and all-reduces its
gradients: NCCL on the GPU (one GPU per process), gloo on the CPU. The
other CLIs stride their videos over the ranks (``partition_videos``),
collect through files (``collect_rank_results``) and exchange nothing but
a barrier: gloo, whether the ranks share a GPU, hold one each or run on
the CPU. In one process every visible GPU forms a
``(data, time)`` mesh (``maybe_mesh``; ``--n-time`` sizes the 'time' axis
of the relation scoring CLIs).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
import time
from typing import Optional

from openpvsg_torch.config import (PVSGConfig, apply_overrides, get_config,
                                   parse_set_args)

TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


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
    # multi-process runs (the reference's mmcv init_dist launchers,
    # tools/train.py:84-87,173): torch.distributed, one process per device
    p.add_argument("--dist-init", action="store_true",
                   help="join the process group torchrun describes "
                        "(init_method env://: MASTER_ADDR, MASTER_PORT, "
                        "WORLD_SIZE, RANK, LOCAL_RANK)")
    p.add_argument("--dist-coordinator", default=None, metavar="HOST:PORT",
                   help="rank 0's address (tcp://HOST:PORT); needs "
                        "--dist-num-processes and --dist-process-id")
    p.add_argument("--dist-num-processes", type=int, default=None)
    p.add_argument("--dist-process-id", type=int, default=None)
    p.add_argument("--n-time", type=int, default=1, metavar="K",
                   help="mesh 'time'-axis size: the visible GPUs form a "
                        "(n/K, K) (data, time) mesh and relation scoring "
                        "splits the frame axis over 'time' "
                        "(TimeShardedRelation); 1 = pure data axis")
    return p


def init_distributed(args, lockstep: bool = False):
    """Join the process group of a multi-process run; returns this rank's
    device (and sets ``args.device`` to it), or None when no ``--dist-*``
    flag asks for one. Runs first in ``load_config``, as the JAX tools'.
    A ``lockstep`` tool (train) all-reduces tensors over the group: NCCL
    on the GPU, gloo on the CPU. The others only wait at a barrier, which
    gloo serves however the ranks share the GPUs (NCCL refuses two ranks
    on one GPU)."""
    coord = getattr(args, "dist_coordinator", None)
    if not (coord or getattr(args, "dist_init", False)):
        return None
    from openpvsg_torch.parallel.mesh import init_distributed as join

    backend = None if lockstep else "gloo"
    if coord:
        if args.dist_num_processes is None or args.dist_process_id is None:
            raise SystemExit(
                "--dist-coordinator requires --dist-num-processes and "
                "--dist-process-id")
        dev = join(f"tcp://{coord}", args.dist_num_processes,
                   args.dist_process_id, device=args.device, backend=backend)
    else:
        missing = [v for v in TORCHRUN_VARS if v not in os.environ]
        if missing:
            raise SystemExit(
                f"--dist-init reads the process group from torchrun's "
                f"environment; {', '.join(missing)} not set")
        local = os.environ.get("LOCAL_RANK")
        dev = join("env://", rank=int(os.environ["RANK"]), device=args.device,
                   backend=backend,
                   local_rank=None if local is None else int(local))
    args.device = str(dev)
    return dev


def reject_unused_n_time(args) -> None:
    """--n-time lives in base_parser so every tool accepts it syntactically,
    but only tools with a relation-scoring stage (rel_test, rel_test_full,
    end2end_inference) route it into a (data, time) mesh. Tools that shard
    only the 'data' axis must fail loudly rather than silently ignore it."""
    if getattr(args, "n_time", 1) != 1:
        raise SystemExit(
            "--n-time > 1 is only meaningful for tools with a relation "
            "scoring stage (rel_test, rel_test_full, end2end_inference); "
            "this tool shards only the 'data' axis")


def maybe_mesh(device=None, min_devices: int = 2, n_time: int = 1):
    """A (data, time) mesh of the visible GPUs for the tools' frame-sharded
    inference and relation scoring, or None when fewer than
    max(min_devices, n_time) devices are this process's: a multi-process
    run, ``--device`` naming one device, and the CPU have one. ``n_time``
    > 1 carves the GPUs into a (n / n_time, n_time) grid, and must divide
    their count (``maybe_mesh``, ``tools/common.py:83-110``)."""
    import torch

    from openpvsg_torch.parallel.mesh import make_mesh, world

    if device is not None or world() > 1 or not torch.cuda.is_available():
        return None
    n = torch.cuda.device_count()
    if n < max(min_devices, n_time):
        return None
    if n % n_time:
        raise SystemExit(f"--n-time {n_time} does not divide the {n} visible GPUs")
    return make_mesh(n_data=n // n_time, n_time=n_time)


def make_relation_executor(mesh, model):
    """``TimeShardedRelation`` over the CLI's mesh (pairs split over 'data',
    frames over 'time'); None without a mesh (``tools/rel_test.py:15``)."""
    if mesh is None:
        return None
    from openpvsg_torch.parallel.tp import TimeShardedRelation

    return TimeShardedRelation(mesh, model)


def partition_videos(videos):
    """This rank's share of the work list in a multi-process run, strided
    over the ranks (reference: multi_gpu_test's rank-strided sharding,
    tools/prepare_query_tube_ips.py:248-250); all of it in one process.
    Each rank writes its videos into the shared work_dir."""
    from openpvsg_torch.parallel.mesh import rank, world

    return list(videos)[rank()::world()]


def collect_rank_results(work_dir: str, name: str, payload):
    """File-level result collection (reference: mmcv collect_results_cpu in
    multi_gpu_test): each rank pickles its payload as
    ``{name}_rank{i}.pkl`` in the shared work_dir; after a barrier, rank 0
    returns every rank's payload in rank order and the others None. One
    process returns [payload] without touching the disk."""
    import torch.distributed as dist

    from openpvsg_torch.parallel.mesh import rank, world

    if world() <= 1:
        return [payload]
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, f"{name}_rank{rank()}.pkl"), "wb") as f:
        pickle.dump(payload, f)
    dist.barrier()
    if rank() != 0:
        return None
    out = []
    for i in range(world()):
        with open(os.path.join(work_dir, f"{name}_rank{i}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def load_relation_params(checkpoint: str, model_name: str, device, cfg=None):
    """A ``RelationModel`` (``cfg``, a ``RelationHeadConfig``, gives its
    capacity; the preset's defaults without one) on ``device`` with the
    weights of ``checkpoint``: a port relation checkpoint (the ``epoch_N``
    files of ``rel_train``), the reference's ``.pth`` bundle or a ``.npz``
    of ``export_jax_checkpoint.py`` (``train/checkpoint.py:load_relation_state``)."""
    from openpvsg_torch.config import RelationHeadConfig
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.train.checkpoint import load_relation_state

    model = RelationModel.from_config(cfg or RelationHeadConfig(),
                                      model_name=model_name)
    model.load_state_dict(load_relation_state(checkpoint, model_name, cfg=cfg),
                          strict=True)
    return model.to(device).eval()


def load_config(args, lockstep: bool = False) -> PVSGConfig:
    """The tool's config; joins the process group first
    (``init_distributed``)."""
    init_distributed(args, lockstep)
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
    """Log to the console and to ``{work_dir}/{time}_{name}.log``
    (``_rank{i}`` added in a multi-process run: each rank its own file)."""
    from openpvsg_torch.parallel.mesh import rank, world

    os.makedirs(work_dir, exist_ok=True)
    ts = time.strftime("%Y%m%d_%H%M%S")
    if world() > 1:
        name = f"{name}_rank{rank()}"
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
    from openpvsg_torch.kernels import fpn, fusion, window_attention

    since = since or {}
    return {fn.__name__: fn.launches - since.get(fn.__name__, 0)
            for fn in (fpn.KERNEL_WRAPPERS + fusion.KERNEL_WRAPPERS
                       + window_attention.KERNEL_WRAPPERS)}
