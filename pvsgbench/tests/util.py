"""Helpers of the benchmark's CPU tests: a cell cut to a size the CPU holds,
driven through its driver with the look for a chip skipped."""
from __future__ import annotations

import types

import torch

from pvsgbench import core


def tiny_cell(workload: str, dtype: str = "float32", seconds: float = 0.5,
              trace: int = 0, seed: int = 2 ** 31 + 77):
    """A ``core.Run`` of ``workload`` at a CPU size: the configuration's
    widths cut (R-26, 64 channels, 30 queries, 2 decoder layers), 72x88
    frames, videos of 6-10 frames, the program computing in ``dtype``."""
    w = core.load_json("workloads", workload)
    cfg = core.load_json("configs", w["config"])
    m = cfg["model"]
    m["backbone"]["depth"] = 26
    m["pixel_decoder"].update(feat_channels=64, out_channels=64, ffn_channels=128,
                              encoder_layers=1)
    m["decoder"].update(feat_channels=64, ffn_channels=128, num_layers=2)
    m["num_queries"] = 30
    w["traffic"].update(frame_hw=[72, 88], lengths=[6, 10, 8], blobs=[2, 3, 2],
                        trace_frames=4, dtype=dtype)
    w["check"]["windows"] = 6
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    run = core.Run(args, w, cfg)
    run.device = "cpu"
    return run


def drive(run):
    torch.manual_seed(0)
    core.load_module("drivers", run.workload["driver"]).run(run)
    return run
