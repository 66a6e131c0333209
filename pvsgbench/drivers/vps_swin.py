"""Offline VPS stage 2 of a Swin configuration: ``drivers/vps.py``'s flow
(``run_query_tube_vps`` over whole videos, back to back, then the judge)
with a Swin backbone in the program and in the reference.

What the two drivers share comes from ``vps.py``: the port's config
(``port_config``), the videos, the warm-up, the video run, the windows
judged, the reading of the program's files, the checks (``hold``) and the
kernels' bounds, so that both set the same counters and make the same
checks. What is this driver's own:

- the weights: ``gen.py``'s scheme over the state shapes of
  ``reference/swin.py`` (``segmenter_weights``), the mask features' bias
  centred on one frame of the seed as ``gen.segmenter_weights`` centres it;
- the judge's reference model, ``reference/swin.py``;
- a first step that builds the port's model of the configuration on the
  meta device, so that a program which lacks the configuration fails at
  once, before the kernels' build and the weights.
"""
from __future__ import annotations

import math
import os
import shutil
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from pvsgbench import core, gen
from pvsgbench.drivers import vps
from pvsgbench.reference import model as ref_model
from pvsgbench.reference import swin as ref_swin
from pvsgbench.reference import vps as ref_vps
from pvsgbench.trace import profile


def segmenter_weights(m: dict, seed: int, device, frame_hw=None) -> Dict[str, torch.Tensor]:
    """float32 state dict of the Swin configuration's segmenter on
    ``device``, drawn as ``gen.segmenter_weights`` draws (one stream of
    the seed, in the order of the state dict); with ``frame_hw`` the mask
    features' bias is set to centre them on one frame of that size."""
    shapes = ref_swin.state_shapes(m)
    pd = m["pixel_decoder"]
    kinds = {key: gen._init_kind(key, shape) for key, shape in shapes.items()}
    draw = gen.generator(seed, device, stream=1)
    flat = torch.randn(sum(math.prod(shapes[k]) for k, v in kinds.items()
                           if v in ("fan_in", "normal")), generator=draw, device=device)
    offset_bias = torch.from_numpy(ref_model.msda_offset_bias(
        pd["num_heads"], pd["num_levels"], pd["num_points"]).astype(np.float32)).to(device)
    out, i = {}, 0
    for key, shape in shapes.items():
        kind, n = kinds[key], math.prod(shape)
        if kind == "offset_bias":
            t = offset_bias.clone()
        elif kind in ("fan_in", "normal"):
            t = flat[i:i + n].view(shape).clone()
            if kind == "fan_in":
                t /= math.sqrt(math.prod(shape[1:]))
            i += n
        else:
            t = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device)
        out[key] = t
    if frame_hw is not None:
        frame = gen.video(seed, 10 ** 6, 1, frame_hw, device, 4)
        mf = ref_model.mask_features(ref_swin.build(m, out, device), frame)
        out["pixel_decoder.mask_feature.bias"] = -mf.mean((0, 1, 2))
    return out


def check_port(run) -> None:
    """The port's model of the configuration, built on the meta device:
    raises where the program cannot build it."""
    from openpvsg_torch.models.mask2former import Mask2Former

    with torch.device("meta"):
        Mask2Former(vps.port_config(run.config))


def build_segmenter(run, dev):
    from openpvsg_torch.infer.segmenter import SegmenterInference

    state = segmenter_weights(run.config["model"], run.seed, dev,
                              run.workload["traffic"]["frame_hw"])
    run.weights = {k: v.cpu() for k, v in state.items()}
    dtype = getattr(torch, run.workload["traffic"]["dtype"])
    seg = SegmenterInference(vps.port_config(run.config), state, dtype=dtype, device=dev)
    del state
    return seg


def run(run) -> None:
    check_port(run)
    dev = vps.device_of(run)
    t = run.workload["traffic"]
    if dev.type == "cuda":
        from openpvsg_torch.kernels import build

        build.build()
        torch.cuda.set_device(dev)
    seg = build_segmenter(run, dev)
    spanned = vps.SpannedSegmenter(seg, run.spans)
    videos = vps.make_videos(run, dev)
    tmp = tempfile.mkdtemp(prefix="pvsgbench_vps_swin_")
    try:
        vps.warm_up(run, spanned, videos, tmp)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        run.values["setup_s"] = core.process_age()
        run.spans.total.clear()
        done = []                       # (video index, its output root, tubes)
        frames = 0
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < run.seconds:
            k = i % len(videos)
            root = os.path.join(tmp, f"v{i}")
            with run.spans("video"):
                tubes = vps.run_video(run, spanned, videos[k], root)
            done.append((k, root, tubes))
            frames += len(videos[k])
            i += 1
        elapsed = time.perf_counter() - t0
        run.values["frames_per_s"] = frames / elapsed
        run.counters.update(window_frames=frames, window_s=elapsed,
                            video_s=run.spans.total["video"],
                            segmenter_s=run.spans.total["segmenter"])
        run.attempted = len(done)
        if dev.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
        if run.trace_on:      # the first video's first frames once more, traced
            sliced = videos[0][:t["trace_frames"]]
            profile(run, lambda: vps.run_video(run, spanned, sliced,
                                               os.path.join(tmp, "traced")), len(sliced))
        del spanned, seg
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        judge(run, videos, done, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def judge(run, videos, done, dev) -> None:
    """``vps.judge`` against ``reference/swin.py``: the run's checks; with
    ``run.control`` the control's too, on a Run of its own."""
    m = run.config["model"]
    nt = m["num_things_classes"]
    failed = 0
    for k, root, tubes in done:
        try:
            masks, tube_feats = vps.program_outputs(root)
        except (OSError, ValueError, EOFError) as e:
            failed += 1
            print(f"pvsgbench: video {k}: unreadable outputs: {e}", file=sys.stderr)
            continue
        n = len(videos[k])
        if (len(tube_feats) != tubes or any(len(v) != n for v in tube_feats.values())
                or any(fid < 1 or fid > n for fid in masks)):
            failed += 1
    run.failed = failed
    model = ref_swin.build(m, {k: v.to(dev) for k, v in run.weights.items()}, dev)
    reach = run.workload["check"]["limits"]["segment_gap"]
    prog, ctrl = ref_vps.Verdict(nt, reach), ref_vps.Verdict(nt, reach)
    frames_judged, cache = 0, {}
    for k, root, lo, n in vps.judged_windows(run, videos, done):
        if root not in cache:
            try:
                cache[root] = vps.program_outputs(root)
            except (OSError, ValueError, EOFError):
                cache[root] = ({}, {})
        masks, tube_feats = cache[root]
        frames = torch.from_numpy(videos[k][lo:lo + n]).to(dev)
        refs = vps.fused(run, model, frames, dev)
        for j, fr in enumerate(refs):
            fid = lo + j + 1
            cmap = np.full(fr["cls_map"].shape, -1, np.int64)
            segs = []
            for tid, cid, h, w, rle in masks.get(fid, []):
                pixels = ref_vps.rle_decode(rle, h, w) > 0
                cmap[pixels] = cid
                per_frame = tube_feats.get(tid) or []
                segs.append((cid, pixels, per_frame[fid - 1] if len(per_frame) >= fid else None))
            prog.add(fr, cmap, segs)
            frames_judged += 1
        if run.control:
            for fr, c in zip(refs, vps.fused(run, model, frames, dev, rounding="fp8")):
                ctrl.add(fr, c["cls_map"], [(sid % ref_vps.INSTANCE_OFFSET, c["seg_map"] == sid, f)
                                            for sid, f in c["feats"].items()])
        del refs
    run.counters.update(judged_frames=frames_judged, judged_segments=prog.segments)
    readings = prog.readings()
    vps.hold(run, readings, failed, prog.segments)
    run.counters.update({f"reading.{k}": v for k, v in readings.items()})
    if run.control:
        readings = ctrl.readings()
        run.control_run = core.Run(run.args, run.workload, run.config)
        vps.hold(run.control_run, readings, 0, ctrl.segments)
        run.counters.update({f"control.{k}": v for k, v in readings.items()})
    run.verdicts = {"reading": prog, **({"control": ctrl} if run.control else {})}
