"""Offline VPS stage 2: ``run_query_tube_vps`` over whole videos, back to back.

Set-up builds the port's kernels (from the checkout's cache after the first
run), makes the weights and the videos from the seed on the device, and
warms every batch shape the videos will use. The window then runs videos in
the seed's order until ``--seconds`` have passed; the video in progress is
finished, and ``frames_per_s`` is every frame over all the elapsed time.
Each video writes ``masks.txt`` and ``query_feats.pickle`` under the run's
``TMPDIR``. Afterwards the segmenter is freed and the plain float32
reference runs over windows drawn from the seed, and judges those files
(``reference/vps.py``).

The cell's ``traffic`` holds ``frame_hw``, the video ``lengths`` and the
``blobs`` of each, ``window``, ``windows_per_batch``, ``pipeline_depth``,
``dtype`` and ``trace_frames`` (the frames of the profiled slice that a
``--trace 1`` run adds after its window); its ``check`` holds the number of
``windows`` judged and the ``limits``, of which ``segment_gap``'s is also
how far a producer may be from a segment for ``feat_gap`` to weigh it.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from pvsgbench import core, counts, gen
from pvsgbench.reference import model as ref_model
from pvsgbench.reference import vps as ref_vps
from pvsgbench.trace import profile


def port_config(cfg: dict):
    """The port's ``Mask2FormerConfig`` of the configuration file's model
    and its serving thresholds."""
    from openpvsg_torch.config import Mask2FormerConfig, apply_overrides

    flat = {}

    def walk(prefix, d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            else:
                flat[prefix + k] = tuple(v) if isinstance(v, list) else v

    walk("", {**cfg["model"], **cfg["serving"]})
    return apply_overrides(Mask2FormerConfig(), flat)


class SpannedSegmenter:
    """Passes every call through to the port's ``SegmenterInference``, with
    a span named 'segmenter' around the two calls the stage driver makes."""

    def __init__(self, seg, spans):
        self._seg, self._spans = seg, spans

    def infer_windows_vps_async(self, *a, **k):
        with self._spans("segmenter"):
            return self._seg.infer_windows_vps_async(*a, **k)

    def finish_windows_vps(self, *a, **k):
        with self._spans("segmenter"):
            return self._seg.finish_windows_vps(*a, **k)

    def __getattr__(self, name):
        return getattr(self._seg, name)


def device_of(run) -> torch.device:
    return torch.device(run.device or "cuda:0")


def make_videos(run, dev):
    """The cell's fixed videos (lengths and rectangles paired as listed) in
    the seed's order: every seed runs the same work, in another order."""
    t = run.workload["traffic"]
    pairs = list(zip(t["lengths"], t["blobs"]))
    order = gen.rng(run.seed, 0).permutation(len(pairs))
    videos = []
    for i, k in enumerate(order):
        n, blobs = pairs[k]
        videos.append(gen.video(run.seed, i, int(n), t["frame_hw"], dev, int(blobs)).cpu().numpy())
    return videos


def build_segmenter(run, dev):
    """The port's ``SegmenterInference`` on the seed's weights; the weights
    stay with the run, on the host, for the reference."""
    from openpvsg_torch.infer.segmenter import SegmenterInference

    m = run.config["model"]
    state = gen.segmenter_weights(m, run.seed, dev, run.workload["traffic"]["frame_hw"])
    run.weights = {k: v.cpu() for k, v in state.items()}
    dtype = getattr(torch, run.workload["traffic"]["dtype"])
    seg = SegmenterInference(port_config(run.config), state, dtype=dtype, device=dev)
    del state
    return seg


def run_video(run, seg, frames, root: str) -> int:
    from openpvsg_torch.infer.stages import run_query_tube_vps

    t = run.workload["traffic"]
    return run_query_tube_vps(seg, frames, root, window=t["window"],
                              pipeline_depth=t["pipeline_depth"],
                              windows_per_batch=t["windows_per_batch"])


def warm_up(run, seg, videos, tmp: str) -> None:
    """Every batch shape of the videos: full batches and each ragged tail."""
    t = run.workload["traffic"]
    per_batch = t["window"] * t["windows_per_batch"]
    tails = sorted({len(v) % per_batch for v in videos} | {0})
    for _ in range(2):
        for r in tails:
            run_video(run, seg, videos[0][:per_batch * t["pipeline_depth"] + r],
                      os.path.join(tmp, "warm"))


def run(run) -> None:
    dev = device_of(run)
    t = run.workload["traffic"]
    if dev.type == "cuda":
        from openpvsg_torch.kernels import build

        build.build()
        torch.cuda.set_device(dev)
    seg = build_segmenter(run, dev)
    spanned = SpannedSegmenter(seg, run.spans)
    videos = make_videos(run, dev)
    tmp = tempfile.mkdtemp(prefix="pvsgbench_vps_")
    try:
        warm_up(run, spanned, videos, tmp)
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
                tubes = run_video(run, spanned, videos[k], root)
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
            profile(run, lambda: run_video(run, spanned, sliced, os.path.join(tmp, "traced")),
                    len(sliced))
        del spanned, seg
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        judge(run, videos, done, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def judged_windows(run, videos, done):
    """(video index, output root, first frame, frame count) of the windows
    judged: drawn from the seed over the windows of every video the window
    completed, with the last window of the first video among them."""
    t = run.workload["traffic"]
    W = t["window"]
    cands = []
    seen = set()
    for k, root, _ in done:
        if k in seen:
            continue
        seen.add(k)
        n = len(videos[k])
        cands += [(k, root, lo, min(W, n - lo)) for lo in range(0, n, W)]
    draw = gen.rng(run.seed, 7)
    n_judge = min(int(run.workload["check"]["windows"]), len(cands))
    first_last = max(i for i, c in enumerate(cands) if c[0] == cands[0][0])
    picks = {first_last, *draw.choice(len(cands), size=n_judge - 1, replace=False).tolist()}
    return [cands[i] for i in sorted(picks)][:n_judge]


def program_outputs(root: str):
    masks = ref_vps.read_masks_txt(os.path.join(root, "quantitive", "masks.txt"))
    tubes = ref_vps.read_tubes(os.path.join(root, "query_feats.pickle"))
    return masks, tubes


def fused(run, model, frames, dev, rounding=None):
    """The plain reference's forward and fusion of one window's frames."""
    m, serving = run.config["model"], run.config["serving"]
    cls, masks, q = ref_model.forward_frames(model, frames, rounding)
    return ref_vps.fuse_window(cls, masks, q.cpu().numpy(), frames.shape[1:3],
                               m["num_things_classes"], m["num_stuff_classes"],
                               serving["object_mask_thr"], serving["iou_thr"], dev)


def hold(run, readings: dict, failed: int, segments: int) -> None:
    """The checks of one side: each reading the cell's ``limits`` name, no
    video failed, and at least one segment judged."""
    limits = run.workload["check"]["limits"]
    for name, value in readings.items():
        if name in limits:
            run.check(name, value, limits[name])
    run.check("videos_failed", failed, 0)
    run.check("judged_segments", segments, 1, at_least=True)


def judge(run, videos, done, dev) -> None:
    """The run's checks against the plain reference; with ``run.control``
    the control's too, on a Run of its own (``run.control_run``)."""
    m = run.config["model"]
    nt = m["num_things_classes"]
    failed = 0
    for k, root, tubes in done:
        try:
            masks, tube_feats = program_outputs(root)
        except (OSError, ValueError, EOFError) as e:
            failed += 1
            print(f"pvsgbench: video {k}: unreadable outputs: {e}", file=sys.stderr)
            continue
        n = len(videos[k])
        if (len(tube_feats) != tubes or any(len(v) != n for v in tube_feats.values())
                or any(fid < 1 or fid > n for fid in masks)):
            failed += 1
    run.failed = failed
    model = ref_model.build(m, {k: v.to(dev) for k, v in run.weights.items()}, dev)
    reach = run.workload["check"]["limits"]["segment_gap"]
    prog, ctrl = ref_vps.Verdict(nt, reach), ref_vps.Verdict(nt, reach)
    frames_judged, cache = 0, {}
    for k, root, lo, n in judged_windows(run, videos, done):
        if root not in cache:
            try:
                cache[root] = program_outputs(root)
            except (OSError, ValueError, EOFError):
                cache[root] = ({}, {})
        masks, tube_feats = cache[root]
        frames = torch.from_numpy(videos[k][lo:lo + n]).to(dev)
        refs = fused(run, model, frames, dev)
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
            for fr, c in zip(refs, fused(run, model, frames, dev, rounding="fp8")):
                ctrl.add(fr, c["cls_map"], [(sid % ref_vps.INSTANCE_OFFSET, c["seg_map"] == sid, f)
                                            for sid, f in c["feats"].items()])
        del refs
    run.counters.update(judged_frames=frames_judged, judged_segments=prog.segments)
    readings = prog.readings()
    hold(run, readings, failed, prog.segments)
    run.counters.update({f"reading.{k}": v for k, v in readings.items()})
    if run.control:
        readings = ctrl.readings()
        run.control_run = core.Run(run.args, run.workload, run.config)
        hold(run.control_run, readings, 0, ctrl.segments)
        run.counters.update({f"control.{k}": v for k, v in readings.items()})
    run.verdicts = {"reading": prog, **({"control": ctrl} if run.control else {})}


def kernel_bounds(run):
    """(B1's bound, B2's bound) in seconds for the traced slice's batches."""
    t = run.workload["traffic"]
    m = run.config["model"]
    pd = m["pixel_decoder"]
    per_batch = t["window"] * t["windows_per_batch"]
    H, W = counts.padded_hw(t["frame_hw"])
    batches = run.counters["trace_frames"] // per_batch
    b1 = sum(counts.bound_s(ops, nb, "bfloat16")[0] for ops, nb in counts.fpn_counts(
        per_batch, H // 4, W // 4, pd["in_channels"][0], pd["feat_channels"],
        pd["out_channels"]).values())
    ops, nb = counts.fusion_counts(per_batch, m["num_queries"], H // 4, W // 4)
    b2 = counts.bound_s(ops, nb, "float32")[0]
    return b1 * batches, b2 * batches
