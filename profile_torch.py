#!/usr/bin/env python3
"""Where the time of the port's stage 2 goes, on one NVIDIA GPU.

Runs ``run_query_tube_vps`` (window 2) with the full-width
``mask2former_vps`` model (bf16, random weights from the seed) on synthetic
360x480 frames, as ``chip_smoke.py`` does, once to warm up and once under
``torch.profiler``. Prints JSON lines: the card, the wall time of the
profiled run, the summed device time of its kernels (one stream, so their
sum is the device's busy time) and the idle share, the device time by kernel
family, and the top kernels. Run from the root of the repository:

    python3 profile_torch.py [--seed 0]

With ``--ab OTHER`` it instead compares the unprofiled stage-2 frames/s of
this checkout and another checkout of the repository (for example the parent
commit, unpacked with ``git archive``) on the same card: each checkout runs
stage 2 ``--runs`` times in a process of its own, in the order other, this,
this, other, and one JSON line gives every run and each side's median.

With ``--sass`` it instead prints static SASS instruction counts
(``cuobjdump -sass``) of the fusion kernel's main-path build.

With ``--train`` it instead profiles one stage-1 train step of
``chip_smoke.py``'s train phase (``mask2former_vps`` at full width, float32,
TF32 off, the preset's ``samples_per_gpu`` clips of 2 384x480 frames) after
two warm-up steps: the step's wall time, device busy time and idle share,
the host LAP's time, the device time by kernel family and the top kernels.
``--dtype bfloat16`` profiles the bfloat16 compute step instead (float32
parameters, ``model.backbone.dtype``). ``--process-group`` profiles, in
one process, the plain step and then the step under an NCCL process group
of one rank (``SegmenterTrainer(process_group=...)``), at the 4 clips
``chip_smoke.py``'s ``multi_device`` (d) runs, each from the same state
after two warm-up steps, and adds each one's host operators by self CPU
time.

With ``--ips`` it instead profiles IPS stage 2 as ``chip_smoke.py``'s
``stage2_ips`` phase runs it (``mask2former_ips`` at full width, bf16
segmenter, float32 ``imagenet50 s3`` appearance encoder, random weights
from the seed): one IPS batch (8 360x640 frames through
``infer_frames_ips_async`` and ``package_ips``) after a warm-up batch, and
one tracked frame of the tracker phase's video (frame 60 of its window, the
tracker having run the 59 before): its appearance extraction and its
reconsdot cost each in a window of their own, then the whole ``update``.
For each: wall time, device busy time and idle share, time by kernel family
and the top kernels; for the update also its host milliseconds (wall less
the two device calls' walls).

With ``--reference`` it instead profiles the reference's Mask2Former as
``chip_smoke.py``'s ``reference_model`` phase runs it (``mask2former_vps``
with the MSDA pixel encoder, weights converted from its synthetic mmdet
state dict): one stage-2 window (2 360x480 frames, bf16, forward, stitch
and fusion) after a warm-up window, and one training step with
``loss_sampling='points'`` and ``split_thing_stuff`` (float32, the preset's
``samples_per_gpu`` clips of 2 384x480 frames) after two warm-up steps. For
each: wall time, device busy time and idle share, time by kernel family and
the top kernels.

With ``--swin`` it instead profiles the Swin-T segmenter as
``chip_smoke.py``'s ``swin`` phase runs it (``mask2former_swin_vps`` at full
width, random weights from the seed): one stage-2 window (2 360x480
frames, bf16, forward, stitch and fusion) after a warm-up window, then one
training step (float32, 16 clips of 2 384x480 frames) after two warm-up
steps, once with the host Hungarian and once with LAPJV on the card. For
each: wall time, device busy time and idle share, time by kernel family and
the top kernels; for the steps also the assignment's host milliseconds.

With ``--relation`` it instead profiles the relation head
(``relation_head('transformer')`` at full width, float32, TF32 off, random
weights from the seed): one train step of a video at the largest training
bucket (100 tubes, 1000 frames windowed to 900, 30 GT relations) after two
warm-up steps, and one evaluation video (100 tubes, 1200 frames, padded to
the 100 x 2048 evaluation bucket, 100 pairs) after one warm-up video. For
each: wall time, device busy time and idle share, time by kernel family and
the top kernels.

With ``--streaming`` it instead profiles ``StreamingPVSG`` as
``chip_smoke.py``'s ``end2end`` phase (c) runs it (the full-width
``mask2former_vps`` segmenter in bf16 and ``relation_head('transformer')``,
random weights from the seed; window 2, relation_interval 16, 20 pairs,
max_history 64, 360x480 frames): after 28 frames, one window that scores
no relation (frames 28-29) and one that does (frames 30-31). For each: wall
time, device busy time and idle share, time by kernel family and the top
kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

N_FRAMES = 16  # as chip_smoke.py's stage 2
TOP = 15
# kernel-name substrings -> family, first match wins
FAMILIES = (
    ("fpn_", "B1 fpn (port kernel)"),
    ("grid_sampler", "grid_sample (MSDA, points)"),
    ("sort", "sort"),
    ("roll_cuda", "roll (Swin shift)"),  # not "roll": unrolled_elementwise_kernel
    ("fusion_maps", "B2 fusion (port kernel)"),
    ("conv", "convolution (cuDNN)"),
    ("grad", "convolution (cuDNN)"),
    ("xmma_gemm", "matmul (cuBLAS)"),
    ("xmma", "convolution (cuDNN)"),
    ("adam", "optimizer"),
    ("batch_norm", "batch norm"),
    ("bn_", "batch norm"),
    ("gemm", "matmul (cuBLAS)"),
    ("cutlass", "matmul (cuBLAS)"),
    ("softmax", "softmax"),
    ("logsumexp", "softmax"),
    ("layer_norm", "layer/group norm"),
    ("group_norm", "layer/group norm"),
    ("upsample", "resize"),
    ("reduce", "reductions"),
    ("elementwise", "elementwise"),
    ("copy", "copies"),
    ("index", "gather/index"),
    ("gather", "gather/index"),
)


# one checkout's stage-2 runs, in a process of its own; uses only what both
# sides of a comparison have (chip_smoke's config and frames,
# run_query_tube_vps)
_AB_CHILD = """
import json, os, sys, tempfile, time
tree, seed, runs, n = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
sys.path.insert(0, tree)
import numpy as np, torch
from chip_smoke import stage2_config, synthetic_frames
from openpvsg_torch.infer.segmenter import SegmenterInference
from openpvsg_torch.infer.stages import run_query_tube_vps
from openpvsg_torch.kernels import build
from openpvsg_torch.weights import random_state_dict
build.build()
cfg = stage2_config()
seg = SegmenterInference(cfg, random_state_dict(cfg, seed), dtype=torch.bfloat16)
frames = list(synthetic_frames(np, n, 360, 480, seed))
fps = []
with tempfile.TemporaryDirectory() as tmp:
    run_query_tube_vps(seg, frames[:4], os.path.join(tmp, "warm"), window=2)
    for i in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_query_tube_vps(seg, frames, os.path.join(tmp, str(i)), window=2)
        torch.cuda.synchronize()
        fps.append(n / (time.perf_counter() - t0))
print(json.dumps({"frames_per_s": fps}))
"""


def compare(other: str, seed: int, runs: int, card: str) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    fps = {"other": [], "this": []}
    for side, tree in (("other", other), ("this", here), ("this", here),
                       ("other", other)):
        proc = subprocess.run(
            [sys.executable, "-c", _AB_CHILD, tree, str(seed), str(runs),
             str(N_FRAMES)], cwd=tree, capture_output=True, text=True,
            timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        fps[side] += json.loads(proc.stdout.strip().splitlines()[-1])["frames_per_s"]
    print(json.dumps({"card": card, "frames": N_FRAMES, "other": other,
                      "frames_per_s": fps,
                      "median": {k: statistics.median(v) for k, v in fps.items()}}),
          flush=True)
    return 0


def sass_counts(build, kernel="fusion_maps_kernelILb0E"):
    """Static SASS counts of the fusion kernel (its main-path build, not the
    counting one): the whole kernel and its innermost loop that loads from
    shared memory, blends and reduces across the warp (the two-queries-a-step
    loop), by class. Static: every path in the loop counts once, the rarely
    taken ones included, so this is not a per-pair cost."""
    build.build(["fusion"])
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", build.library_path("fusion")],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    body = text.split(kernel, 1)[1].split("Function :", 1)[0]
    ins = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body)]
    loops = []  # (target, address) of backward branches
    for addr, op, args in ins:
        t = re.search(r"0x([0-9a-f]+)", args)
        if op == "BRA" and t and int(t.group(1), 16) < addr:
            loops.append((int(t.group(1), 16), addr))
    inner = [(a, b) for a, b in loops
             if all(any(a <= x <= b and op.startswith(key) for x, op, _ in ins)
                    for key in ("REDUX.SUM", "FFMA", "LDS"))]
    out = {"kernel": kernel, "kernel_instructions": len(ins)}
    if inner:
        a, b = min(inner, key=lambda ab: ab[1] - ab[0])
        loop = [op.split(".")[0] for x, op, _ in ins if a <= x <= b]
        out.update(loop_instructions=len(loop),
                   loop_fp32=sum(op in ("FFMA", "FMUL", "FADD") for op in loop),
                   loop_mufu=loop.count("MUFU"), loop_lds=loop.count("LDS"),
                   loop_branch=sum(op in ("BRA", "BSSY", "BSYNC") for op in loop))
    return out


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key in low:
            return fam
    return "other"


def summarize(torch, prof, wall, head):
    """Print the device busy time, idle share, time by family and the top
    kernels of a profiled window of ``wall`` seconds."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    by_family, by_name = {}, {}
    for e in kernels:
        fam = family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + e.device_time_total
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total)
    print(json.dumps({
        **head, "wall_s": wall, "kernel_launches": len(kernels),
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall}), flush=True)
    print(json.dumps({"device_ms_by_family": {
        k: v / 1e3 for k, v in sorted(by_family.items(),
                                      key=lambda kv: -kv[1])}}), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    print(json.dumps({"top_kernels": [
        {"name": name[:120], "calls": n, "device_ms": t / 1e3}
        for name, (n, t) in top]}), flush=True)


def host_ops(prof, top=TOP):
    """Print the host operators of a profiled window by self CPU time."""
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:top]
    print(json.dumps({"top_host_ops": [
        {"name": e.key[:120], "calls": e.count, "self_cpu_ms": e.self_cpu_time_total / 1e3}
        for e in rows]}), flush=True)


def profile_train(torch, np, seed, card, dtype="float32", process_group=False):
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import free_port, train_batch
    from openpvsg_torch.config import mask2former_vps
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import random_state_dict

    pvsg = mask2former_vps()
    cfg, clips = pvsg.model, 4 if process_group else pvsg.train.samples_per_gpu
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, dtype=dtype))
    batch = train_batch(np, clips, cfg.num_frames, (360, 480), (384, 480),
                        20, cfg.num_classes, seed)
    kinds = ["plain"]
    if process_group:
        import torch.distributed as dist

        dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
        kinds.append("nccl_world_1")
    state = random_state_dict(cfg, seed)
    try:
        for kind in kinds:
            trainer = SegmenterTrainer(
                cfg, pvsg.train, steps_per_epoch=1000, seed=seed, state_dict=state,
                process_group=dist.group.WORLD if kind == "nccl_world_1" else None)
            for _ in range(2):
                trainer.step(batch)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                trainer.step(batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            summarize(torch, prof, wall, {
                "card": card, "train_step": "mask2former_vps", "dtype": dtype,
                "process_group": kind, "clips": clips, "frames": clips * cfg.num_frames,
                "host_lap_ms": trainer.last_timings["host_lap_s"] * 1e3,
                "cost_wait_ms": trainer.last_timings["cost_wait_s"] * 1e3})
            if process_group:
                host_ops(prof)
            del trainer
            torch.cuda.empty_cache()
    finally:
        if process_group:
            dist.destroy_process_group()
    return 0


def profile_reference(torch, np, seed, card):
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (reference_config, synthetic_frames,
                            synthetic_mmdet_sd, train_batch)
    from openpvsg_torch.config import mask2former_vps
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.kernels import build
    from openpvsg_torch.train.checkpoint import convert_mmdet_mask2former
    from openpvsg_torch.train.segmenter import SegmenterTrainer

    build.build()
    cfg = reference_config(object_mask_thr=0.0, iou_thr=0.1)
    seg = SegmenterInference(cfg, convert_mmdet_mask2former(
        synthetic_mmdet_sd(np, torch, seed), cfg), dtype=torch.bfloat16)
    frames = synthetic_frames(np, 2, 360, 480, seed)
    seg.infer_windows_vps(frames, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        seg.infer_windows_vps(frames, 2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(torch, prof, wall, {"card": card, "window": "mask2former_vps + msda",
                                  "frames": 2, "dtype": "bfloat16"})
    del seg
    pvsg = mask2former_vps()
    tcfg = reference_config(loss_sampling="points", split_thing_stuff=True)
    clips = pvsg.train.samples_per_gpu
    batch = train_batch(np, clips, tcfg.num_frames, (360, 480), (384, 480), 20,
                        tcfg.num_classes, seed)
    trainer = SegmenterTrainer(tcfg, pvsg.train, steps_per_epoch=1000, seed=seed)
    for _ in range(2):
        trainer.step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(torch, prof, wall, {
        "card": card, "train_step": "mask2former_vps + msda, points, split",
        "dtype": "float32", "clips": clips, "frames": clips * tcfg.num_frames,
        "host_lap_ms": trainer.last_timings["host_lap_s"] * 1e3,
        "cost_wait_ms": trainer.last_timings["cost_wait_s"] * 1e3})
    return 0


def profile_swin(torch, np, seed, card):
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (SWIN_TRAIN_CLIPS, swin_config, synthetic_frames,
                            train_batch)
    from openpvsg_torch.config import mask2former_swin
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.kernels import build
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import random_state_dict

    build.build()
    cfg = swin_config(object_mask_thr=0.0, iou_thr=0.1)
    seg = SegmenterInference(cfg, random_state_dict(cfg, seed), dtype=torch.bfloat16)
    frames = synthetic_frames(np, 2, 360, 480, seed)
    seg.infer_windows_vps(frames, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        seg.infer_windows_vps(frames, 2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(torch, prof, wall, {"card": card, "window": "mask2former_swin_vps",
                                  "frames": 2, "dtype": "bfloat16"})
    del seg
    pvsg = mask2former_swin(True)
    batch = train_batch(np, SWIN_TRAIN_CLIPS, pvsg.model.num_frames, (360, 480),
                        (384, 480), 20, pvsg.model.num_classes, seed)
    for assigner in ("hungarian", "lapjv"):
        trainer = SegmenterTrainer(dataclasses.replace(pvsg.model, assigner=assigner),
                                   pvsg.train, steps_per_epoch=1000, seed=seed)
        for _ in range(2):
            trainer.step(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.step(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        summarize(torch, prof, wall, {
            "card": card, "train_step": "mask2former_swin_vps", "assigner": assigner,
            "dtype": "float32", "clips": SWIN_TRAIN_CLIPS,
            "frames": SWIN_TRAIN_CLIPS * pvsg.model.num_frames,
            "assignment_ms": {k: v * 1e3 for k, v in trainer.last_timings.items()}})
        del trainer
    return 0


def profile_relation(torch, np, seed, card):
    from torch.profiler import ProfilerActivity, profile

    from openpvsg_torch.config import relation_head
    from openpvsg_torch.eval.rel_eval import evaluate_video
    from openpvsg_torch.train.relation import RelationTrainer

    cfg = relation_head("transformer").relation
    rng = np.random.default_rng(seed)

    def video(n, t, n_rel):
        rels = []
        for _ in range(n_rel):
            s, o = (int(v) for v in rng.choice(n, 2, replace=False))
            span = np.zeros(t)
            a = int(rng.integers(0, t - 300))
            span[a:a + 300] = 1
            rels.append({"subject_index": s, "object_index": o,
                         "relation": int(rng.integers(0, cfg.num_relations)),
                         "relation_span": span})
        return rng.standard_normal((n, t, cfg.d_model), dtype=np.float32), rels

    trainer = RelationTrainer(cfg, np.ones(cfg.num_relations), rng_seed=seed)
    feats, rels = video(100, 1000, 30)
    for _ in range(2):
        trainer.step(feats, rels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(feats, rels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(torch, prof, wall, {
        "card": card, "relation_train_step": "relation_transformer",
        "dtype": "float32", "tubes": 100, "frames": 900, "gt_relations": 30})

    feats, _ = video(100, 1200, 1)
    evaluate_video(trainer.model, feats, 100, pairwise=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate_video(trainer.model, feats, 100, pairwise=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(torch, prof, wall, {
        "card": card, "relation_eval_video": "relation_transformer",
        "dtype": "float32", "tubes": 100, "frames": 1200, "pairs": 100})
    return 0


def profile_ips(torch, np, seed, card):
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import gt_detections, ips_frames, tracker_video
    from openpvsg_torch.config import TrackerConfig, mask2former_ips
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.kernels import build
    from openpvsg_torch.tracker import matching
    from openpvsg_torch.tracker.appearance import extract_object_embeddings
    from openpvsg_torch.tracker.tracker import MaskAssociationTracker
    from openpvsg_torch.weights import random_appearance_state_dict, random_state_dict

    build.build()
    cfg = dataclasses.replace(mask2former_ips().model, object_mask_thr=0.0,
                              iou_thr=0.1)
    seg = SegmenterInference(cfg, random_state_dict(cfg, seed), dtype=torch.bfloat16)
    frames = ips_frames(np, seed, n=16)
    seg.package_ips(seg.infer_frames_ips_async(frames[:8]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        seg.package_ips(seg.infer_frames_ips_async(frames[8:]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(torch, prof, wall, {"card": card, "ips_batch": "mask2former_ips",
                                  "dtype": "bfloat16", "frames": 8, "frame_hw": [360, 640]})
    del seg

    tcfg = TrackerConfig()
    tracker = MaskAssociationTracker(tcfg, random_appearance_state_dict(tcfg, seed))
    vframes, vmasks, classes = tracker_video(np, seed, n_frames=60)
    rng = np.random.default_rng([seed, 5000])
    feats = {i: rng.standard_normal(256).astype(np.float32) for i in range(1, 21)}
    for t in range(59):
        _, m, qf = gt_detections(np, vmasks[t], classes, feats, rng)
        tracker.update(vframes[t], m, qf)
    _, m, qf = gt_detections(np, vmasks[59], classes, feats, rng)
    tracks = tracker.tracked_stracks + tracker.lost_stracks
    dets = [f.T for f in extract_object_embeddings(tracker.appearance_model,
                                                   vframes[59], m)[0]]
    torch.cuda.synchronize()
    head = {"card": card, "tracked_frame": 60, "detections": len(m), "tracks": len(tracks)}
    walls = {}
    for part, fn in (
            ("appearance", lambda: extract_object_embeddings(
                tracker.appearance_model, vframes[59], m)),
            ("reconsdot", lambda: matching.reconsdot_distance(
                [t.curr_feat for t in tracks], dets, device=tracker.device))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[part] = time.perf_counter() - t0
        summarize(torch, prof, walls[part], {**head, "part": part})
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tracker.update(vframes[59], m, qf)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(torch, prof, wall, {**head, "part": "update",
                                  "host_ms": (wall - sum(walls.values())) * 1e3})
    return 0


def profile_streaming(torch, np, seed, card):
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import stage2_config, stream_frames
    from openpvsg_torch.config import relation_head
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.infer.streaming import StreamingPVSG
    from openpvsg_torch.kernels import build
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.weights import random_relation_state_dict, random_state_dict

    build.build()
    cfg = stage2_config()
    seg = SegmenterInference(cfg, random_state_dict(cfg, seed), dtype=torch.bfloat16)
    rel_cfg = relation_head("transformer").relation
    rel = RelationModel.from_config(rel_cfg)
    rel.load_state_dict(random_relation_state_dict(rel_cfg, seed))
    engine = StreamingPVSG(seg, rel, window=2, relation_interval=16,
                           num_top_pairs=20, max_history=64)
    frames = stream_frames(np, 32, seed)
    for f in frames[:28]:
        engine.push(f)
    for part, (a, b) in (("window", frames[28:30]), ("scoring_window", frames[30:32])):
        engine.push(a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = engine.push(b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        summarize(torch, prof, wall, {
            "card": card, "streaming": part, "frames": out["frames"],
            "scored": out["triplets"] is not None, "tubes": len(engine._tube_cls),
            "ring_shape": list(engine._ring.hist.shape)})
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", metavar="OTHER",
                    help="compare stage-2 frames/s with another checkout")
    ap.add_argument("--runs", type=int, default=3,
                    help="stage-2 runs per process with --ab")
    ap.add_argument("--sass", action="store_true",
                    help="print the fusion kernel's static SASS counts")
    ap.add_argument("--train", action="store_true",
                    help="profile one stage-1 train step instead")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the train step's compute dtype with --train")
    ap.add_argument("--process-group", action="store_true",
                    help="with --train, also profile the step under an NCCL "
                         "process group of one rank")
    ap.add_argument("--relation", action="store_true",
                    help="profile one relation train step and one eval video instead")
    ap.add_argument("--ips", action="store_true",
                    help="profile one IPS batch and one tracked frame instead")
    ap.add_argument("--reference", action="store_true",
                    help="profile one MSDA window and one points train step instead")
    ap.add_argument("--swin", action="store_true",
                    help="profile one Swin-T window and one train step per assigner "
                         "instead")
    ap.add_argument("--streaming", action="store_true",
                    help="profile one streaming window and one scoring window instead")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch: needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import stage2_config, synthetic_frames
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.infer.stages import run_query_tube_vps
    from openpvsg_torch.kernels import build
    from openpvsg_torch.weights import random_state_dict

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card.splitlines()[0], flush=True)
    if args.ab:
        return compare(args.ab, args.seed, args.runs, card.splitlines()[0])
    if args.sass:
        print(json.dumps({"card": card.splitlines()[0], **sass_counts(build)}), flush=True)
        return 0
    if args.train:
        return profile_train(torch, np, args.seed, card.splitlines()[0], args.dtype,
                             args.process_group)
    if args.relation:
        return profile_relation(torch, np, args.seed, card.splitlines()[0])
    if args.ips:
        return profile_ips(torch, np, args.seed, card.splitlines()[0])
    if args.reference:
        return profile_reference(torch, np, args.seed, card.splitlines()[0])
    if args.swin:
        return profile_swin(torch, np, args.seed, card.splitlines()[0])
    if args.streaming:
        return profile_streaming(torch, np, args.seed, card.splitlines()[0])
    build.build()
    cfg = stage2_config()
    seg = SegmenterInference(cfg, random_state_dict(cfg, args.seed),
                             dtype=torch.bfloat16)
    frames = list(synthetic_frames(np, N_FRAMES, 360, 480, args.seed))
    with tempfile.TemporaryDirectory() as tmp:
        run_query_tube_vps(seg, frames, os.path.join(tmp, "warm"), window=2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_query_tube_vps(seg, frames, os.path.join(tmp, "run"), window=2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    summarize(torch, prof, wall, {"card": card.splitlines()[0], "frames": N_FRAMES,
                                  "frames_per_s": N_FRAMES / wall})
    return 0


if __name__ == "__main__":
    sys.exit(main())
