"""Segmenter evaluation CLI, after ``tools/test.py`` (reference:
tools/test.py --eval PQ): IPS inference over a split's frames scored by
PQ / PQ_th / PQ_st, and with ``--eval VPQ`` windowed MinVIS inference per
video scored by window VPQ (``eval/vpq.py:window_vpq``).

  python -m openpvsg_torch.tools.test --config work_dirs/mask2former_vps/config.json \\
      --checkpoint work_dirs/mask2former_vps/epoch_8 --eval PQ,VPQ

``--checkpoint`` is an ``epoch_N`` file of the port's train CLI; without
one the weights are random (with a warning). The forward runs in bfloat16
on the GPU and in float32 on the CPU. Two batches are in flight: the next
batch's upload and forward run while the host packages this one. As in the
JAX tool, one IPS batch of frames of different sizes raises (``np.stack``).
The run ends with a ``summary:`` log line: frames and seconds of each path
(for VPQ also the seconds of GT decoding and scoring within them), peak
device memory and the kernel launch counts.
"""
from __future__ import annotations

import os
import pickle
import time
from collections import deque

import numpy as np

from openpvsg_torch.tools.common import (base_parser, collect_rank_results,
                                         kernel_launches, load_config,
                                         log_summary, maybe_mesh,
                                         partition_videos,
                                         reject_unused_n_time, setup_logging)


def main(argv=None):
    parser = base_parser("Evaluate the segmenter (PQ)")
    parser.add_argument("--checkpoint", required=False, default=None)
    parser.add_argument("--eval", default="PQ")
    parser.add_argument("--out", default=None, help="pickle results path")
    parser.add_argument("--split", default="val")
    parser.add_argument("--batch-size", type=int, default=8)
    args = parser.parse_args(argv)
    reject_unused_n_time(args)
    cfg = load_config(args)

    import torch

    from openpvsg_torch.data.datasets import PVSGImageDataset
    from openpvsg_torch.infer.segmenter import SegmenterInference, resolve_device
    from openpvsg_torch.train.checkpoint import load_model_state
    from openpvsg_torch.weights import random_state_dict

    work_dir = os.path.join(cfg.data.work_dir, cfg.name)
    logger = setup_logging(work_dir, "test")
    launches_before = kernel_launches()

    dataset = PVSGImageDataset(cfg.data.anno_file, cfg.data.data_dir, args.split)
    logger.info(f"eval split {args.split}: {len(dataset)} frames")
    if cfg.model.num_classes != dataset.num_classes:
        raise SystemExit(
            f"model has {cfg.model.num_classes} classes but the annotation "
            f"file defines {dataset.num_classes}; set "
            "model.num_things_classes / model.num_stuff_classes to match")

    if args.checkpoint:
        state = load_model_state(args.checkpoint)
    else:
        state = random_state_dict(cfg.model, 0)
        logger.warning("no checkpoint given: evaluating random weights")
    mesh = maybe_mesh(args.device)
    device = mesh.first if mesh is not None else resolve_device(args.device)
    infer_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    seg = SegmenterInference(cfg.model, state, dtype=infer_dtype, device=device,
                             mesh=mesh)
    if mesh is not None:
        logger.info(f"frame-sharded inference over {mesh.shape['data']} devices")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    summary = {"device": str(device), "dtype": str(infer_dtype).split(".")[-1]}

    if "VPQ" in args.eval:
        # window-k VPQ over stitched tubes: windowed MinVIS inference with
        # segment-id identity across windows, scored per video and averaged
        from openpvsg_torch.data.masks import decode_palette_mask, pan_mm2hb
        from openpvsg_torch.data.pipeline import load_frame, load_mask
        from openpvsg_torch.data.pvsg import PVSGAnnotation, frame_paths
        from openpvsg_torch.eval.vpq import window_vpq

        anno = PVSGAnnotation(cfg.data.anno_file)
        window = cfg.data.ref_seq_len_test
        totals = {}
        n_vids = n_frames = 0
        score_s = 0.0  # GT decode and window_vpq, inside vpq_seconds
        t0 = time.perf_counter()
        for vid in partition_videos(anno.video_ids(args.split)):
            frames = frame_paths(cfg.data.data_dir, vid, "frames")
            masks = frame_paths(cfg.data.data_dir, vid, "masks")
            if not frames or len(frames) != len(masks):
                continue
            objects = anno[vid]["objects"]
            t_score = time.perf_counter()
            gt_seq = [decode_palette_mask(
                load_mask(p), objects, dataset.class_index,
                dataset.num_classes)["gt_panoptic_seg"] for p in masks]
            score_s += time.perf_counter() - t_score
            pred_seq = []
            # one window per replica of the mesh in each forward (one on one
            # device; the same outputs either way); two batches in flight
            wpb = mesh.shape["data"] if mesh is not None else 1
            offsets = list(range(0, len(frames), window * wpb))
            pending, next_i = deque(), 0
            while next_i < len(offsets) or pending:
                while next_i < len(offsets) and len(pending) < 2:
                    lo = offsets[next_i]
                    raw = np.stack([load_frame(p)
                                    for p in frames[lo:lo + window * wpb]])
                    pending.append(seg.infer_windows_vps_async(raw))
                    next_i += 1
                outs = seg.finish_windows_vps(pending.popleft(), window)
                pred_seq.extend(pan_mm2hb(o["pan_results"],
                                          dataset.num_classes) for o in outs)
            t_score = time.perf_counter()
            m = window_vpq(pred_seq, gt_seq, dataset.num_classes,
                           len(dataset.anno.thing_classes),
                           len(dataset.anno.stuff_classes),
                           ign_id=dataset.num_classes)
            score_s += time.perf_counter() - t_score
            n_vids += 1
            n_frames += len(frames)
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + v
            logger.info(f"{vid}: " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(m.items())))
        summary.update(vpq_videos=n_vids, vpq_frames=n_frames,
                       vpq_seconds=time.perf_counter() - t0,
                       vpq_scoring_seconds=score_s)
        parts = collect_rank_results(work_dir, "vpq", (totals, n_vids))
        totals, n_vids = {}, 0
        for t, n in parts or ():  # None on a rank other than 0
            n_vids += n
            for k, v in t.items():
                totals[k] = totals.get(k, 0.0) + v
        if n_vids:
            vpq = {k: v / n_vids for k, v in sorted(totals.items())}
            logger.info("mean over videos: " + " ".join(
                f"{k}={v:.4f}" for k, v in vpq.items()))
            print(vpq)
            summary["vpq"] = vpq
        if args.eval == "VPQ":
            summary.update(peak_gib=_peak_gib(torch, device),
                           launches=kernel_launches(since=launches_before))
            log_summary(logger, summary)
            return summary

    indices = partition_videos(range(len(dataset)))
    results = []
    bs = args.batch_size
    # two batches in flight: batch N+1's decode, upload and forward overlap
    # batch N's fetch
    offsets = list(range(0, len(indices), bs))
    pending, next_i = deque(), 0
    t0 = time.perf_counter()
    while next_i < len(offsets) or pending:
        while next_i < len(offsets) and len(pending) < 2:
            lo = offsets[next_i]
            frames = [dataset[i]["img"] for i in indices[lo:lo + bs]]
            pending.append((lo, seg.infer_frames_ips_async(np.stack(frames))))
            next_i += 1
        lo, handle = pending.popleft()
        outs = seg.package_ips(handle)
        results.extend(o["pan_results"] for o in outs)
        if lo % (bs * 20) == 0:
            logger.info(f"{lo}/{len(indices)}")
    summary.update(ips_frames=len(results), ips_batch=bs,
                   ips_seconds=time.perf_counter() - t0)

    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(results, f)
    if "PQ" in args.eval:
        from openpvsg_torch.eval.vpq import pq_summary

        stats = dataset.frame_stats(results, indices)
        presum = [np.sum([s[j] for s in stats], axis=0) for j in range(4)] \
            if stats else None
        parts = collect_rank_results(work_dir, "pq_stats", presum)
        if parts is None:  # a rank other than 0
            summary.update(peak_gib=_peak_gib(torch, device),
                           launches=kernel_launches(since=launches_before))
            log_summary(logger, summary)
            return summary
        metrics = pq_summary([p for p in parts if p is not None],
                             len(dataset.anno.thing_classes),
                             len(dataset.anno.stuff_classes))
        logger.info(f"PQ={metrics['PQ']:.4f} PQ_th={metrics['PQ_th']:.4f} "
                    f"PQ_st={metrics['PQ_st']:.4f}")
        # per-class table (the reference prints the mmdet PQ table)
        per_class = metrics["per_class"]
        rows = sorted(enumerate(per_class), key=lambda kv: -kv[1])
        logger.info("top per-class PQ:")
        for idx, pq in rows[:20]:
            if pq > 0:
                name = (dataset.anno.classes[idx]
                        if idx < len(dataset.anno.classes) else str(idx))
                logger.info(f"  {name:<24} {pq:.4f}")
        pq = {k: v for k, v in metrics.items() if k != "per_class"}
        print(pq)
        summary["pq"] = pq
    summary.update(peak_gib=_peak_gib(torch, device),
                   launches=kernel_launches(since=launches_before))
    log_summary(logger, summary)
    return summary


def _peak_gib(torch, device):
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


if __name__ == "__main__":
    main()
