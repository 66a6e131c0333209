"""Reference-scale stress, after ``tools/stress_reference_scale.py``: the
port at the reference's real operating point (~76 s videos at 5 FPS, about
380 frames; tubes subsampled to at most 100 and frame windows to at most
900, reference tools/rel_train.py:61,106-160), on the GPU unless
``--device cpu``:

- ``relation``: one gradient step and the eval forward at the largest
  relation buckets, (100 tubes, 900 frames) and (100, 200) (a (20, 128)
  cell on the CPU);
- ``streaming``: ``StreamingPVSG`` over 2000 frames (400 on the CPU) with
  ``max_history`` 900: per-interval relation latency and flat memory. Its
  segmenter is the stage-2 model (``--stream-segmenter model``, the
  default: kernels B1 and B2 launch every window) on synthetic 360x480
  frames, or the JAX tool's stub of 50 random tubes per
  frame (``stub``);
- ``stage3`` and ``protocol``: stage 3 (``run_rel_set``) and the final
  protocol (``evaluate_full``) on one generated 380-frame 360x640 video, on
  the host;
- ``stage2``: VPS stage 2 (``run_query_tube_vps``) of the
  ``mask2former_vps`` model with random weights over the videos of
  ``--data-dir`` (bf16 on the GPU).

The report keeps the JAX tool's keys, with two changes: the time JAX
reports as compile time is the first call's (``first_call_s`` for
``compile_s``), and the device memory is ``torch.cuda.max_memory_allocated``
since the section or cell began (``device_peak_mb`` for XLA's
``hbm_{args,temp,out}_mb``; None on the CPU). A relation cell's ``gflops``
counts the step's matmuls and convolutions (``torch.utils.flop_counter``),
not every operation as XLA's cost analysis does. The stage-2 and streaming
sections add the kernels' ``launches``.

  python -m openpvsg_torch.tools.stress_reference_scale \\
      --sections relation,streaming --out stress.json
  python -m openpvsg_torch.tools.stress_reference_scale --sections stage2 \\
      --data-dir D --anno-file D/pvsg.json --set model.object_mask_thr=0.0
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import time

import numpy as np


def _rss_mb() -> float:
    """Current resident set (VmRSS), not ru_maxrss: the peak is monotone by
    definition and cannot tell a leak from one late transient."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device):
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_mb(device):
    import torch

    if device.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 1e6, 1)


def _zero_launches():
    from openpvsg_torch.kernels import fpn, fusion

    wrappers = fpn.KERNEL_WRAPPERS + fusion.KERNEL_WRAPPERS
    for fn in wrappers:
        fn.launches = 0
    return wrappers


def _synthetic_relation_video(rng, n_tubes, t_frames, n_rels, num_relations,
                              d=256):
    feats = rng.standard_normal((n_tubes, t_frames, d)).astype(np.float32)
    rels = []
    for _ in range(n_rels):
        s, o = rng.choice(n_tubes, 2, replace=False)
        span = np.zeros(t_frames)
        lo = int(rng.integers(0, max(t_frames - 10, 1)))
        span[lo:lo + int(rng.integers(5, t_frames - lo + 1))] = 1
        rels.append({"subject_index": int(s), "object_index": int(o),
                     "relation": int(rng.integers(0, num_relations)),
                     "relation_span": span})
    return feats, rels


def stress_relation(report, device, cells=None):
    """Gradient step and eval forward at the reference's largest buckets."""
    from torch.utils.flop_counter import FlopCounterMode

    from openpvsg_torch.config import RelationHeadConfig
    from openpvsg_torch.eval.rel_eval import evaluate_video
    from openpvsg_torch.train.relation import (RelationTrainer, build_batch,
                                               subsample_video)

    on_gpu = device.type == "cuda"
    cfg = RelationHeadConfig()  # reference transformer capacity, R=57
    counts = np.ones(cfg.num_relations)
    trainer = RelationTrainer(cfg, counts, rng_seed=0, device=device)
    rng = np.random.default_rng(0)
    out = {}
    # (tubes, frames, relations): the 900-frame cell caps pairs at
    # 10000 // 900 = 11 (reference rel_train.py budget); the 200-frame cell
    # hits the 50-pair bucket
    if cells is None:
        cells = ((100, 900, 60), (100, 200, 60)) if on_gpu else ((20, 128, 8),)
    for n, t, r in cells:
        feats, rels = _synthetic_relation_video(rng, n, t, r, cfg.num_relations)
        fs, rs, span = subsample_video(feats, rels, cfg, trainer.rng)
        batch = build_batch(fs, rs, span, cfg, trainer.rng)
        cell = {"tube_bucket": batch.feats.shape[0],
                "frame_bucket": batch.feats.shape[1],
                "pair_bucket": int(batch.pair_feats.shape[0])}
        _reset_peak(device)
        t0 = time.perf_counter()
        loss, _, _ = trainer.loss_and_grads(batch)
        float(loss.detach())
        cell["first_call_s"] = round(time.perf_counter() - t0, 3)
        with FlopCounterMode(display=False) as counter:
            trainer.loss_and_grads(batch)
        cell["gflops"] = round(counter.get_total_flops() / 1e9, 1)

        # steady step time: the difference of a short and a long run of
        # steps accumulated as the trainer accumulates them
        def run(k):
            loss = None
            for _ in range(k):
                loss, _, grads = trainer.loss_and_grads(batch)
                trainer.accumulate(grads, 1)
            return float(loss.detach())

        run(1)
        deltas = []
        n_short, n_long = (2, 8) if on_gpu else (1, 2)
        for _ in range(3 if on_gpu else 1):
            t0 = time.perf_counter()
            run(n_short)
            ts = time.perf_counter() - t0
            t0 = time.perf_counter()
            run(n_long)
            tl = time.perf_counter() - t0
            deltas.append((tl - ts) / (n_long - n_short))
        cell["grad_step_ms"] = round(1e3 * float(np.median(deltas)), 1)
        trainer._accum, trainer._accum_count = None, 0
        cell["device_peak_mb"] = _peak_mb(device)

        # the eval forward at the same scale (rel_eval buckets T to 1024)
        t0 = time.perf_counter()
        _, results = evaluate_video(trainer.model, feats, num_top_pairs=100)
        cell["eval_first_call_s"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        evaluate_video(trainer.model, feats, num_top_pairs=100)
        cell["eval_steady_s"] = round(time.perf_counter() - t0, 3)
        cell["eval_results"] = len(results)
        out[f"N{n}_T{t}"] = cell
        print(f"relation N={n} T={t}: {cell}", flush=True)
    report["relation"] = out


class _StubSegmenter:
    """The JAX tool's stand-in: drives StreamingPVSG's bookkeeping and
    relation path without the segmenter's cost; every window reports the
    same ``n_tubes`` segments with random 256-d features."""

    def __init__(self, n_tubes, device, seed=0):
        self.rng = np.random.default_rng(seed)
        self.n_tubes = n_tubes
        self.device = device

    def infer_window_vps(self, frames):
        outs = []
        for _ in range(frames.shape[0]):
            outs.append({
                "pan_results": np.zeros(frames.shape[1:3], np.int64),
                "query_feats": {
                    1000 + k: self.rng.standard_normal(256).astype(np.float32)
                    for k in range(self.n_tubes)},
            })
        return outs


def stream_frame(i: int, h: int, w: int, rng) -> np.ndarray:
    """Frame ``i`` of a synthetic stream: noise, two blocks moving back and
    forth and a static floor strip."""
    frame = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    bw, bh = max(w // 4, 1), max(h // 3, 1)
    x0 = (12 * i) % max(w - bw, 1)
    frame[h // 6:h // 6 + bh, x0:x0 + bw] = (250, 30, 30)
    x1 = (w - bw) - (8 * i) % max(w - bw, 1)
    frame[h // 2:h // 2 + bh // 2, x1:x1 + bw // 2] = (30, 30, 250)
    frame[5 * h // 6:] = (30, 250, 30)
    return frame


def model_segmenter(model_cfg, device):
    """The stage-2 segmenter with random weights from seed 0: bf16 on the
    GPU, float32 on the CPU."""
    import torch

    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.weights import random_state_dict

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return SegmenterInference(model_cfg, random_state_dict(model_cfg, 0),
                              dtype=dtype, device=device)


def stress_streaming(report, device, total_frames=2000, n_tubes=50,
                     max_history=900, interval=32, device_history=True,
                     segmenter=None):
    """StreamingPVSG at scale: per-interval relation latency and flat memory
    over a long stream, on either history backend. ``segmenter`` None is
    the stub of ``n_tubes`` tubes on zero 64x64 frames; a
    ``SegmenterInference`` runs on synthetic 360x480 frames."""
    from openpvsg_torch.config import RelationHeadConfig
    from openpvsg_torch.infer.streaming import StreamingPVSG
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.weights import random_relation_state_dict

    cfg = RelationHeadConfig()
    rel_model = RelationModel.from_config(cfg)
    rel_model.load_state_dict(random_relation_state_dict(cfg, 2))
    stub = segmenter is None
    seg = _StubSegmenter(n_tubes, device) if stub else segmenter
    engine = StreamingPVSG(seg, rel_model, window=4, relation_interval=interval,
                           num_top_pairs=20, max_history=max_history,
                           device_history=device_history)
    frame_hw = (64, 64) if stub else (360, 480)
    h, w = frame_hw
    rng = np.random.default_rng(0)
    zero = np.zeros((h, w, 3), np.uint8)
    lat, rss, state_frames = [], [], []
    _reset_peak(device)
    wrappers = _zero_launches()
    _sync(device)
    t_push0 = time.perf_counter()
    for i in range(total_frames):
        frame = zero if stub else stream_frame(i, h, w, rng)
        t0 = time.perf_counter()
        out = engine.push(frame)
        dt = time.perf_counter() - t0
        if out is not None and out["triplets"] is not None:
            lat.append(dt)
            rss.append(_rss_mb())
            state_frames.append(
                engine._ring.t_valid * len(engine._ring.live_tids())
                if engine.device_history else
                sum(len(d) for d in engine._tubes.values()))
    _sync(device)
    wall = time.perf_counter() - t_push0
    launches = {fn.__name__: fn.launches for fn in wrappers}
    fin = engine.finish()
    if not lat:
        raise RuntimeError("streaming: no interval was scored (no tube was "
                           "ever kept)")
    steady = lat[len(lat) // 2:]
    report["streaming"] = {
        "total_frames": total_frames, "n_tubes": n_tubes if stub else None,
        "segmenter": "stub" if stub else "model", "frame_hw": list(frame_hw),
        "max_history": max_history, "relation_interval": interval,
        "device_history": device_history,
        "intervals_scored": len(lat),
        "first_interval_s": round(lat[0], 3),
        "steady_interval_ms_median": round(1e3 * float(np.median(steady)), 2),
        "steady_interval_ms_p90": round(
            1e3 * float(np.percentile(steady, 90)), 2),
        "tube_state_frames_max": int(max(state_frames)),
        "tube_state_bound": (n_tubes if stub else len(engine._object_list)) * max_history,
        "rss_mb_first": round(rss[0], 1), "rss_mb_last": round(rss[-1], 1),
        # flatness: current RSS at each quartile of the scored intervals (a
        # leak shows as a monotone staircase, a transient as one bump)
        "rss_mb_quartiles": [round(rss[i], 1) for i in
                             (0, len(rss) // 4, len(rss) // 2,
                              3 * len(rss) // 4, len(rss) - 1)],
        "wall_s": round(wall, 2),
        "frames_per_sec_incl_stub": round(total_frames / wall, 2),
        "num_tubes_final": fin["num_tubes"],
        "device_peak_mb": _peak_mb(device),
        "launches": launches,
    }
    print(f"streaming: {report['streaming']}", flush=True)


def stress_stage3_protocol(report, sections, root, device, n_frames=380, h=360,
                           w=640, max_things=18, seed=0):
    """Host-side stages 3 and 5 at the reference operating point: one
    ~380-frame video with real (H, W) masks and oracle stage-2 tubes, then

      stage3   — ``run_rel_set`` (masks.txt RLE decode, GT PNG decode, the
                 C++ per-frame IoU matching, relation translation,
                 relations.pickle write), per-video seconds, and each part
                 timed alone;
      protocol — ``evaluate_full`` (ranked-triplet forward and
                 mask-grounded vIoU against the raw GT), per-video seconds,
                 with the vIoU loop instrumented.

    The reference's evaluator re-reads GT mask PNGs for every (relation,
    prediction) pair; the port decodes each video's GT tube once
    (``GtTubeCache``). ``naive_reread_estimate_s`` = the GT-frame lookups of
    the vIoU loop times the measured per-frame PNG decode cost."""
    from openpvsg_torch.config import RelationHeadConfig
    from openpvsg_torch.data import io as data_io
    from openpvsg_torch.data.datasets import PVSGRelationDataset
    from openpvsg_torch.data.pipeline import load_mask
    from openpvsg_torch.data.pvsg import PVSGRelationAnnotation, frame_paths
    from openpvsg_torch.data.synthetic import make_dataset, write_oracle_stage2
    from openpvsg_torch.eval.relation_matching import (
        compact_matching_dict, match_gt_tubes, translate_gt_relations)
    from openpvsg_torch.infer.stages import run_rel_set

    split = "val"
    anno_file = os.path.join(root, "pvsg.json")
    if not os.path.exists(anno_file):
        print(f"stage3: generating {n_frames}-frame {h}x{w} video under "
              f"{root} (setup, unmeasured; reused on a re-run)", flush=True)
        make_dataset(root, n_train=0, n_val=1, n_frames=n_frames, h=h, w=w,
                     seed=seed, style="rich", max_things=max_things)
    anno = PVSGRelationAnnotation(anno_file, split)
    vid = anno.split_video_ids[0]
    info = anno[vid]
    work_dir = os.path.join(root, "work")
    qf_dir = os.path.join(work_dir, f"{split}_save_qf")
    masks_txt = os.path.join(qf_dir, vid, "quantitive", "masks.txt")

    t0 = time.perf_counter()
    if not os.path.exists(masks_txt):
        write_oracle_stage2(root, anno_file, work_dir, split, seed=seed)
    oracle_s = time.perf_counter() - t0

    s3 = {"video": vid, "frames": n_frames, "h": h, "w": w,
          "n_gt_objects": len(info["objects"]),
          "n_gt_relations": len(info["relations"]),
          "oracle_stage2_s": round(oracle_s, 1)}

    # the parts of run_rel_set, each timed alone
    t0 = time.perf_counter()
    pred_tubes = data_io.get_pred_mask_tubes(masks_txt)
    s3["rle_decode_s"] = round(time.perf_counter() - t0, 2)
    s3["n_pred_tubes"] = len(pred_tubes)
    t0 = time.perf_counter()
    gt_pan = np.stack([load_mask(p) for p in frame_paths(root, vid, "masks")])
    s3["gt_decode_s"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    matching = match_gt_tubes(gt_pan, info["objects"], pred_tubes)
    s3["match_s"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    translated = translate_gt_relations(compact_matching_dict(matching),
                                        info["relations"])
    s3["translate_s"] = round(time.perf_counter() - t0, 3)
    s3["n_translated_relations"] = len(translated)
    del gt_pan, pred_tubes

    # the real stage-3 call end to end (all of the above, the query-feature
    # join and the relations.pickle write)
    t0 = time.perf_counter()
    out = run_rel_set(vid, qf_dir, anno, root)
    s3["rel_set_s"] = round(time.perf_counter() - t0, 2)
    if out is None:
        raise RuntimeError("run_rel_set produced no relations.pickle")
    report["stage3"] = s3
    print(f"stage3: {s3}", flush=True)

    if "protocol" not in sections:
        return

    from openpvsg_torch.eval import rel_full_eval
    from openpvsg_torch.eval.rel_eval import evaluate_video
    from openpvsg_torch.eval.rel_full_eval import evaluate_full
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.weights import random_relation_state_dict

    cfg = RelationHeadConfig(num_relations=len(anno.relations))
    model = RelationModel.from_config(cfg)
    model.load_state_dict(random_relation_state_dict(cfg, 0))
    model = model.to(device).eval()
    ds = PVSGRelationDataset(anno_file, split, qf_dir, return_mask=True)
    if not len(ds):
        raise RuntimeError("no relations.pickle found: stage3 must run first")

    # the forward alone at this scale, after a warm-up call
    item = ds[0]
    feats = np.asarray(item["feats"], np.float32)
    evaluate_video(model, feats, num_top_pairs=100, pairwise=False)
    t0 = time.perf_counter()
    _, results = evaluate_video(model, feats, num_top_pairs=100, pairwise=False)
    forward_s = time.perf_counter() - t0

    # instrument the vIoU loop: call count, time inside, GT-frame lookups
    stats = {"calls": 0, "s": 0.0, "gt_frame_lookups": 0}
    orig_viou = rel_full_eval.calculate_viou

    def counting_viou(gt_set, pred_set, gt_tubes):
        t0 = time.perf_counter()
        r = orig_viou(gt_set, pred_set, gt_tubes)
        stats["s"] += time.perf_counter() - t0
        stats["calls"] += 1
        # the real loop's skip: frames at or past either len(gt_tubes) or
        # len(pred_span) never look a GT mask up
        limit = min(len(gt_tubes), len(pred_set[2]))
        stats["gt_frame_lookups"] += sum(
            max(0, min(e + 1, limit) - min(s, limit)) for s, e in gt_set[2])
        return r

    rel_full_eval.calculate_viou = counting_viou
    try:
        t0 = time.perf_counter()
        evaluate_full(model, (ds[i] for i in range(len(ds))), anno, root,
                      num_top_pairs=100)
        protocol_s = time.perf_counter() - t0
    finally:
        rel_full_eval.calculate_viou = orig_viou

    per_frame_decode_s = s3["gt_decode_s"] / n_frames
    report["protocol"] = {
        "videos": len(ds), "num_top_pairs": 100,
        "n_ranked_results": len(results),
        "forward_s_per_video": round(forward_s, 2),
        "protocol_s_per_video": round(protocol_s / len(ds), 2),
        "viou_calls": stats["calls"],
        "viou_s_total": round(stats["s"], 2),
        "viou_gt_frame_lookups": stats["gt_frame_lookups"],
        "gt_decode_once_s": s3["gt_decode_s"],
        "naive_reread_estimate_s": round(
            stats["gt_frame_lookups"] * per_frame_decode_s, 1),
    }
    print(f"protocol: {report['protocol']}", flush=True)


def stress_stage2(report, cfg, videos, device, window=4, pipeline_depth=2):
    """Long-video VPS stage 2: wall, frames/s, outputs, device memory and
    the kernels' launches, per video."""
    from openpvsg_torch.data.pvsg import frame_paths
    from openpvsg_torch.infer.stages import run_query_tube_vps

    seg = model_segmenter(cfg.model, device)
    out = {}
    work = os.path.join(cfg.data.work_dir, "stress_stage2")
    for vid in videos:
        files = frame_paths(cfg.data.data_dir, vid, "frames")
        if not files:
            continue
        _reset_peak(device)
        wrappers = _zero_launches()
        _sync(device)
        t0 = time.perf_counter()
        n = run_query_tube_vps(seg, files, os.path.join(work, vid),
                               window=window, pipeline_depth=pipeline_depth)
        _sync(device)
        wall = time.perf_counter() - t0
        out[vid] = {"frames": len(files), "tubes": n,
                    "wall_s": round(wall, 2),
                    "fps": round(len(files) / wall, 2),
                    "device_peak_mb": _peak_mb(device),
                    "launches": {fn.__name__: fn.launches for fn in wrappers}}
        print(f"stage2 {vid}: {out[vid]}", flush=True)
    report["stage2"] = out


def main(argv=None):
    p = argparse.ArgumentParser(description="Reference-scale stress")
    p.add_argument("--sections", default="relation,streaming",
                   help="comma list of relation,streaming,stage2,"
                        "stage3,protocol")
    p.add_argument("--s3-root", default="work_dirs/stress_s3",
                   help="stage3/protocol: dir for the generated "
                        "reference-scale video (reused if present)")
    p.add_argument("--s3-frames", type=int, default=380)
    p.add_argument("--s3-size", type=int, nargs=2, default=(360, 640))
    p.add_argument("--s3-max-things", type=int, default=18)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--anno-file", default=None)
    p.add_argument("--work-dir", default="work_dirs")
    p.add_argument("--videos", nargs="*", default=None)
    p.add_argument("--frames", type=int, default=None,
                   help="streaming: total frames (2000 on the GPU, 400 on "
                        "the CPU)")
    p.add_argument("--host-history", action="store_true",
                   help="streaming: the host dict history backend instead "
                        "of the device ring")
    p.add_argument("--stream-segmenter", default="model", choices=("model", "stub"),
                   help="streaming: the stage-2 model (B1 and B2 launch) or "
                        "the JAX tool's stub of 50 random tubes")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted overrides of the mask2former_vps preset for "
                        "the stage2 and streaming segmenter")
    p.add_argument("--device", default=None,
                   help="torch device; the GPU unless 'cpu' is asked for")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from openpvsg_torch.config import (apply_overrides, mask2former_vps,
                                       parse_set_args)
    from openpvsg_torch.infer.segmenter import resolve_device

    device = resolve_device(args.device)
    on_gpu = device.type == "cuda"
    report = {"platform": "gpu" if on_gpu else "cpu",
              "device_kind": torch.cuda.get_device_name(device) if on_gpu else "cpu"}
    cfg = apply_overrides(mask2former_vps(), parse_set_args(args.set))
    sections = args.sections.split(",")
    if "relation" in sections:
        stress_relation(report, device)
    if "streaming" in sections:
        seg = (model_segmenter(cfg.model, device)
               if args.stream_segmenter == "model" else None)
        stress_streaming(report, device,
                         total_frames=args.frames or (2000 if on_gpu else 400),
                         device_history=not args.host_history, segmenter=seg)
    if "stage3" in sections or "protocol" in sections:
        stress_stage3_protocol(report, sections, args.s3_root, device,
                               n_frames=args.s3_frames,
                               h=args.s3_size[0], w=args.s3_size[1],
                               max_things=args.s3_max_things)
    if "stage2" in sections:
        if not (args.data_dir and args.anno_file):
            raise SystemExit("stage2 needs --data-dir/--anno-file with a "
                             "long video (python -m openpvsg_torch.tools"
                             ".make_synthetic_data --frames 400)")
        from openpvsg_torch.data.pvsg import PVSGAnnotation

        cfg = apply_overrides(cfg, {"data.data_dir": args.data_dir,
                                    "data.anno_file": args.anno_file,
                                    "data.work_dir": args.work_dir})
        anno = PVSGAnnotation(cfg.data.anno_file)
        videos = args.videos or anno.video_ids("val")
        stress_stage2(report, cfg, videos, device)

    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
