"""End-to-end PVSG inference CLI, after ``tools/end2end_inference.py``: the
one command that turns videos into scene graphs (the reference left
tools/end2end_inference.py empty).

For each video: frames -> segmenter -> tube identity (the IPS tracker,
``MaskAssociationTracker``, or VPS MinVIS segment ids) -> the relation head
over the query-feature tubes -> ranked triplets in
``{out_dir}/{vid}/triplets.json``, beside stage 2's ``quantitive/masks.txt``
and ``query_feats.pickle``, with per-stage timing in the log.

  python -m openpvsg_torch.tools.end2end_inference --config mask2former_vps \\
      --ps-type vps --data-dir data --anno-file data/pvsg.json --split val \\
      --checkpoint work_dirs/mask2former_vps/epoch_8 \\
      --relation-checkpoint work_dirs/relation/rel_vps_transformer_lr0.0001/epoch_100 \\
      --out-dir work_dirs/end2end --eval

``--checkpoint`` is an ``epoch_N`` file of the port's train CLI;
``--relation-checkpoint`` an ``epoch_N`` file of ``rel_train`` or the
reference's relation ``.pth`` bundle (either also a ``.npz`` of the
JAX package's checkpoint, written by ``export_jax_checkpoint.py``); ``--appearance-checkpoint`` (IPS) a
torchvision ResNet state dict for the configured appearance encoder.
Without them the weights are random, from ``--seed``, with a warning. The
segmenter runs in bfloat16 on the GPU and in float32 on the CPU
(``--device cpu``); the relation head and the tracker's device work in
IEEE float32. ``--eval`` matches the predicted tubes to the GT tubes
(stage 3, ``run_rel_set``) and runs the mask-grounded protocol
(``evaluate_full``) into ``{out_dir}/protocol_metrics.json``. With two or
more GPUs visible (and no ``--device``) they form a ``(data, time)`` mesh
(``--n-time`` sizes 'time'): the segmenter splits each batch's frames over
'data' and the relation head runs as ``TimeShardedRelation``. A
multi-process run (``--dist-*``) strides the videos over the ranks into the
shared ``--out-dir``; with ``--eval`` every rank matches its own videos and
rank 0, after a barrier, scores them all. The run ends with a ``summary:``
log line: per-video frames, tubes, triplets and seconds (segment and
relation), the protocol metrics, peak device memory and the kernel launch
counts.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from openpvsg_torch.tools.common import (base_parser, kernel_launches,
                                         load_config, load_relation_params,
                                         log_summary, make_relation_executor,
                                         maybe_mesh, partition_videos,
                                         setup_logging)


def relation_triplets(model, tubes, num_frames: int, num_top_pairs: int,
                      relation_names, executor=None):
    """The ranked triplets of one video's tubes in the JAX tool's schema,
    from ``evaluate_video`` over the stacked (N, T, D) tube features (over
    the ``executor``'s mesh when given)."""
    from openpvsg_torch.eval.rel_eval import evaluate_video

    feats = np.stack([t.as_array(num_frames)[0] for t in tubes]).astype(np.float32)
    tube_ids = [t.track_id for t in tubes]
    triplets = []
    ranked = evaluate_video(model, feats, num_top_pairs, pairwise=False,
                            executor=executor)[1]
    for r in ranked[:num_top_pairs]:
        spans = np.flatnonzero(r["relation_span"])
        triplets.append({
            "subject_tube": tube_ids[r["subject_index"]],
            "object_tube": tube_ids[r["object_index"]],
            "relation": int(r["relation"]),
            "relation_name": relation_names[int(r["relation"])]
            if r["relation"] < len(relation_names) else None,
            "span": [int(spans[0]), int(spans[-1])] if spans.size else None,
        })
    return triplets


def main(argv=None):
    parser = base_parser("End-to-end PVSG inference")
    parser.add_argument("--checkpoint", default=None, help="segmenter checkpoint")
    parser.add_argument("--relation-checkpoint", default=None)
    parser.add_argument("--appearance-checkpoint", default=None,
                        help="IPS: torchvision ResNet state dict (.pth)")
    parser.add_argument("--model-name", default="transformer")
    parser.add_argument("--ps-type", default="vps", choices=["ips", "vps"])
    parser.add_argument("--split", default="val")
    parser.add_argument("--videos", nargs="*", default=None)
    parser.add_argument("--out-dir", default=None)
    parser.add_argument("--num-top-pairs", type=int, default=100)
    parser.add_argument("--eval", action="store_true",
                        help="after inference, match pred tubes to GT and "
                             "run the mask-grounded protocol (needs GT "
                             "masks + relations for the split)")
    args = parser.parse_args(argv)
    cfg = load_config(args)

    import torch

    from openpvsg_torch.data import io as data_io
    from openpvsg_torch.data.pvsg import PVSGAnnotation, frame_paths
    from openpvsg_torch.infer import stages
    from openpvsg_torch.infer.segmenter import SegmenterInference, resolve_device
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.train.checkpoint import load_model_state
    from openpvsg_torch.weights import random_relation_state_dict, random_state_dict

    mesh = maybe_mesh(args.device, n_time=args.n_time)
    device = mesh.first if mesh is not None else resolve_device(args.device)
    out_dir = args.out_dir or os.path.join(cfg.data.work_dir, "end2end")
    logger = setup_logging(out_dir, "end2end")
    launches_before = kernel_launches()

    anno = PVSGAnnotation(cfg.data.anno_file)
    videos = partition_videos(args.videos or anno.video_ids(args.split))

    # --- segmenter
    if args.checkpoint:
        state = load_model_state(args.checkpoint, cfg.model)
    else:
        state = random_state_dict(cfg.model, args.seed)
        logger.warning("no segmenter checkpoint: random weights")
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    seg = SegmenterInference(cfg.model, state, dtype=dtype, device=device,
                             mesh=mesh)
    if mesh is not None:
        logger.info(f"frame-sharded inference over {mesh.shape['data']} devices")

    # --- relation head (--set relation.* gives its capacity)
    rel_cfg = dataclasses.replace(cfg.relation, model_name=args.model_name)
    if args.relation_checkpoint:
        rel_model = load_relation_params(args.relation_checkpoint,
                                         args.model_name, device, rel_cfg)
    else:
        rel_model = RelationModel.from_config(rel_cfg)
        rel_model.load_state_dict(random_relation_state_dict(rel_cfg, args.seed + 2))
        rel_model = rel_model.to(device).eval()
        logger.warning("no relation checkpoint: random weights")
    # relation scoring over the mesh too: pairs split over 'data', frames
    # over 'time'
    executor = make_relation_executor(mesh, rel_model)

    app_state = None
    if args.ps_type == "ips":
        from openpvsg_torch.tools.prepare_query_tube_ips import load_torch_state_dict
        from openpvsg_torch.tracker.tracker import MaskAssociationTracker
        from openpvsg_torch.weights import (appearance_state,
                                            convert_torchvision_resnet,
                                            random_appearance_state_dict)

        if args.appearance_checkpoint:
            app_state = appearance_state(convert_torchvision_resnet(
                load_torch_state_dict(args.appearance_checkpoint)), cfg.tracker)
        else:
            app_state = random_appearance_state_dict(cfg.tracker, args.seed + 1)
            logger.warning("no appearance checkpoint: random weights")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    summary = {"device": str(device), "dtype": str(dtype).split(".")[-1],
               "ps_type": args.ps_type, "per_video": []}
    for vid in videos:
        frames = frame_paths(cfg.data.data_dir, vid, "frames")
        if not frames:
            logger.warning(f"{vid}: no frames")
            continue
        t0 = time.perf_counter()
        save_root = os.path.join(out_dir, vid)

        # stage A: segment + tube extraction
        if args.ps_type == "ips":
            tracker = MaskAssociationTracker(cfg.tracker, app_state, device=device)
            stages.run_query_tube_ips(seg, tracker, frames, save_root)
        else:
            stages.run_query_tube_vps(seg, frames, save_root,
                                      window=cfg.data.ref_seq_len_test)
        t_seg = time.perf_counter() - t0

        # stage B: relation prediction over tubes
        tubes = data_io.load_pickle(os.path.join(save_root, "query_feats.pickle"))
        T = len(frames)
        row = {"vid": vid, "frames": T, "tubes": len(tubes), "triplets": 0,
               "segment_seconds": t_seg}
        summary["per_video"].append(row)
        if not tubes:
            logger.info(f"{vid}: no tubes")
            continue
        triplets = relation_triplets(rel_model, tubes, T, args.num_top_pairs,
                                     anno.relations, executor)
        with open(os.path.join(save_root, "triplets.json"), "w") as f:
            json.dump(triplets, f, indent=1)
        t_total = time.perf_counter() - t0
        row.update(triplets=len(triplets), relation_seconds=t_total - t_seg)
        logger.info(
            f"{vid}: {T} frames, {len(tubes)} tubes, {len(triplets)} triplets"
            f" | segment {t_seg:.2f}s relation {t_total - t_seg:.2f}s"
            f" | {T / t_total:.2f} frames/s")

    if args.eval:
        summary["protocol"] = _run_protocol_eval(args, cfg, videos, out_dir,
                                                 rel_model, executor, logger)
    summary.update(peak_gib=(torch.cuda.max_memory_allocated(device) / 2 ** 30
                             if device.type == "cuda" else None),
                   launches=kernel_launches(since=launches_before))
    log_summary(logger, summary)
    return summary


def _run_protocol_eval(args, cfg, videos, out_dir, rel_model, executor, logger):
    """The mask-grounded protocol over the just-produced tubes: stage-3 GT
    matching (``run_rel_set``) per video, then the ``rel_test_full`` metrics
    (reference: tools/rel_test_full.py:96-241). Returns the metrics written
    to ``protocol_metrics.json``, or None when no video kept a relation
    set or on a rank other than 0 (each rank matches its own videos; rank 0
    scores them all after a barrier)."""
    from openpvsg_torch.data.datasets import PVSGRelationDataset
    from openpvsg_torch.data.pvsg import PVSGRelationAnnotation, frame_paths
    from openpvsg_torch.eval.rel_full_eval import evaluate_full
    from openpvsg_torch.infer import stages
    from openpvsg_torch.parallel.mesh import rank, world

    rel_anno = PVSGRelationAnnotation(cfg.data.anno_file, args.split)
    matched = 0
    for vid in videos:
        if not frame_paths(cfg.data.data_dir, vid, "masks"):
            logger.warning(f"--eval: {vid} has no GT masks; skipped")
            continue
        if stages.run_rel_set(vid, out_dir, rel_anno, cfg.data.data_dir):
            matched += 1
    logger.info(f"--eval: GT-matched tubes for {matched} video(s)")
    if world() > 1:
        import torch.distributed as dist

        dist.barrier()
        if rank() != 0:
            return None

    ds = PVSGRelationDataset(cfg.data.anno_file, args.split, out_dir,
                             return_mask=True)
    if len(ds) == 0:
        logger.warning("--eval: no video produced relations.pickle; "
                       "protocol metrics skipped")
        return None
    out = evaluate_full(rel_model, (ds[i] for i in range(len(ds))), rel_anno,
                        cfg.data.data_dir, args.num_top_pairs, executor=executor)
    for tag, metrics in (("", out["metrics"]), ("Soft ", out["soft_metrics"])):
        for K in (20, 50, 100):
            m = metrics[K]
            logger.info(f"{tag}R@{K}: {100 * m['recall']:.2f}  "
                        f"mR@{K}: {100 * m['mean_recall']:.2f}  "
                        f"wR@{K}: {100 * m['weak_recall']:.2f}  "
                        f"wmR@{K}: {100 * m['weak_mean_recall']:.2f}")
    protocol = {tag: {str(K): {k: float(v) for k, v in metrics[K].items()
                               if isinstance(v, (int, float))}
                      for K in (20, 50, 100)}
                for tag, metrics in (("standard", out["metrics"]),
                                     ("soft", out["soft_metrics"]))}
    with open(os.path.join(out_dir, "protocol_metrics.json"), "w") as f:
        json.dump(protocol, f, indent=1)
    return protocol


if __name__ == "__main__":
    main()
