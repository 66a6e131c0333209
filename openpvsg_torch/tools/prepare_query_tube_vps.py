"""Stage 2 (VPS) CLI, after ``tools/prepare_query_tube_vps.py`` (reference:
tools/prepare_query_tube_vps.py; the reference as committed iterated only
ego4d, this iterates every source): per-video windowed MinVIS inference ->
``{work_dir}/{split}_save_qf/{vid}/quantitive/masks.txt`` and
``query_feats.pickle``, through ``infer/stages.py:run_query_tube_vps``.

  python -m openpvsg_torch.tools.prepare_query_tube_vps --config mask2former_vps \\
      --data-dir data --anno-file data/pvsg.json --work-dir work_dirs \\
      --split val --checkpoint work_dirs/mask2former_vps/epoch_8

``--checkpoint`` is an ``epoch_N`` file of the port's train CLI; without one
the weights are random (with a warning). The forward runs in bfloat16 on
the GPU and in float32 on the CPU. The run ends with a ``summary:`` log line
as the IPS CLI's.
"""
from __future__ import annotations

import os
import time

from openpvsg_torch.tools.common import (base_parser, kernel_launches,
                                         load_config, log_summary, maybe_mesh,
                                         partition_videos,
                                         reject_unused_n_time, setup_logging)


def main(argv=None):
    parser = base_parser("VPS query-tube extraction")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--split", default="train")
    parser.add_argument("--save-images", action="store_true",
                        help="write qualititive/ tracking overlays")
    parser.add_argument("--chain-windows", action="store_true",
                        help="chain MinVIS alignment across windows "
                             "(stronger than the reference's raw-id rule)")
    parser.add_argument("--videos", nargs="*", default=None)
    parser.add_argument("--window", type=int, default=None)
    parser.add_argument("--pipeline-depth", type=int, default=2,
                        help="windows in flight on the device: window N+1's "
                             "upload and forward overlap window N's fetch and "
                             "MinVIS stitch (1 = serial; the same results at "
                             "any depth)")
    args = parser.parse_args(argv)
    reject_unused_n_time(args)
    cfg = load_config(args)

    import torch

    from openpvsg_torch.data.pvsg import PVSGAnnotation, frame_paths
    from openpvsg_torch.infer.segmenter import SegmenterInference, resolve_device
    from openpvsg_torch.infer.stages import run_query_tube_vps
    from openpvsg_torch.train.checkpoint import load_model_state
    from openpvsg_torch.weights import random_state_dict

    save_dir = os.path.join(cfg.data.work_dir, f"{args.split}_save_qf")
    logger = setup_logging(save_dir, "prepare_qf_vps")
    launches_before = kernel_launches()
    anno = PVSGAnnotation(cfg.data.anno_file)
    videos = partition_videos(args.videos or anno.video_ids(args.split))
    window = args.window or cfg.data.ref_seq_len_test

    if args.checkpoint:
        state = load_model_state(args.checkpoint)
    else:
        state = random_state_dict(cfg.model, 0)
        logger.warning("no checkpoint: random weights")
    mesh = maybe_mesh(args.device)
    device = mesh.first if mesh is not None else resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    seg = SegmenterInference(cfg.model, state, dtype=dtype, device=device,
                             mesh=mesh)
    if mesh is not None:
        logger.info(f"frame-sharded inference over {mesh.shape['data']} devices")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    summary = {"device": str(device), "dtype": str(dtype).split(".")[-1],
               "videos": 0, "frames": 0, "tubes": 0}
    t0 = time.perf_counter()
    for vid in videos:
        frames = frame_paths(cfg.data.data_dir, vid, "frames")
        if not frames:
            logger.warning(f"{vid}: no frames, skipping")
            continue
        n = run_query_tube_vps(seg, frames, os.path.join(save_dir, vid),
                               window=window, chain_windows=args.chain_windows,
                               pipeline_depth=args.pipeline_depth,
                               save_images=args.save_images)
        logger.info(f"{vid}: {len(frames)} frames -> {n} tubes")
        summary["videos"] += 1
        summary["frames"] += len(frames)
        summary["tubes"] += n
    summary.update(seconds=time.perf_counter() - t0,
                   peak_gib=(torch.cuda.max_memory_allocated(device) / 2 ** 30
                             if device.type == "cuda" else None),
                   launches=kernel_launches(since=launches_before))
    log_summary(logger, summary)
    return summary


if __name__ == "__main__":
    main()
