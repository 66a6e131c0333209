"""Stage 2 (IPS) CLI, after ``tools/prepare_query_tube_ips.py`` (reference:
tools/prepare_query_tube_ips.py): per-video IPS inference and UniTrack-style
tracking -> ``{work_dir}/{split}_save_qf/{vid}/quantitive/masks.txt`` and
``query_feats.pickle``.

  python -m openpvsg_torch.tools.prepare_query_tube_ips --data-dir data \\
      --anno-file data/pvsg.json --work-dir work_dirs --split val \\
      --checkpoint work_dirs/mask2former_ips/epoch_8 \\
      --appearance-checkpoint resnet50.pth

``--checkpoint`` is an ``epoch_N`` file of the port's train CLI;
``--appearance-checkpoint`` a torchvision ResNet state dict (``.pth``) for
the ``imagenet50 s3`` encoder (``tracker.*`` settings pick another). Without
them the weights are random (with a warning). The segmenter runs in
bfloat16 on the GPU and in float32 on the CPU; the appearance encoder and
the association costs in float32. The run ends with a ``summary:`` log
line: videos, frames, seconds, tubes, peak device memory and the kernel
launch counts.
"""
from __future__ import annotations

import os
import time

from openpvsg_torch.tools.common import (base_parser, kernel_launches,
                                         load_config, log_summary, maybe_mesh,
                                         partition_videos,
                                         reject_unused_n_time, setup_logging)


def load_torch_state_dict(path: str):
    """A ``.pth`` file's state dict (a bare one or under ``state_dict``),
    on the CPU."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj.get("state_dict", obj)


def main(argv=None):
    parser = base_parser("IPS query-tube extraction")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--appearance-checkpoint", default=None)
    parser.add_argument("--split", default="train")
    parser.add_argument("--videos", nargs="*", default=None)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--pipeline-depth", type=int, default=2,
                        help="frame batches in flight on the device: batch "
                             "N+1's upload and forward overlap the tracking "
                             "of batch N (1 = serial; the same results at "
                             "any depth)")
    parser.add_argument("--save-images", action="store_true",
                        help="write qualititive/ tracking overlays")
    args = parser.parse_args(argv)
    reject_unused_n_time(args)
    cfg = load_config(args)

    import torch

    from openpvsg_torch.data.pvsg import PVSGAnnotation, frame_paths
    from openpvsg_torch.infer.segmenter import SegmenterInference, resolve_device
    from openpvsg_torch.infer.stages import run_query_tube_ips
    from openpvsg_torch.tracker.tracker import MaskAssociationTracker
    from openpvsg_torch.train.checkpoint import load_model_state
    from openpvsg_torch.weights import (appearance_state,
                                        convert_torchvision_resnet,
                                        random_appearance_state_dict,
                                        random_state_dict)

    save_dir = os.path.join(cfg.data.work_dir, f"{args.split}_save_qf")
    logger = setup_logging(save_dir, "prepare_qf_ips")
    launches_before = kernel_launches()
    anno = PVSGAnnotation(cfg.data.anno_file)
    videos = partition_videos(args.videos or anno.video_ids(args.split))
    logger.info(f"{len(videos)} videos")

    if args.checkpoint:
        state = load_model_state(args.checkpoint)
    else:
        state = random_state_dict(cfg.model, 0)
        logger.warning("no checkpoint: random weights")
    if args.appearance_checkpoint:
        app_state = appearance_state(convert_torchvision_resnet(
            load_torch_state_dict(args.appearance_checkpoint)), cfg.tracker)
    else:
        app_state = random_appearance_state_dict(cfg.tracker, 1)
        logger.warning("no appearance checkpoint: random weights")
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
        tracker = MaskAssociationTracker(cfg.tracker, app_state, device=device)
        n = run_query_tube_ips(seg, tracker, frames, os.path.join(save_dir, vid),
                               batch_size=args.batch_size, log_fn=logger.info,
                               save_images=args.save_images,
                               pipeline_depth=args.pipeline_depth)
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
