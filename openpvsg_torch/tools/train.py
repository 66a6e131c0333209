"""Segmenter training CLI, after ``tools/train.py`` (reference:
tools/train.py): trains Mask2Former IPS (per-frame) or VPS (2-frame clips)
with the reference's recipe (AdamW parameter groups, grad clip 0.01, step
LR, 8 epochs) on one device.

  python -m openpvsg_torch.tools.train --config mask2former_vps \\
      --data-dir data --anno-file data/pvsg.json --work-dir work_dirs

The global batch is ``max(train.samples_per_gpu // 4, 1)`` samples on the
one device, as the JAX tool's rule gives on one device. The seeds and the
data-order stream are the JAX tool's: ``numpy.random.default_rng(seed)``
permutes the samples each epoch, and a resumed run draws the skipped
epochs' permutations first. Augmentation draws come from one
``TrainAugmentor`` shared by the loader's threads, so the draws follow the
data order only with ``data.num_workers=1`` (as in the JAX tool).
Checkpoints are the port's own files ``{work_dir}/{name}/epoch_N``
(``train/checkpoint.py``); ``--auto-resume`` continues from the latest.
The run ends with a ``summary:`` log line: epochs, steps, the seconds spent
in steps (each, and in all; each step's host LAP) and waiting for the
loader, the losses, peak
device memory and the kernel launch counts (the trainer launches none).
"""
from __future__ import annotations

import os
import random
import time

import numpy as np

from openpvsg_torch.tools.common import (base_parser, kernel_launches,
                                         load_config, log_summary,
                                         reject_unused_n_time, setup_logging)


def latest_checkpoint(work_dir: str):
    """The path of the highest ``epoch_N`` file in work_dir, or None."""
    if not os.path.isdir(work_dir):
        return None
    found = sorted((int(d.split("_")[1]), d) for d in os.listdir(work_dir)
                   if d.startswith("epoch_") and d.split("_")[1].isdigit())
    return os.path.join(work_dir, found[-1][1]) if found else None


def main(argv=None):
    parser = base_parser("Train the Mask2Former segmenter (IPS/VPS)")
    parser.add_argument("--resume-from", default=None)
    parser.add_argument("--auto-resume", action="store_true",
                        help="resume from the latest epoch_N in the work dir")
    parser.add_argument("--max-instances", type=int, default=40)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--diff-seed", action="store_true",
                        help="not ported: offsets the seed by the process "
                             "index of a multi-process run (ROADMAP.md A13)")
    parser.add_argument("--deterministic", action="store_true",
                        help="torch.use_deterministic_algorithms(True), "
                             "warning (not raising) at an operation without "
                             "a deterministic CUDA implementation, such as "
                             "the bilinear upsample's backward")
    parser.add_argument("--auto-scale-lr", action="store_true",
                        help="linearly scale lr by global_batch/16 "
                             "(reference: mmdet auto_scale_lr, "
                             "base_batch_size=16)")
    parser.add_argument("--wandb", action="store_true",
                        help="mirror metrics to wandb when available")
    parser.add_argument("--packed-cache", default=None, metavar="DIR",
                        help="read samples from a packed cache "
                             "(openpvsg_torch.tools.pack_train_cache) instead "
                             "of decoding PNGs per step; batches ship uint8")
    args = parser.parse_args(argv)
    reject_unused_n_time(args)
    if args.diff_seed:
        raise NotImplementedError(
            "--diff-seed offsets the seed per process of a multi-process "
            "run, which is not ported (ROADMAP.md A13)")
    cfg = load_config(args)

    import torch

    from openpvsg_torch.config import (apply_overrides, check_training_config,
                                       save_config)
    from openpvsg_torch.data.datasets import PVSGImageDataset, PVSGVideoDataset
    from openpvsg_torch.data.loader import PrefetchLoader
    from openpvsg_torch.data.masks import decode_palette_mask
    from openpvsg_torch.data.pipeline import (TrainAugmentor, pad_to_divisor,
                                              preprocess_clip)
    from openpvsg_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from openpvsg_torch.train.segmenter import SegmenterTrainer, pad_targets
    from openpvsg_torch.utils.logging import MetricsLogger

    # refuse an unported training value before any file is read
    check_training_config(cfg.model)
    launches_before = kernel_launches()
    if args.deterministic:
        # cuBLAS is deterministic only with a fixed workspace, set before
        # its first handle
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)

    work_dir = os.path.join(cfg.data.work_dir, cfg.name)
    logger = setup_logging(work_dir, "train")
    seed = cfg.train.seed
    rng = np.random.default_rng(seed)
    random.seed(seed)

    video = cfg.model.video
    T = cfg.model.num_frames if video else 1
    ch, cw = cfg.data.crop_size
    ph, pw = pad_to_divisor(ch, cw, cfg.data.pad_divisor)

    packed_sampler = None
    if args.packed_cache:
        from openpvsg_torch.data.packed import PackedSampler, PackedTrainCache

        cache = PackedTrainCache(args.packed_cache)
        packed_sampler = PackedSampler(cache, cfg.data, video=video, seed=seed)
        n_samples = len(packed_sampler)
        logger.info(f"packed cache: {cache.index['total_frames']} frames, "
                    f"{n_samples} samples; clip T={T}")
    else:
        if video:
            dataset = PVSGVideoDataset(cfg.data.anno_file, cfg.data.data_dir,
                                       "train", cfg.data.ref_seq_index)
        else:
            dataset = PVSGImageDataset(cfg.data.anno_file, cfg.data.data_dir,
                                       "train")
        n_samples = len(dataset)
        logger.info(f"dataset: {n_samples} samples; clip T={T}")

    batch = max(cfg.train.samples_per_gpu // 4, 1)  # global batch, one device
    steps_per_epoch = max(n_samples // batch, 1)
    epochs = args.epochs or cfg.train.epochs
    if args.auto_scale_lr:
        scaled = cfg.train.lr * batch / 16.0
        cfg = apply_overrides(cfg, {"train.lr": scaled})
        logger.info(f"auto-scale-lr: lr -> {scaled:g} (batch {batch} / 16)")

    # the resolved config; the other tools take it as --config <path>
    save_config(cfg, os.path.join(work_dir, "config.json"))

    trainer = SegmenterTrainer(cfg.model, cfg.train,
                               steps_per_epoch=steps_per_epoch,
                               device=args.device, seed=seed,
                               norm_mean=tuple(cfg.data.mean),
                               norm_std=tuple(cfg.data.std))
    resume_path = args.resume_from
    if resume_path is None and args.auto_resume:
        resume_path = latest_checkpoint(work_dir)
    start_epoch = 0
    if resume_path:
        load_checkpoint(resume_path, trainer)
        base = os.path.basename(os.path.normpath(resume_path))
        if base.startswith("epoch_") and base.split("_")[1].isdigit():
            # epoch_N is saved after epoch index N-1: continue at index N
            start_epoch = int(base.split("_")[1])
        logger.info(f"resumed from {resume_path} "
                    f"(step {trainer.step_count}, epoch {start_epoch})")

    aug = TrainAugmentor(cfg.data, seed)
    oh, ow = cfg.data.train_scale

    def make_sample(idx: int):
        item = dataset[idx]
        frames = item["imgs"] if video else item["img"][None]
        pans = item.get("pan_masks")
        if pans is None and "pan_mask" in item:
            pans = item["pan_mask"][None]
        if pans is None:
            return None
        for _ in range(10):  # crop retry (check_match)
            params = aug.sample(frames.shape[1:3])
            masks_t = aug.apply_to_masks(pans, params)
            if aug.check_match(masks_t):
                break
        imgs = preprocess_clip(
            frames, oh, ow, params["flip"], params["crop_y"],
            params["crop_x"], ch, cw, ph, pw, tuple(cfg.data.mean),
            tuple(cfg.data.std)).numpy()
        if video:
            tgt = dataset.clip_targets(masks_t, item["objects"])
        else:
            # without item["objects"] every instance decodes as void
            d = decode_palette_mask(masks_t[0], item["objects"],
                                    dataset.class_index, dataset.num_classes)
            tgt = {"gt_labels": d["gt_labels"],
                   "gt_mask_tubes": d["gt_masks"][:, None]}
        mt = tgt["gt_mask_tubes"]  # (N, T, ch, cw), padded to (ph, pw)
        if mt.shape[0]:
            mt = np.pad(mt, ((0, 0), (0, 0), (0, ph - ch), (0, pw - cw)))
        tgt["gt_mask_tubes"] = mt
        return {"images": imgs, **tgt}

    def make_valid_sample(i: int):
        s = (packed_sampler(int(i)) if packed_sampler is not None
             else make_sample(int(i)))
        return s if (s is not None and len(s["gt_labels"])) else None

    metrics_logger = MetricsLogger(work_dir, use_wandb=args.wandb)
    on_cuda = trainer.device.type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(trainer.device)
    for _ in range(start_epoch):
        rng.permutation(n_samples)  # keep the data-order stream aligned
    step = trainer.step_count
    first_batch, losses, epoch_rows = None, [], []
    for epoch in range(start_epoch, epochs):
        loader = PrefetchLoader(
            make_valid_sample, rng.permutation(n_samples), batch,
            collate=lambda ss: pad_targets(ss, args.max_instances),
            num_workers=cfg.data.num_workers)
        n_steps, wait_s, step_s, step_each, lap_each = 0, 0.0, 0.0, [], []
        t_epoch = time.perf_counter()
        batches = iter(loader)
        while True:
            t0 = time.perf_counter()
            b = next(batches, None)
            t1 = time.perf_counter()
            if b is None:
                break
            if first_batch is None:
                first_batch = b
            logs = trainer.step(b)  # returns floats: the step has finished
            t2 = time.perf_counter()
            wait_s += t1 - t0
            step_s += t2 - t1
            step_each.append(t2 - t1)
            # 0 with 'lapjv' or 'greedy': they run no host LAP
            lap_each.append(trainer.last_timings.get("host_lap_s", 0.0))
            n_steps += 1
            step += 1
            losses.append(logs["loss"])
            if step % cfg.train.log_interval == 0:
                msg = " ".join(f"{k}={float(v):.4f}" for k, v in logs.items()
                               if not k.startswith("loss_") or "." not in k)
                logger.info(f"epoch {epoch} step {step}: {msg}")
                metrics_logger.log({**logs, "epoch": epoch}, step=step)
        if trainer.step_count == 0:
            raise SystemExit(
                f"epoch {epoch} produced 0 batches: dataset ({n_samples} "
                f"samples) smaller than the global batch ({batch})? "
                "Lower train.samples_per_gpu.")
        row = {"epoch": epoch, "steps": n_steps,
               "seconds": time.perf_counter() - t_epoch,
               "step_seconds": step_s, "loader_wait_seconds": wait_s,
               "step_seconds_each": step_each, "host_lap_seconds_each": lap_each}
        epoch_rows.append(row)
        logger.info(f"epoch {epoch}: {n_steps} steps in {row['seconds']:.2f} s, "
                    f"{wait_s:.2f} s waiting for the loader")
        if (epoch + 1) % cfg.train.checkpoint_interval == 0:
            ckpt = os.path.join(work_dir, f"epoch_{epoch + 1}")
            save_checkpoint(ckpt, trainer)
            logger.info(f"saved {ckpt}")
    summary = {"start_epoch": start_epoch, "epochs": epoch_rows,
               "global_batch": batch, "frames_per_sample": T,
               "steps": trainer.step_count, "losses": losses,
               "peak_gib": (torch.cuda.max_memory_allocated(trainer.device) / 2 ** 30
                            if on_cuda else None),
               "device": str(trainer.device),
               "launches": kernel_launches(since=launches_before)}
    log_summary(logger, summary)
    return {**summary, "first_batch": first_batch, "work_dir": work_dir}


if __name__ == "__main__":
    main()
