"""Assigner training parity, after ``tools/assigner_parity.py``: the host
Hungarian against LAPJV (exact, on the device) and greedy (approximate, on
the device), each training the same tiny IPS model from the same weights on
identical synthetic batches; loss curves and final PQ.

The JAX tool runs on the CPU only, because its Hungarian needs host
callbacks, and runs each assigner in a subprocess of its own (its compiled
programs leak across runs). The port's trainer takes the host LAP on any
device, so this tool runs on the GPU unless ``--device cpu``, all three
assigners in one process (``--only`` runs one and writes its fragment, as
the JAX tool's). Beside the JAX tool's keys each assigner reports its
median and first step times, which tell whether LAPJV should be ``auto``'s
choice on the device.

  python -m openpvsg_torch.tools.assigner_parity [--steps 120] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

ASSIGNERS = ("hungarian", "lapjv", "greedy")
MEAN = np.asarray((123.675, 116.28, 103.53), np.float32)
STD = np.asarray((58.395, 57.12, 57.375), np.float32)


def tiny_cfg(assigner: str):
    from openpvsg_torch.config import (BackboneConfig, Mask2FormerConfig,
                                       PixelDecoderConfig,
                                       TransformerDecoderConfig)

    return Mask2FormerConfig(
        num_things_classes=5, num_stuff_classes=3, num_queries=12,
        backbone=BackboneConfig(depth=26),
        pixel_decoder=PixelDecoderConfig(encoder_layers=1, ffn_channels=64),
        decoder=TransformerDecoderConfig(num_layers=3, ffn_channels=64),
        assigner=assigner,
        object_mask_thr=0.3, iou_thr=0.5)


def build_batches(data_root: str, n_steps: int, batch: int, seed: int):
    """Fixed batch sequence shared by every run (identical data order)."""
    from openpvsg_torch.data.datasets import PVSGImageDataset

    ds = PVSGImageDataset(os.path.join(data_root, "pvsg.json"), data_root,
                          "train")
    rng = np.random.default_rng(seed)
    H, W = ds[0]["img"].shape[:2]
    hm, wm = H // 4, W // 4
    N = 6
    batches = []
    for _ in range(n_steps):
        idxs = rng.integers(0, len(ds), batch)
        images = np.zeros((batch, 1, H, W, 3), np.float32)
        gt_labels = np.zeros((batch, N), np.int32)
        gt_masks = np.zeros((batch, N, 1, hm, wm), np.uint8)
        gt_valid = np.zeros((batch, N), bool)
        for i, idx in enumerate(idxs):
            item = ds[int(idx)]
            images[i, 0] = (item["img"].astype(np.float32) - MEAN) / STD
            n = min(len(item["gt_labels"]), N)
            gt_labels[i, :n] = item["gt_labels"][:n]
            gt_valid[i, :n] = True
            for j in range(n):
                gt_masks[i, j, 0] = item["gt_masks"][j][::4, ::4][:hm, :wm]
        batches.append({"images": images, "gt_labels": gt_labels,
                        "gt_masks": gt_masks, "gt_valid": gt_valid})
    return ds, batches


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(assigner: str, batches, data_root: str, device):
    """Train with ``assigner``; returns (losses, PQ metrics on the train
    split, step seconds)."""
    import torch

    from openpvsg_torch.config import TrainConfig
    from openpvsg_torch.data.datasets import PVSGImageDataset
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.train.segmenter import SegmenterTrainer

    cfg = tiny_cfg(assigner)
    trainer = SegmenterTrainer(cfg, TrainConfig(seed=0, lr=5e-4, warmup_iters=10),
                               steps_per_epoch=len(batches), device=device, seed=0)
    losses, seconds = [], []
    for b in batches:
        _sync(trainer.device)
        t0 = time.perf_counter()
        logs = trainer.step(b)
        _sync(trainer.device)
        seconds.append(time.perf_counter() - t0)
        losses.append(float(logs["loss"]))

    # eval PQ on the train split (synthetic videos have random palettes, so
    # cross-video generalization is meaningless: the question is whether the
    # assigner let the model learn the task at all)
    seg = SegmenterInference(cfg, trainer.model.state_dict(), dtype=torch.float32,
                             device=trainer.device)
    ds = PVSGImageDataset(os.path.join(data_root, "pvsg.json"), data_root, "train")
    results = []
    for lo in range(0, len(ds), 8):
        frames = np.stack([ds[i]["img"] for i in range(lo, min(lo + 8, len(ds)))])
        results.extend(o["pan_results"] for o in seg.infer_frames_ips(frames))
    metrics = ds.evaluate(results)
    return losses, {k: float(v) for k, v in metrics.items()
                    if k != "per_class"}, seconds


def fragment(losses, metrics, seconds) -> dict:
    return {
        "loss_first10": round(float(np.mean(losses[:10])), 4),
        "loss_last10": round(float(np.mean(losses[-10:])), 4),
        "loss_curve_every10": [round(v, 3) for v in losses[::10]],
        **{k: round(v, 4) for k, v in metrics.items()},
        "step_ms_median": float(1e3 * np.median(seconds)),
        "first_step_ms": float(1e3 * seconds[0]),
    }


def deltas(report: dict) -> dict:
    """Each device assigner against the Hungarian, as the JAX tool reports
    it: the relative change of the last ten steps' mean loss and the
    absolute change of PQ."""
    h = report["hungarian"]
    out = {}
    for name in ("lapjv", "greedy"):
        g = report[name]
        out[name] = {
            "final_loss_rel": round((g["loss_last10"] - h["loss_last10"])
                                    / max(abs(h["loss_last10"]), 1e-9), 4),
            "pq_abs": round(g.get("PQ", 0.0) - h.get("PQ", 0.0), 4),
        }
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--out", default="assigner_parity.json")
    p.add_argument("--data-root",
                   default=os.path.join(tempfile.gettempdir(), "pvsg_assigner_parity"))
    p.add_argument("--only", default=None, choices=ASSIGNERS,
                   help="run one assigner and write its fragment to OUT.ASSIGNER")
    p.add_argument("--device", default=None,
                   help="torch device; the GPU unless 'cpu' is asked for")
    args = p.parse_args(argv)

    import torch

    from openpvsg_torch.data.synthetic import make_dataset
    from openpvsg_torch.infer.segmenter import resolve_device

    device = resolve_device(args.device)
    if not os.path.exists(os.path.join(args.data_root, "pvsg.json")):
        make_dataset(args.data_root, n_train=3, n_val=1, n_frames=10,
                     h=96, w=96, seed=0)
    _, batches = build_batches(args.data_root, args.steps, args.batch, seed=1)

    if args.only:
        frag = fragment(*run(args.only, batches, args.data_root, device))
        with open(f"{args.out}.{args.only}", "w") as f:
            json.dump(frag, f)
        print(args.only, json.dumps(frag), flush=True)
        return

    report = {"steps": args.steps, "batch": args.batch, "device": str(device),
              "device_name": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu")}
    for assigner in ASSIGNERS:
        report[assigner] = fragment(*run(assigner, batches, args.data_root, device))
        print(assigner, json.dumps(report[assigner]), flush=True)
    report["delta"] = deltas(report)
    print(json.dumps(report["delta"]))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
