"""MOTS tracking evaluation over stage-2 outputs, after
``tools/eval_mots.py``: CLEAR (MOTA/MOTP), IDF1, HOTA and J&F per video and
their mean (``eval/mot_metrics.py``, the natively rebuilt subset of the
reference's vendored TrackEval harness, models/unitrack/eval/trackeval/).

Reads ``{work_dir}/{vid}/quantitive/masks.txt`` (or
``{work_dir}/{split}_save_qf/{vid}/...``, where the stage-2 CLIs write) and
the GT palette masks, and matches at mask IoU. Host only: no device.

  python -m openpvsg_torch.tools.eval_mots --work-dir work_dirs \\
      --data-dir data --anno-file data/pvsg.json --split val
"""
from __future__ import annotations

import json
import os

import numpy as np

from openpvsg_torch.tools.common import (base_parser, load_config,
                                         reject_unused_n_time, setup_logging)


def main(argv=None):
    parser = base_parser("MOTS tracking metrics (CLEAR/IDF1/HOTA)")
    parser.add_argument("--split", default="val")
    parser.add_argument("--videos", nargs="*", default=None)
    parser.add_argument("--out", default=None, help="write metrics JSON here")
    args = parser.parse_args(argv)
    reject_unused_n_time(args)
    cfg = load_config(args)

    from openpvsg_torch.data import io as data_io
    from openpvsg_torch.data import rle as rle_codec
    from openpvsg_torch.data.pipeline import load_mask
    from openpvsg_torch.data.pvsg import PVSGAnnotation, frame_paths
    from openpvsg_torch.eval.mot_metrics import (evaluate_hota, evaluate_jf,
                                                 evaluate_mots)

    work_dir = cfg.data.work_dir
    logger = setup_logging(work_dir, "eval_mots")
    anno = PVSGAnnotation(cfg.data.anno_file)
    videos = args.videos or anno.video_ids(args.split)

    totals, n = {}, 0
    for vid in videos:
        masks_txt = os.path.join(work_dir, vid, "quantitive", "masks.txt")
        if not os.path.exists(masks_txt):
            masks_txt = os.path.join(work_dir, f"{args.split}_save_qf", vid,
                                     "quantitive", "masks.txt")
        if not os.path.exists(masks_txt):
            logger.warning(f"{vid}: no masks.txt, skipping")
            continue
        gt_files = frame_paths(cfg.data.data_dir, vid, "masks")
        if not gt_files:
            logger.warning(f"{vid}: no GT masks, skipping")
            continue
        T = len(gt_files)
        gt_frames = []
        for p in gt_files:
            m = load_mask(p)
            gt_frames.append({int(i): (m == i).astype(np.uint8)
                              for i in np.unique(m) if i != 0})
        pred_frames = [dict() for _ in range(T)]
        for e in data_io.read_masks_txt(masks_txt):
            t = e["fid"] - 1
            if 0 <= t < T:
                pred_frames[t][e["tid"]] = rle_codec.decode(e["rle"])

        m = {**evaluate_mots(gt_frames, pred_frames),
             **evaluate_hota(gt_frames, pred_frames),
             **evaluate_jf(gt_frames, pred_frames)}
        n += 1
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + float(v)
        logger.info(f"{vid}: " + " ".join(
            f"{k}={v:.4f}" for k, v in m.items()
            if k in ("MOTA", "MOTP", "IDF1", "HOTA", "DetA", "AssA", "J&F")))

    if not n:
        return {}
    summary = {k: v / n for k, v in totals.items()}
    logger.info("mean over videos: " + " ".join(
        f"{k}={v:.4f}" for k, v in summary.items()
        if k in ("MOTA", "MOTP", "IDF1", "HOTA", "DetA", "AssA")))
    print(json.dumps({k: round(v, 4) for k, v in summary.items()}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
