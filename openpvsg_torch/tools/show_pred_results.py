"""Render predicted triplets, after ``tools/show_pred_results.py``
(reference: tools/show_pred_results.py, PIL-based): for each frame of a
video, every predicted tube of ``{work_dir}/{vid}/quantitive/masks.txt``
blended in its palette colour, and the labels of the ``--top`` triplets of
``{vid}/triplets.json`` (``end2end_inference``'s output) written at the
top left, as ``{out_dir}/%04d.png``. PIL is imported when the tool runs.
No device is involved.

  python -m openpvsg_torch.tools.show_pred_results --work-dir W \\
      --data-dir data --video 0001_4164158586 --top 5
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

PALETTE = [(255, 64, 64), (64, 160, 255), (64, 255, 128), (255, 200, 64),
           (200, 64, 255), (64, 255, 255), (255, 128, 200), (160, 160, 64)]


def overlay(img: np.ndarray, mask: np.ndarray, color, alpha=0.5):
    out = img.astype(np.float32)
    m = mask.astype(bool)
    out[m] = (1 - alpha) * out[m] + alpha * np.asarray(color, np.float32)
    return out.astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description="visualize predicted triplets")
    p.add_argument("--work-dir", required=True,
                   help="dir holding {vid}/quantitive/masks.txt + triplets.json")
    p.add_argument("--data-dir", default="./data")
    p.add_argument("--video", required=True)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--top", type=int, default=5)
    args = p.parse_args(argv)

    from PIL import Image, ImageDraw

    from openpvsg_torch.data import io as data_io
    from openpvsg_torch.data.pvsg import frame_paths

    vid = args.video
    root = os.path.join(args.work_dir, vid)
    out_dir = args.out_dir or os.path.join(root, "qualitative")
    os.makedirs(out_dir, exist_ok=True)

    tubes = data_io.get_pred_mask_tubes(
        os.path.join(root, "quantitive", "masks.txt"))
    trip_path = os.path.join(root, "triplets.json")
    triplets = []
    if os.path.exists(trip_path):
        with open(trip_path) as f:
            triplets = json.load(f)
    frames = frame_paths(args.data_dir, vid, "frames")

    masks_by_frame = {}
    for tid, tube in tubes.items():
        for entry in tube["mask"]:
            for f, m in entry.items():
                masks_by_frame.setdefault(f, []).append((tid, m))

    for f, path in enumerate(frames):
        img = np.asarray(Image.open(path).convert("RGB"))
        for tid, m in masks_by_frame.get(f, []):
            img = overlay(img, m, PALETTE[tid % len(PALETTE)])
        im = Image.fromarray(img)
        draw = ImageDraw.Draw(im)
        y = 4
        for t in triplets[:args.top]:
            label = (f"{t.get('subject_tube')}-{t.get('relation_name')}"
                     f"-{t.get('object_tube')}")
            draw.text((4, y), label, fill=(255, 255, 255))
            y += 12
        im.save(os.path.join(out_dir, f"{f:04d}.png"))
    print(f"wrote {len(frames)} frames to {out_dir}")


if __name__ == "__main__":
    main()
