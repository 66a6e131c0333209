"""Build a packed preprocessed training cache (``openpvsg_torch/data/packed.py``),
byte-identical to the one ``tools/pack_train_cache.py`` writes.

One-time preparation that moves the per-epoch-invariant host work (PNG
decode, resize to train_scale, mask nearest-resize, object_id -> class LUTs)
out of the training loop; ``python -m openpvsg_torch.tools.train
--packed-cache <dir>`` then feeds the trainer from memmap shards with numpy
slice augmentation and uint8 host-to-device copies.

  python -m openpvsg_torch.tools.pack_train_cache --config mask2former_vps \\
      --data-dir data --anno-file data/pvsg.json --out work_dirs/packed
"""
from __future__ import annotations

import os

from openpvsg_torch.tools.common import (base_parser, load_config,
                                         reject_unused_n_time, setup_logging)


def main(argv=None):
    parser = base_parser("Pack a preprocessed training cache")
    parser.add_argument("--split", default="train")
    parser.add_argument("--out", default=None,
                        help="cache dir (default {work_dir}/packed_{split})")
    parser.add_argument("--videos", nargs="*", default=None,
                        help="restrict to these video ids")
    args = parser.parse_args(argv)
    reject_unused_n_time(args)
    cfg = load_config(args)

    from openpvsg_torch.data.packed import write_packed_cache

    out = args.out or os.path.join(cfg.data.work_dir, f"packed_{args.split}")
    logger = setup_logging(cfg.data.work_dir, "pack_train_cache")
    index = write_packed_cache(
        cfg.data.anno_file, cfg.data.data_dir, args.split, out,
        train_scale=tuple(cfg.data.train_scale), video_ids=args.videos,
        log_fn=logger.info)
    gb = (index["total_frames"]
          * (3 + 2) * index["train_scale"][0] * index["train_scale"][1] / 1e9)
    logger.info(f"packed {len(index['videos'])} videos / "
                f"{index['total_frames']} frames into {out} (~{gb:.2f} GB)")
    return out


if __name__ == "__main__":
    main()
