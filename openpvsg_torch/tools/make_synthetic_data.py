"""Generate a synthetic PVSG-format dataset (frames, object-id masks,
pvsg.json) for running the pipeline without the real download; the same
files, byte for byte, as ``tools/make_synthetic_data.py`` from the same
seed.

  python -m openpvsg_torch.tools.make_synthetic_data --out data_synth \\
      --train-videos 2 --val-videos 1 --frames 8 --size 64 64
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="synthetic PVSG dataset")
    p.add_argument("--out", default="./data_synth")
    p.add_argument("--train-videos", type=int, default=2)
    p.add_argument("--val-videos", type=int, default=1)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--size", type=int, nargs=2, default=(64, 64))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--style", default="simple", choices=("simple", "rich"),
                   help="rich = variable object counts/motion patterns with "
                        "geometry-derived relations (capacity studies)")
    p.add_argument("--max-things", type=int, default=5,
                   help="rich mode: max moving things per video")
    p.add_argument("--oracle-stage2", default=None, metavar="WORK_DIR",
                   help="also write perfect GT-derived stage-2 outputs "
                        "(masks.txt + query_feats.pickle) for both splits "
                        "into WORK_DIR/{train,val}_save_qf")
    args = p.parse_args(argv)

    from openpvsg_torch.data.synthetic import make_dataset, write_oracle_stage2

    path = make_dataset(args.out, args.train_videos, args.val_videos,
                        args.frames, args.size[0], args.size[1], args.seed,
                        style=args.style, max_things=args.max_things)
    print(f"wrote {path}")
    if args.oracle_stage2:
        for split in ("train", "val"):
            dirs = write_oracle_stage2(args.out, path, args.oracle_stage2,
                                       split, seed=args.seed)
            print(f"oracle stage-2 [{split}]: {len(dirs)} videos")
    print(f"try: python -m openpvsg_torch.tools.train --config mask2former_vps "
          f"--data-dir {args.out} --anno-file {path} --device cpu "
          f"--set model.backbone.depth=26")
    return path


if __name__ == "__main__":
    main()
