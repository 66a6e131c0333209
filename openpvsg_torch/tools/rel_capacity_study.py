"""Relation-head capacity study, after ``tools/rel_capacity_study.py``: the
variant x capacity grid of relation heads on geometry-derived synthetic
data (no reference equivalent: the reference ships four fixed-capacity
heads, tools/rel_train.py:52-76).

The default synthetic dataset saturates every head, so this study expects
``make_synthetic_data --style rich --oracle-stage2 <work_dir>``:
geometry-derived predicates whose spans the head must compute from
entangled per-tube features, plus oracle stage-2 tubes so the segmenter is
not a confound (``data/synthetic.py:write_oracle_stage2``).

Each grid cell trains a fresh head on ``train_save_qf/*/relations.pickle``
and reports proxy R@K / mR@K on the val split, its parameter count and wall
time, as the JAX tool's cells. Prints a markdown table and writes a JSON
artifact. The heads train on the GPU unless ``--device cpu``.

  python -m openpvsg_torch.tools.make_synthetic_data --out D --style rich \
      --frames 32 --train-videos 24 --val-videos 8 --size 96 128 --oracle-stage2 W
  python -m openpvsg_torch.tools.prepare_rel_set --data-dir D \
      --anno-file D/pvsg.json --work-dir W --split train   # and --split val
  python -m openpvsg_torch.tools.rel_capacity_study --data-dir D \
      --anno-file D/pvsg.json --work-dir W --epochs 40 --out capacity_study.json
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from openpvsg_torch.tools.common import (base_parser, load_config,
                                         reject_unused_n_time, setup_logging)

# capacity presets over the knobs RelationModel.from_config honors;
# "ref" is the reference's fixed hyperparameters
CAPACITIES = {
    "tiny": dict(encoder_layers=1, encoder_ffn=128,
                 temporal_layers=1, temporal_heads=2, temporal_ffn=128),
    "ref": dict(),
    "large": dict(encoder_layers=3, encoder_ffn=1024,
                  temporal_layers=2, temporal_heads=8, temporal_ffn=1024),
    # beyond-reference pair-interaction input ([s, o, s-o, s*o]); reference
    # capacity otherwise — isolates the representation change
    "interact": dict(pair_interaction=True),
    "interact_large": dict(pair_interaction=True,
                           encoder_layers=3, encoder_ffn=1024,
                           temporal_layers=2, temporal_heads=8,
                           temporal_ffn=1024),
}


def main(argv=None):
    parser = base_parser("Relation-head capacity study")
    parser.add_argument("--variants",
                        default="vanilla,filter,conv,transformer")
    parser.add_argument("--capacities", default="tiny,ref,large",
                        help=f"subset of {sorted(CAPACITIES)}")
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--accum", type=int, default=8,
                        help="accumulation_steps override (the reference's "
                             "32 gives ~1 update/epoch on small sets)")
    parser.add_argument("--eval-train", action="store_true",
                        help="also evaluate on the train split (memorization "
                             "ceiling: low train R@K = the head cannot even "
                             "fit the mapping; high train / low val = "
                             "generalization is data-starved)")
    parser.add_argument("--out", default="capacity_study.json")
    parser.add_argument("--resume", action="store_true",
                        help="reuse finished cells from <out>.partial.jsonl "
                             "instead of truncating it — a killed grid run "
                             "(the full grid takes hours) restarts at the "
                             "first unfinished cell")
    args = parser.parse_args(argv)
    reject_unused_n_time(args)
    cfg = load_config(args)

    from openpvsg_torch.data.datasets import PVSGRelationDataset
    from openpvsg_torch.eval.rel_eval import evaluate
    from openpvsg_torch.infer.segmenter import resolve_device
    from openpvsg_torch.train.relation import RelationTrainer

    device = resolve_device(args.device)

    work_dir = cfg.data.work_dir
    logger = setup_logging(work_dir, "rel_capacity_study")
    train_ds = PVSGRelationDataset(cfg.data.anno_file, "train",
                                   os.path.join(work_dir, "train_save_qf"))
    val_ds = PVSGRelationDataset(cfg.data.anno_file, "val",
                                 os.path.join(work_dir, "val_save_qf"))
    if not len(train_ds) or not len(val_ds):
        raise SystemExit(
            f"empty relation dataset (train {len(train_ds)}, val "
            f"{len(val_ds)} videos) — stage-3 outputs missing. Run "
            f"`python -m openpvsg_torch.tools.prepare_rel_set --data-dir ... "
            f"--split train` (and val) to produce {{vid}}/relations.pickle under "
            f"{work_dir}/{{train,val}}_save_qf first.")
    n_rel = len(train_ds.relations)
    logger.info(f"train {len(train_ds)} videos, val {len(val_ds)}, "
                f"{n_rel} relations: {train_ds.relations}")

    relation_count = np.ones(n_rel)
    for i in range(len(train_ds)):
        for rel in train_ds[i]["relations"]:
            relation_count[int(rel["relation"])] += 1
    logger.info(f"relation counts: {relation_count.astype(int).tolist()}")

    # truncate the streaming file once: otherwise re-running with the same
    # --out mixes stale cells from a previous (possibly killed) run.
    # With --resume the finished cells are reloaded and skipped instead
    # (cells from a different grid spec stay in the file but are ignored).
    spec = {"epochs": args.epochs, "seed": args.seed, "accum": args.accum,
            "eval_train": bool(args.eval_train)}
    done: dict[tuple[str, str], dict] = {}
    if args.resume and os.path.exists(args.out + ".partial.jsonl"):
        with open(args.out + ".partial.jsonl") as f:
            for line in f:
                c = json.loads(line)
                # only reuse cells trained under the SAME run spec — a
                # stale smoke run's 1-epoch cell must not be published as
                # a 40-epoch result (cells predating the spec stamp are
                # retrained too)
                if c.get("run_spec") == spec:
                    done[(c["variant"], c["capacity"])] = c
        logger.info(f"--resume: {len(done)} finished cells reloaded")
    else:
        open(args.out + ".partial.jsonl", "w").close()
    cells = []
    for variant in args.variants.split(","):
        for cap_name in args.capacities.split(","):
            if (variant, cap_name) in done:
                cells.append(done[(variant, cap_name)])
                logger.info(f"skip finished cell {variant}/{cap_name}")
                continue
            rel_cfg = dataclasses.replace(
                cfg.relation, model_name=variant, num_relations=n_rel,
                accumulation_steps=args.accum, **CAPACITIES[cap_name])
            t0 = time.perf_counter()
            trainer = RelationTrainer(rel_cfg, relation_count,
                                      rng_seed=args.seed, device=device)
            n_params = sum(p.numel() for p in trainer.params)
            rng = np.random.default_rng(args.seed)
            losses = []
            for epoch in range(args.epochs):
                order = rng.permutation(len(train_ds))
                ep = []
                for idx in order:
                    item = train_ds[int(idx)]
                    res = trainer.step(item["feats"], item["relations"])
                    if res:
                        ep.append(res[0])
                trainer.flush()
                losses.append(float(np.mean(ep)) if ep else float("nan"))
            train_s = time.perf_counter() - t0

            metrics = evaluate(
                trainer.model,
                (val_ds[i] for i in range(len(val_ds))),
                rel_cfg.num_top_pairs, val_ds.relations)
            cell = {
                "variant": variant, "capacity": cap_name,
                "run_spec": spec,
                "params": n_params,
                "train_s": round(train_s, 1),
                "loss_first": round(losses[0], 3),
                "loss_last": round(losses[-1], 3),
                "pair_recall_20": round(
                    100 * float(metrics["pair_recall_20"]), 2),
            }
            for K in (20, 50, 100):
                cell[f"R@{K}"] = round(100 * metrics[K]["recall"], 2)
                cell[f"mR@{K}"] = round(100 * metrics[K]["mean_recall"], 2)
                # span-insensitive: separates triplet-ranking quality from
                # span-overlap quality (strict hit needs time-IoU >= 0.5)
                cell[f"wR@{K}"] = round(100 * metrics[K]["weak_recall"], 2)
            if args.eval_train:
                tr = evaluate(
                    trainer.model,
                    (train_ds[i] for i in range(len(train_ds))),
                    rel_cfg.num_top_pairs, train_ds.relations)
                for K in (20, 50, 100):
                    cell[f"train_R@{K}"] = round(100 * tr[K]["recall"], 2)
                    cell[f"train_wR@{K}"] = round(
                        100 * tr[K]["weak_recall"], 2)
            cells.append(cell)
            logger.info(json.dumps(cell))
            # stream cells as they finish: a killed/timed-out run keeps
            # every completed cell (the grid takes hours at full size)
            with open(args.out + ".partial.jsonl", "a") as f:
                f.write(json.dumps(cell) + "\n")

    # markdown table, grouped by variant
    hdr = ("| variant | capacity | params | loss 1st→last | pairR@20 "
           "| R@20 | mR@20 | R@50 | mR@50 | R@100 | mR@100 | train s |")
    print(hdr)
    print("|" + "---|" * 12)
    for c in cells:
        print(f"| {c['variant']} | {c['capacity']} | {c['params']:,} "
              f"| {c['loss_first']}→{c['loss_last']} "
              f"| {c['pair_recall_20']} "
              f"| {c['R@20']} | {c['mR@20']} | {c['R@50']} | {c['mR@50']} "
              f"| {c['R@100']} | {c['mR@100']} | {c['train_s']} |")

    with open(args.out, "w") as f:
        json.dump({"relations": train_ds.relations,
                   "relation_counts": relation_count.astype(int).tolist(),
                   "train_videos": len(train_ds), "val_videos": len(val_ds),
                   "epochs": args.epochs, "cells": cells}, f, indent=1)
    logger.info(f"wrote {args.out}")


if __name__ == "__main__":
    main()
