"""Stage 4 CLI, after ``tools/rel_train.py`` (reference: tools/rel_train.py):
relation-head training on the ``relations.pickle`` sets of the train split,
one video per step, gradients accumulated over ``accumulation_steps``
videos, Adam; per-epoch checkpoint and proxy evaluation (R@K on the val
split's feature-level GT).

  python -m openpvsg_torch.tools.rel_train --data-dir data \\
      --anno-file data/pvsg.json --work-dir work_dirs --model-name transformer

The data order is the JAX tool's: ``numpy.random.default_rng(seed)``
permutes the videos each epoch, and ``RelationTrainer(cfg, counts,
rng_seed=seed)`` draws the subsampling from the same seed. Checkpoints are
the port's own files ``{work_dir}/relation/rel_{ps}_{model}_lr{lr}/epoch_N``
(``train/checkpoint.py:save_relation_checkpoint``), beside the
``result.csv`` of each epoch's proxy metrics. Training runs on the GPU
unless ``--device cpu``; with two or more GPUs visible (and no
``--device``) the accumulation is spread over them
(``DataParallelRelationTrainer``: one replica per GPU, same-bucket videos
in parallel, the gradients summed; the JAX tool's ``maybe_mesh``). The run
ends with a
``summary:`` log line: videos, steps, each epoch's data order, the
seconds of each step, the losses, the last epoch's proxy metrics, peak
device memory and the kernel launch counts (none).
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from openpvsg_torch.tools.common import (base_parser, kernel_launches,
                                         load_config, log_summary, maybe_mesh,
                                         reject_unused_n_time, setup_logging)


def relation_counts(dataset, num_relations: int) -> np.ndarray:
    """Ones plus each relation's occurrences over the dataset, the weights
    of the reweighted BCE (reference: rel_train.py:93-97)."""
    counts = np.ones(num_relations)
    for i in range(len(dataset)):
        for rel in dataset[i]["relations"]:
            counts[int(rel["relation"])] += 1
    return counts


def main(argv=None):
    parser = base_parser("Train the relation head")
    parser.add_argument("--model-name", default=None,
                        help="vanilla | filter | conv | transformer")
    parser.add_argument("--ps-type", default="ips", help="ips | vps")
    parser.add_argument("--epochs", type=int, default=None)
    args = parser.parse_args(argv)
    reject_unused_n_time(args)
    cfg = load_config(args)
    rel_cfg = cfg.relation
    if args.model_name:
        rel_cfg = dataclasses.replace(rel_cfg, model_name=args.model_name)

    import torch

    from openpvsg_torch.data.datasets import PVSGRelationDataset
    from openpvsg_torch.eval.rel_eval import evaluate
    from openpvsg_torch.eval.rel_full_eval import save_metrics_to_csv
    from openpvsg_torch.infer.segmenter import resolve_device
    from openpvsg_torch.train.checkpoint import save_relation_checkpoint
    from openpvsg_torch.train.relation import (DataParallelRelationTrainer,
                                               RelationTrainer)

    mesh = maybe_mesh(args.device)
    device = mesh.first if mesh is not None else resolve_device(args.device)

    work_dir = os.path.join(cfg.data.work_dir, "train_save_qf")
    work_dir_eval = os.path.join(cfg.data.work_dir, "val_save_qf")
    save_dir = os.path.join(
        cfg.data.work_dir, "relation",
        f"rel_{args.ps_type}_{rel_cfg.model_name}_lr{rel_cfg.lr}")
    logger = setup_logging(save_dir, "rel_train")
    launches_before = kernel_launches()
    csv_path = os.path.join(save_dir, "result.csv")

    train_ds = PVSGRelationDataset(cfg.data.anno_file, "train", work_dir)
    eval_ds = PVSGRelationDataset(cfg.data.anno_file, "val", work_dir_eval)
    logger.info(f"train videos: {len(train_ds)}; eval videos: {len(eval_ds)}")
    relation_count = relation_counts(train_ds, rel_cfg.num_relations)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if mesh is not None:
        logger.info(f"data-parallel relation training over "
                    f"{mesh.shape['data']} devices")
        trainer = DataParallelRelationTrainer(rel_cfg, relation_count, mesh,
                                              rng_seed=args.seed)
    else:
        trainer = RelationTrainer(rel_cfg, relation_count, rng_seed=args.seed,
                                  device=device)
    rng = np.random.default_rng(args.seed)
    epochs = args.epochs or rel_cfg.epochs

    summary = {"device": str(device), "model": rel_cfg.model_name,
               "data_parallel": 1 if mesh is None else mesh.shape["data"],
               "videos": len(train_ds), "epochs": epochs, "steps": 0,
               "order": [], "losses": [], "step_seconds_each": [],
               "eval_seconds": [], "checkpoints": []}
    t0 = time.perf_counter()
    for epoch in range(epochs):
        order = rng.permutation(len(train_ds))
        summary["order"].append(order.tolist())
        last_res = None
        for step, idx in enumerate(order):
            item = train_ds[int(idx)]
            t_step = time.perf_counter()
            res = trainer.step(item["feats"], item["relations"])
            summary["step_seconds_each"].append(time.perf_counter() - t_step)
            summary["steps"] += 1
            if res is not None:
                summary["losses"].append(res[0])
            last_res = res or last_res
            if last_res and (step + 1) % rel_cfg.accumulation_steps == 0:
                loss, aux = last_res
                logger.info(
                    f"epoch {epoch + 1} video {step + 1}: "
                    f"{aux['loss_pair']:.2f}|{aux['loss_prob']:.2f}|"
                    f"{aux['loss_span']:.2f} loss {loss:.2f}")
        trainer.flush()

        ckpt = os.path.join(save_dir, f"epoch_{epoch + 1}")
        save_relation_checkpoint(ckpt, trainer)
        summary["checkpoints"].append(ckpt)
        logger.info("Evaluation starts...")
        t_eval = time.perf_counter()
        metrics = evaluate(trainer.model, (eval_ds[i] for i in range(len(eval_ds))),
                           rel_cfg.num_top_pairs, eval_ds.relations)
        summary["eval_seconds"].append(time.perf_counter() - t_eval)
        logger.info(f"Pair Recall@20: {100 * metrics['pair_recall_20']:.2f}")
        for K in (20, 50, 100):
            m = metrics[K]
            logger.info(f"R@{K}: {100 * m['recall']:.2f} "
                        f"mR@{K}: {100 * m['mean_recall']:.2f}")
        save_metrics_to_csv(
            metrics, [metrics["pair_recall_20"]], (20, 50, 100), csv_path,
            f"{rel_cfg.model_name}_epoch{epoch + 1}")
        summary["metrics"] = {str(K): metrics[K] for K in (20, 50, 100)}
        summary["pair_recall_20"] = metrics["pair_recall_20"]
    summary.update(seconds=time.perf_counter() - t0,
                   peak_gib=(torch.cuda.max_memory_allocated(device) / 2 ** 30
                             if device.type == "cuda" else None),
                   launches=kernel_launches(since=launches_before))
    log_summary(logger, summary)
    return summary


if __name__ == "__main__":
    main()
