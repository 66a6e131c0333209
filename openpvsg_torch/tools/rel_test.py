"""Stage 5 (proxy) CLI, after ``tools/rel_test.py`` (reference:
tools/rel_test.py): feature-level relation evaluation, Pair Recall@20 and
R@K / mR@K on the ``relations.pickle`` GT of a split.

  python -m openpvsg_torch.tools.rel_test --data-dir data \\
      --anno-file data/pvsg.json --work-dir work_dirs --split val \\
      --checkpoint work_dirs/relation/rel_ips_transformer_lr0.0001/epoch_100

``--checkpoint`` is an ``epoch_N`` file of the port's ``rel_train``, the
reference's four-model relation ``.pth`` bundle or a ``.npz`` of the JAX
package's checkpoint (``export_jax_checkpoint.py``); ``--set relation.*``
gives the model's capacity. The printed lines are the JAX tool's. The model
runs on the GPU unless ``--device cpu``; with two or more GPUs visible (and
no ``--device``) as ``TimeShardedRelation`` over a ``(data, time)`` mesh of
them, ``--n-time`` sizing 'time'. The run ends with a ``summary:`` log
line: the metrics, seconds and the kernel launch counts (none).
"""
from __future__ import annotations

import os
import time

from openpvsg_torch.tools.common import (base_parser, kernel_launches,
                                         load_config, load_relation_params,
                                         log_summary, make_relation_executor,
                                         maybe_mesh, setup_logging)


def main(argv=None):
    parser = base_parser("Relation proxy evaluation (feature-level)")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--model-name", default="transformer")
    parser.add_argument("--split", default="val")
    parser.add_argument("--num-top-pairs", type=int, default=100)
    args = parser.parse_args(argv)
    cfg = load_config(args)

    from openpvsg_torch.data.datasets import PVSGRelationDataset
    from openpvsg_torch.eval.rel_eval import evaluate
    from openpvsg_torch.infer.segmenter import resolve_device

    mesh = maybe_mesh(args.device, n_time=args.n_time)
    device = mesh.first if mesh is not None else resolve_device(args.device)

    work_dir = os.path.join(cfg.data.work_dir, f"{args.split}_save_qf")
    logger = setup_logging(os.path.dirname(args.checkpoint) or ".", "rel_test")
    launches_before = kernel_launches()
    ds = PVSGRelationDataset(cfg.data.anno_file, args.split, work_dir)
    model = load_relation_params(args.checkpoint, args.model_name, device,
                                 cfg.relation)
    executor = make_relation_executor(mesh, model)
    if executor is not None:
        logger.info(f"relation scoring on a (data={mesh.shape['data']}, "
                    f"time={mesh.shape['time']}) mesh")
    t0 = time.perf_counter()
    metrics = evaluate(model, (ds[i] for i in range(len(ds))),
                       args.num_top_pairs, ds.relations, executor=executor)
    seconds = time.perf_counter() - t0
    print(f"Pair Recall@20: {100 * metrics['pair_recall_20']:.2f}")
    for K in (20, 50, 100):
        m = metrics[K]
        print("-" * 67)
        print(f"Recall@{K}: {100 * m['recall']:.2f}")
        print(f"Mean Recall@{K}: {100 * m['mean_recall']:.2f}")
        print(f"Weak Recall@{K}: {100 * m['weak_recall']:.2f}")
        print(f"Weak Mean Recall@{K}: {100 * m['weak_mean_recall']:.2f}")
    summary = {"videos": len(ds), "seconds": seconds,
               "pair_recall_20": metrics["pair_recall_20"],
               "metrics": {str(K): metrics[K] for K in (20, 50, 100)},
               "launches": kernel_launches(since=launches_before)}
    log_summary(logger, summary)
    return summary


if __name__ == "__main__":
    main()
