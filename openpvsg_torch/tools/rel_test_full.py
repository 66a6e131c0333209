"""Stage 5 (final protocol) CLI, after ``tools/rel_test_full.py``
(reference: tools/rel_test_full.py): mask-grounded relation evaluation
against the raw pvsg.json GT, R@K / mR@K / weak / soft at vIoU thresholds
0.5 and 0.1; appends a row to ``{work_dir}/relation/main_results.csv``.

  python -m openpvsg_torch.tools.rel_test_full --data-dir data \\
      --anno-file data/pvsg.json --work-dir work_dirs --split val \\
      --checkpoint work_dirs/relation/rel_ips_transformer_lr0.0001/epoch_100

``--checkpoint`` and ``--set relation.*`` as in ``rel_test``. The printed
lines and the CSV row are the JAX tool's. The run ends with a ``summary:``
log line: the metrics, seconds and the kernel launch counts (none).
"""
from __future__ import annotations

import os
import time

from openpvsg_torch.tools.common import (base_parser, kernel_launches,
                                         load_config, load_relation_params,
                                         log_summary, make_relation_executor,
                                         maybe_mesh, setup_logging)


def main(argv=None):
    parser = base_parser("Relation final (mask-grounded) evaluation")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--model-name", default="transformer")
    parser.add_argument("--split", default="val")
    parser.add_argument("--num-top-pairs", type=int, default=100)
    parser.add_argument("--mark", default="standard")
    args = parser.parse_args(argv)
    cfg = load_config(args)

    from openpvsg_torch.data.datasets import PVSGRelationDataset
    from openpvsg_torch.data.pvsg import PVSGRelationAnnotation
    from openpvsg_torch.eval.rel_full_eval import evaluate_full, save_metrics_to_csv
    from openpvsg_torch.infer.segmenter import resolve_device

    mesh = maybe_mesh(args.device, n_time=args.n_time)
    device = mesh.first if mesh is not None else resolve_device(args.device)

    work_dir = os.path.join(cfg.data.work_dir, f"{args.split}_save_qf")
    csv_path = os.path.join(cfg.data.work_dir, "relation", "main_results.csv")
    logger = setup_logging(os.path.dirname(csv_path), "rel_test_full")
    launches_before = kernel_launches()

    ds = PVSGRelationDataset(cfg.data.anno_file, args.split, work_dir,
                             return_mask=True)
    anno = PVSGRelationAnnotation(cfg.data.anno_file, args.split)
    model = load_relation_params(args.checkpoint, args.model_name, device,
                                 cfg.relation)
    executor = make_relation_executor(mesh, model)
    if executor is not None:
        logger.info(f"relation scoring on a (data={mesh.shape['data']}, "
                    f"time={mesh.shape['time']}) mesh")
    t0 = time.perf_counter()
    out = evaluate_full(model, (ds[i] for i in range(len(ds))), anno,
                        cfg.data.data_dir, args.num_top_pairs, executor=executor)
    seconds = time.perf_counter() - t0
    for tag, metrics in (("", out["metrics"]), ("Soft ", out["soft_metrics"])):
        for K in (20, 50, 100):
            m = metrics[K]
            print("-" * 67)
            print(f"{tag}Recall@{K}: {100 * m['recall']:.2f}")
            print(f"{tag}Mean Recall@{K}: {100 * m['mean_recall']:.2f}")
            print(f"{tag}Weak Recall@{K}: {100 * m['weak_recall']:.2f}")
            print(f"{tag}Weak Mean Recall@{K}: {100 * m['weak_mean_recall']:.2f}")
    save_metrics_to_csv(out["metrics"], [], (20, 50, 100), csv_path,
                        f"{args.model_name}_{args.mark}")
    summary = {"videos": len(ds), "seconds": seconds,
               "metrics": {str(K): out["metrics"][K] for K in (20, 50, 100)},
               "soft_metrics": {str(K): out["soft_metrics"][K] for K in (20, 50, 100)},
               "launches": kernel_launches(since=launches_before)}
    log_summary(logger, summary)
    return summary


if __name__ == "__main__":
    main()
