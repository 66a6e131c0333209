"""The final mask-grounded relation evaluation, the port of
``openpvsg_tpu/eval/rel_full_eval.py`` (reference:
tools/rel_test_full.py:96-241).

Ranked triplets over predicted tubes are matched against the raw pvsg.json
GT: a prediction counts for a GT relation when the (subject class, object
class, relation) triple matches and the mask-grounded span vIoU clears the
threshold: a hit at vIoU >= 0.5, a weak hit at >= 0.1, plus "soft" variants
that add up the vIoU itself. Each video's GT object-id tube is decoded once
into a ``GtTubeCache``.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from openpvsg_torch.data.pvsg import PVSGRelationAnnotation, frame_paths
from openpvsg_torch.eval.rel_eval import _no_executor, evaluate_video
from openpvsg_torch.eval.rel_metrics import GtTubeCache, calculate_viou, final_metrics

K_VALUES = (20, 50, 100)


def evaluate_full(
    model: torch.nn.Module,
    rel_dataset,                    # yields {'vid', 'feats', 'masks', ...}
    anno: PVSGRelationAnnotation,
    data_dir: str,
    num_top_pairs: int = 100,
    relation_names: Optional[Sequence[str]] = None,
    executor=None,
    device_gather: bool = True,
) -> Dict:
    """{'metrics', 'soft_metrics'}, each {K: {recall, mean_recall,
    weak_recall, weak_mean_recall}}; the GT object-id maps are read from
    the mask PNGs under ``data_dir``."""
    _no_executor(executor)
    relation_names = relation_names or anno.relations
    recall = {K: {i: {"name": n, "total": 0, "hit": 0, "weak_hit": 0}
                  for i, n in enumerate(relation_names)} for K in K_VALUES}
    soft = {K: {i: {"name": n, "total": 0, "hit": 0, "weak_hit": 0}
                for i, n in enumerate(relation_names)} for K in K_VALUES}

    for item in rel_dataset:
        vid = item["vid"]
        feats = np.asarray(item["feats"], np.float32)
        _, results = evaluate_video(model, feats, num_top_pairs=num_top_pairs,
                                    pairwise=False, device_gather=device_gather)
        if not results:
            continue

        gt = anno[vid]
        gt_cls_of = {o["object_id"]: o["category"] for o in gt["objects"]}
        pred_masks: Dict[int, Dict] = item["masks"]  # dense idx -> tube dict

        gt_tubes = GtTubeCache.from_paths(frame_paths(data_dir, vid, "masks"))

        for gt_relation in gt["relations"]:
            sub_idx, obj_idx, rel_idx, gt_span_list = gt_relation
            rel_key = (int(gt_cls_of[sub_idx]), int(gt_cls_of[obj_idx]),
                       int(rel_idx))
            for K in K_VALUES:
                recall[K][rel_key[2]]["total"] += 1
                soft[K][rel_key[2]]["total"] += 1

            for idx, result in enumerate(results):
                sub_tube = pred_masks.get(result["subject_index"])
                obj_tube = pred_masks.get(result["object_index"])
                if not sub_tube or not obj_tube:
                    continue
                if (int(sub_tube["cid"]), int(obj_tube["cid"]),
                        result["relation"]) != rel_key:
                    continue
                sub_frames = {f: m for entry in sub_tube["mask"]
                              for f, m in entry.items()}
                obj_frames = {f: m for entry in obj_tube["mask"]
                              for f, m in entry.items()}
                iou, iou_weak = calculate_viou(
                    (sub_idx, obj_idx, gt_span_list),
                    (sub_frames, obj_frames, result["relation_span"]),
                    gt_tubes)
                if iou >= 0.1:
                    for K in K_VALUES:
                        if idx < K:
                            recall[K][rel_key[2]]["weak_hit"] += 1
                            soft[K][rel_key[2]]["weak_hit"] += iou
                if iou >= 0.5:
                    for K in K_VALUES:
                        if idx < K:
                            recall[K][rel_key[2]]["hit"] += 1
                            soft[K][rel_key[2]]["hit"] += iou
                    break

    return {
        "metrics": final_metrics(recall, K_VALUES),
        "soft_metrics": final_metrics(soft, K_VALUES),
    }


def save_metrics_to_csv(metrics: Dict, pair_recall_list: Sequence[float],
                        k_values: Sequence[int], csv_path: str, mark: str):
    """Append one result row (reference: utils/show_log.py:5-31)."""
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    exists = os.path.isfile(csv_path)
    header = ["Model", "Pair Recall"]
    header += [f"R/mR@{K}" for K in k_values]
    header += [f"wR/wmR@{K}" for K in k_values]
    pr = 100 * np.mean(pair_recall_list) if len(pair_recall_list) else 0.0
    row = [mark, f"{pr:.2f}"]
    for K in k_values:
        m = metrics[K]
        row.append(f"{100 * m['recall']:.2f}/{100 * m['mean_recall']:.2f}")
    for K in k_values:
        m = metrics[K]
        row.append(f"{100 * m['weak_recall']:.2f}/{100 * m['weak_mean_recall']:.2f}")
    with open(csv_path, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(header)
        w.writerow(row)
