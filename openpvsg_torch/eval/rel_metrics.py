"""Relation (scene-graph) evaluation metrics, copied from
``openpvsg_tpu/eval/rel_metrics.py``: span IoU, mask IoU, pair recall,
triplet R@K / mR@K with hit / weak-hit variants, and mask-grounded vIoU.

Numerically the reference's (utils/rel_metrics.py), but the vIoU evaluator
reads GT mask tubes decoded once per video instead of re-reading every GT
PNG for every (relation, prediction) pair.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def span_iou(span1: np.ndarray, span2: np.ndarray) -> float:
    """IoU of two binary temporal spans (reference: rel_metrics.py:6-9)."""
    span1 = np.asarray(span1, dtype=np.float64)
    span2 = np.asarray(span2, dtype=np.float64)
    inter = float((span1 * span2).sum())
    union = float(span1.sum() + span2.sum() - inter)
    return inter / union if union > 0 else 0.0


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two binary masks (reference: rel_metrics.py:12-18)."""
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter / union) if union > 0 else 0.0


def pair_recall_at_k(selected_pairs: Sequence, gt_pairs: Sequence, k: int = 20) -> float:
    """Recall of GT (subject, object) pairs in the top-k proposals
    (reference: rel_metrics.py:21-26)."""
    sel = set(tuple(p) for p in list(selected_pairs)[:k])
    gt = set(tuple(p) for p in gt_pairs)
    return len(sel & gt) / len(gt) if gt else 0.0


def final_metrics(relation_recall_dict: Dict[int, Dict], k_values: Sequence[int]) -> Dict[int, Dict[str, float]]:
    """Aggregate per-relation hit counters into R@K / mR@K (+weak variants)
    (reference: rel_metrics.py:29-57).

    relation_recall_dict[K][rel] = {'hit': n, 'weak_hit': n, 'total': n}.
    """
    out: Dict[int, Dict[str, float]] = {}
    first = relation_recall_dict[k_values[0]]
    num_valid = len([r for r in first.values() if r["total"] != 0])
    for k in k_values:
        rels = relation_recall_dict[k].values()
        total_hit = sum(r["hit"] for r in rels)
        total_weak = sum(r["weak_hit"] for r in rels)
        total_gt = sum(r["total"] for r in rels)
        recall = total_hit / total_gt if total_gt > 0 else 0.0
        weak_recall = total_weak / total_gt if total_gt > 0 else 0.0
        mean_recall = (
            sum(r["hit"] / r["total"] for r in rels if r["total"] != 0) / num_valid
            if num_valid else 0.0
        )
        weak_mean_recall = (
            sum(r["weak_hit"] / r["total"] for r in rels if r["total"] != 0) / num_valid
            if num_valid else 0.0
        )
        out[k] = {
            "recall": recall,
            "mean_recall": mean_recall,
            "weak_recall": weak_recall,
            "weak_mean_recall": weak_mean_recall,
        }
    return out


class GtTubeCache:
    """Pre-decoded GT object-id mask tube for one video.

    Provides (frame_id, object_id) -> binary mask without touching the
    filesystem per query, from an in-memory (T, H, W) stack of object-id
    maps (given, or decoded from the PNGs by ``from_paths``).
    """

    def __init__(self, pan_masks: np.ndarray):
        self.pan_masks = pan_masks  # (T, H, W) object-id maps

    @classmethod
    def from_paths(cls, mask_paths: Sequence[str]) -> "GtTubeCache":
        """Decode the mask PNGs (Pillow is imported here only)."""
        from PIL import Image

        frames = [np.array(Image.open(p)) for p in mask_paths]
        return cls(np.stack(frames, axis=0))

    def __len__(self):
        return self.pan_masks.shape[0]

    def mask(self, frame_id: int, object_id: int) -> np.ndarray:
        return self.pan_masks[frame_id] == object_id

    def present(self, frame_id: int, object_id: int) -> bool:
        return bool((self.pan_masks[frame_id] == object_id).any())


def calculate_viou(
    gt_set: Tuple[int, int, Sequence[Sequence[int]]],
    pred_set: Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray], np.ndarray],
    gt_tubes: GtTubeCache,
) -> Tuple[float, float]:
    """Mask-grounded span IoU of one predicted triplet against one GT triplet
    (reference: utils/rel_metrics.py:59-115 `calculate_viou`).

    gt_set   = (gt_subject_object_id, gt_object_object_id, gt_span_ranges)
    pred_set = (pred_sub_masks {frame: HxW bool}, pred_obj_masks, pred_span)
    Returns (iou, iou_weak): standard protocol and the span-agnostic variant.
    """
    gt_sub_idx, gt_obj_idx, gt_span_list = gt_set
    pred_sub_masks, pred_obj_masks, pred_span_list = pred_set
    pred_span_list = np.asarray(pred_span_list)

    gt_real_span = np.zeros_like(pred_span_list)
    pred_hit = np.zeros_like(pred_span_list)

    for start, end in gt_span_list:
        for frame_id in range(start, end + 1):
            if frame_id >= len(pred_span_list) or frame_id >= len(gt_tubes):
                continue
            gt_sub_mask = gt_tubes.mask(frame_id, gt_sub_idx)
            gt_obj_mask = gt_tubes.mask(frame_id, gt_obj_idx)
            if gt_sub_mask.any() and gt_obj_mask.any():
                gt_real_span[frame_id] = 1
            if frame_id in pred_sub_masks and frame_id in pred_obj_masks:
                sub_iou = mask_iou(gt_sub_mask, np.asarray(pred_sub_masks[frame_id], dtype=bool))
                obj_iou = mask_iou(gt_obj_mask, np.asarray(pred_obj_masks[frame_id], dtype=bool))
                if sub_iou >= 0.5 and obj_iou >= 0.5:
                    pred_hit[frame_id] = 1

    pred_hit_real = np.logical_and(pred_hit == 1, pred_span_list == 1).astype(pred_hit.dtype)
    iou_weak = span_iou(pred_hit, gt_real_span)
    iou = span_iou(pred_hit_real, gt_real_span)
    return iou, iou_weak
