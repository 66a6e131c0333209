"""Panoptic quality (PQ / VPQ) evaluation: the port's copy of
``openpvsg_tpu/eval/vpq.py`` (the same dicts, nan included).

Numerically equivalent to the reference implementation (reference:
datasets/datasets/utils.py:31-104 `vpq_eval`, aggregation in
datasets/datasets/pvsg_image.py:127-175) but fully vectorized: the per-pixel
dict/python-loop accounting is replaced with np.unique over the joint
(gt, pred) id array.

Id format: segment = class_id * max_ins + instance_id ("hb"/eval format with
max_ins = 10000); class `ign_id` (= num_classes) is void/ignore.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def vpq_eval(
    element: Sequence[np.ndarray],
    num_classes: int = 126,
    max_ins: int = 10000,
    ign_id: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-class (iou_sum, tp, fn, fp) for one frame (or frame tube).

    `element` = (pred_ids, gt_ids): int arrays of equal shape in eval id
    format. Returns arrays of length num_classes + 1.
    """
    if ign_id is None:
        ign_id = num_classes
    pred_ids, gt_ids = element
    pred_ids = np.asarray(pred_ids).ravel().astype(np.int64)
    gt_ids = np.asarray(gt_ids).ravel().astype(np.int64)
    num_cat = num_classes + 1

    iou_per_class = np.zeros(num_cat, dtype=np.float64)
    tp_per_class = np.zeros(num_cat, dtype=np.float64)
    fn_per_class = np.zeros(num_cat, dtype=np.float64)
    fp_per_class = np.zeros(num_cat, dtype=np.float64)

    pred_uniq, pred_areas = np.unique(pred_ids, return_counts=True)
    gt_uniq, gt_areas = np.unique(gt_ids, return_counts=True)
    pred_area_of = dict(zip(pred_uniq.tolist(), pred_areas.tolist()))
    gt_area_of = dict(zip(gt_uniq.tolist(), gt_areas.tolist()))

    offset = np.int64(1 << 32)
    assert pred_ids.max(initial=0) < offset and gt_ids.max(initial=0) < offset
    int_uniq, int_areas = np.unique(gt_ids * offset + pred_ids, return_counts=True)
    int_gt = int_uniq // offset
    int_pred = int_uniq % offset

    void_id = ign_id * max_ins
    # overlap of each pred segment with the void gt segment
    void_rows = int_gt == void_id
    void_overlap = dict(zip(int_pred[void_rows].tolist(), int_areas[void_rows].tolist()))
    # overlap of each pred segment with ANY ignore-class gt segment
    ign_rows = (int_gt // max_ins) == ign_id
    ignored_overlap: Dict[int, int] = {}
    for p, a in zip(int_pred[ign_rows].tolist(), int_areas[ign_rows].tolist()):
        ignored_overlap[p] = ignored_overlap.get(p, 0) + a

    gt_matched: set = set()
    pred_matched: set = set()
    same_cat = (int_gt // max_ins) == (int_pred // max_ins)
    for gt_id, pred_id, inter in zip(
        int_gt[same_cat].tolist(), int_pred[same_cat].tolist(),
        int_areas[same_cat].tolist(),
    ):
        union = (gt_area_of[gt_id] + pred_area_of[pred_id] - inter
                 - void_overlap.get(pred_id, 0))
        iou = inter / union if union > 0 else 0.0
        if iou > 0.5:
            cat = gt_id // max_ins
            tp_per_class[cat] += 1
            iou_per_class[cat] += iou
            gt_matched.add(gt_id)
            pred_matched.add(pred_id)

    for gt_id in gt_uniq.tolist():
        if gt_id in gt_matched:
            continue
        cat = gt_id // max_ins
        if cat == ign_id:
            continue
        fn_per_class[cat] += 1

    for pred_id, pred_area in zip(pred_uniq.tolist(), pred_areas.tolist()):
        if pred_id in pred_matched:
            continue
        if ignored_overlap.get(pred_id, 0) / pred_area > 0.5:
            continue
        fp_per_class[pred_id // max_ins] += 1

    return iou_per_class, tp_per_class, fn_per_class, fp_per_class


def window_vpq(
    pred_seq: Sequence[np.ndarray],
    gt_seq: Sequence[np.ndarray],
    num_classes: int,
    num_thing_classes: int,
    num_stuff_classes: int,
    windows: Sequence[int] = (1, 2, 4, 8),
    max_ins: int = 10000,
    ign_id: int | None = None,
) -> Dict[str, float]:
    """Window-k VPQ over stitched tubes — the video-native quality measure
    per-frame PQ misses (VPSNet's VPQ^k; the reference only ships the
    per-frame kernel, datasets/datasets/utils.py:31-104).

    pred_seq / gt_seq: per-frame (H, W) eval-format id maps for ONE video
    with temporally consistent instance ids. For each window size k, every
    length-k sliding window is evaluated as one 3-D tube: a segment whose
    identity switches mid-window cannot match across the whole tube, so id
    switches that per-frame PQ ignores are penalized. Returns
    {"VPQ@k": pq, ...} plus "VPQ" (mean over k).
    """
    T = len(pred_seq)
    assert len(gt_seq) == T
    out: Dict[str, float] = {}
    for k in windows:
        if k > T:
            continue
        stats = []
        for lo in range(0, T - k + 1):
            pred_tube = np.stack(pred_seq[lo:lo + k])
            gt_tube = np.stack(gt_seq[lo:lo + k])
            stats.append(vpq_eval([pred_tube, gt_tube],
                                  num_classes=num_classes, max_ins=max_ins,
                                  ign_id=ign_id))
        out[f"VPQ@{k}"] = pq_summary(
            stats, num_thing_classes, num_stuff_classes)["PQ"]
    ks = [v for key, v in out.items() if key.startswith("VPQ@")]
    out["VPQ"] = float(np.mean(ks)) if ks else 0.0
    return out


def pq_summary(
    stats: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    num_thing_classes: int = 115,
    num_stuff_classes: int = 11,
) -> Dict[str, float]:
    """Aggregate per-frame vpq_eval tuples into PQ / PQ_th / PQ_st
    (reference: datasets/datasets/pvsg_image.py:127-175)."""
    num_classes = num_thing_classes + num_stuff_classes
    iou = np.zeros(num_classes + 1)
    tp = np.zeros(num_classes + 1)
    fn = np.zeros(num_classes + 1)
    fp = np.zeros(num_classes + 1)
    for s in stats:
        iou += s[0]
        tp += s[1]
        fn += s[2]
        fp += s[3]
    iou, tp, fn, fp = (a[:num_classes] for a in (iou, tp, fn, fp))

    # Matches the reference exactly: sq = iou/tp, rq = tp/(tp+.5fn+.5fp),
    # pq = nan_to_num(sq*rq), mean over ALL classes (pvsg_image.py:164-175).
    with np.errstate(divide="ignore", invalid="ignore"):
        sq = iou / tp
        rq = tp / (tp + 0.5 * fn + 0.5 * fp)
        pq_per_class = np.nan_to_num(sq * rq)

    return {
        "PQ": float(pq_per_class.mean()),
        "PQ_th": float(pq_per_class[:num_thing_classes].mean()),
        "PQ_st": float(pq_per_class[num_thing_classes:num_classes].mean()),
        "per_class": pq_per_class,
    }
