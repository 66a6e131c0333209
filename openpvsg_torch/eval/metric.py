"""Standalone relation mAP + Recall@N harness (reference: utils/metric.py),
the port's copy of ``openpvsg_tpu/eval/metric.py`` (plain numpy, held to
it in tests/test_torch_serving_rest.py).

Greedy per-video matching of score-ranked predicted triplets to GT triplets
at a tube-vIoU threshold (min of subject/object vIoU over the relation
span), VOC AP per video, and global Recall@{10,20,50} over all relation
instances. Mask set-ops are vectorized (the reference loops per frame).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


class Result(dict):
    """Attribute-dict result container (reference: metric.py:10-48)."""

    def __init__(self, vid=None, bbox_trajs=None, seg_masks=None,
                 relations=None, **kwargs):
        super().__init__(**kwargs)
        self.__dict__["vid"] = vid
        self.__dict__["bbox_trajs"] = bbox_trajs
        self.__dict__["seg_masks"] = seg_masks
        self.__dict__["relations"] = relations

    def __getattr__(self, attr):
        if attr in self.__dict__:
            return self.__dict__[attr]
        return self.get(attr)

    def __setattr__(self, key, value):
        self.__dict__[key] = value
        self[key] = value


def relation_indicator(num_frames: int, durs: Sequence[Sequence[int]]) -> np.ndarray:
    """1-based inclusive frame intervals -> bool mask (reference:
    generate_helper_relation_indicator, metric.py:51-57)."""
    out = np.zeros(num_frames, dtype=bool)
    for start, end in durs:
        out[start - 1:end] = True
    return out


def viou_over_whole_length_video(tube1: np.ndarray, durs1,
                                 tube2: np.ndarray, durs2) -> float:
    """Mask-tube vIoU restricted to relation spans (reference:
    metric.py:98-138, pan_seg branch), vectorized."""
    t = tube1.shape[0]
    has1 = relation_indicator(t, durs1)
    has2 = relation_indicator(t, durs2)
    both = np.logical_and(has1, has2)
    inter = np.count_nonzero(np.logical_and(tube1[both], tube2[both]))
    union = (np.count_nonzero(tube1[has1]) + np.count_nonzero(tube2[has2])
             - inter)
    return float(inter / union) if union > 0 else 0.0


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) else 0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_relations_of_single_video(groundtruth: Result, prediction: Result,
                                   viou_threshold: float = 0.5):
    """Greedy matching of ranked predictions to GT triplets (reference:
    eval_relations_of_singel_video, metric.py:177-246)."""
    gt_tubes = groundtruth.seg_masks
    gt_relations = groundtruth.relations
    pred_tubes = prediction.seg_masks
    pred_relations = sorted(prediction.relations,
                            key=lambda x: x["score"], reverse=True)

    gt_detected = np.zeros(len(gt_relations), dtype=bool)
    hit_scores = np.full(len(pred_relations), -np.inf)

    for pred_idx, pred in enumerate(pred_relations):
        (ps_id, ps_cls), (po_id, po_cls), p_rel = pred["triplet"]
        ov_max, k_max = -np.inf, -1
        for gt_idx, gt in enumerate(gt_relations):
            (gs_id, gs_cls), (go_id, go_cls), g_rel = gt["triplet"]
            if gt_detected[gt_idx] or (ps_cls, po_cls, p_rel) != (gs_cls, go_cls, g_rel):
                continue
            s_viou = viou_over_whole_length_video(
                gt_tubes[gs_id], gt["durs"], pred_tubes[ps_id], pred["durs"])
            o_viou = viou_over_whole_length_video(
                gt_tubes[go_id], gt["durs"], pred_tubes[po_id], pred["durs"])
            ov = min(s_viou, o_viou)
            if ov >= viou_threshold and ov > ov_max:
                ov_max, k_max = ov, gt_idx
        if k_max >= 0:
            hit_scores[pred_idx] = pred["score"]
            gt_detected[k_max] = True

    tp = np.isfinite(hit_scores)
    cum_tp = np.cumsum(tp).astype(np.float32)
    cum_fp = np.cumsum(~tp).astype(np.float32)
    rec = cum_tp / max(len(gt_relations), np.finfo(np.float32).eps)
    prec = cum_tp / np.maximum(cum_tp + cum_fp, np.finfo(np.float32).eps)
    return prec, rec, hit_scores


def evaluate(groundtruths: Sequence[Result], predictions: Sequence[Result],
             viou_threshold: float = 0.5,
             topk_nreturns: Sequence[int] = (10, 20, 50)):
    """-> (mean_ap, {K: recall}) (reference: metric.py:249-297)."""
    video_ap = {}
    tot_scores = defaultdict(list)
    tot_tp = defaultdict(list)
    tot_gt = 0
    for gt, pred in zip(groundtruths, predictions):
        if not gt.relations:
            continue
        tot_gt += len(gt.relations)
        prec, rec, scores = eval_relations_of_single_video(
            gt, pred, viou_threshold)
        video_ap[gt.vid] = voc_ap(rec, prec)
        tp = np.isfinite(scores)
        for k in topk_nreturns:
            cut = min(k, scores.size)
            tot_scores[k].append(scores[:cut])
            tot_tp[k].append(tp[:cut])

    mean_ap = float(np.mean(list(video_ap.values()))) if video_ap else 0.0
    rec_at_n = {}
    for k in topk_nreturns:
        if not tot_scores[k]:
            rec_at_n[k] = 0.0
            continue
        scores = np.concatenate(tot_scores[k])
        tps = np.concatenate(tot_tp[k])[np.argsort(scores)[::-1]]
        cum_tp = np.cumsum(tps).astype(np.float32)
        rec = cum_tp / max(tot_gt, np.finfo(np.float32).eps)
        rec_at_n[k] = float(rec[-1]) if rec.size else 0.0
    return mean_ap, rec_at_n
