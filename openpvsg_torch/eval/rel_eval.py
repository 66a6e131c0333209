"""Relation-head evaluation, the port of ``openpvsg_tpu/eval/rel_eval.py``:
the feature-level proxy protocol (reference: tools/rel_test.py:16-113) and
its aggregation into R@K / mR@K and pair recall.

The model runs on its own device on shapes padded to the JAX package's
evaluation buckets (the validity masks make the padding exact); the ranked
triplet accounting runs on the host. With ``device_gather=True`` the pair
features are gathered on the device (``index_select``) and only the (N, N)
pair matrix, the chosen pair indices and the binarized spans cross to the
host; ``device_gather=False`` gathers them on the host (the oracle). Both
feed the same ``predict`` call with the same padded tensor (padded frames
zero), so their results are equal. The forward runs in IEEE float32 (TF32
off), whatever the caller set.

An ``executor`` (``parallel.tp.TimeShardedRelation``) runs the model over
its mesh instead, frames split over 'time' and pairs over 'data'
(``openpvsg_tpu/eval/rel_eval.py:107-182``): ``propose`` on the padded
video, then ``predict_pairs`` (the gather on the devices) or, with
``device_gather=False``, ``predict`` on the host-built pair tensor, the
same tensor, so the two modes give the same triplets.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from openpvsg_torch.eval.rel_metrics import (
    final_metrics, pair_recall_at_k, span_iou)
from openpvsg_torch.models.relation.utils import (
    concatenate_sub_obj, generate_pairwise_results, generate_results,
    pick_top_pairs_eval)
from openpvsg_torch.train.segmenter import ieee_float32

K_VALUES = (20, 50, 100)

TUBE_BUCKETS = (20, 50, 100, 200)
FRAME_BUCKETS = (128, 256, 512, 1024, 2048)
PAIR_BUCKETS = (25, 50, 100, 200)


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + buckets[-1] - 1) // buckets[-1]) * buckets[-1]


@torch.no_grad()
def evaluate_video(model: torch.nn.Module, feats: np.ndarray,
                   num_top_pairs: int = 100, pairwise: bool = True,
                   executor=None, device_gather: bool = True):
    """Forward one video (N, T, D) on the model's device, or over the
    ``executor``'s mesh; returns (selected_pairs, ranked results)."""
    if executor is not None:
        return _evaluate_video_mesh(executor, feats, num_top_pairs, pairwise,
                                    device_gather)
    dev = next(model.parameters()).device
    n, t, _ = feats.shape
    fp, tube_valid, frame_valid = _padded(feats)
    tb = fp.shape[1]
    tube_valid = torch.from_numpy(tube_valid).to(dev)
    frame_valid = torch.from_numpy(frame_valid).to(dev)

    with ieee_float32():
        out = model(torch.from_numpy(fp).to(dev), tube_valid=tube_valid,
                    frame_valid=frame_valid)
        pred_matrix = out["pred_matrix"][:n, :n].cpu().numpy()
        selected_pairs = pick_top_pairs_eval(pred_matrix, num_top_pairs)
        if not selected_pairs:
            return [], []

        P = len(selected_pairs)
        pb = _bucket(P, PAIR_BUCKETS)
        idx = np.zeros((pb, 2), np.int64)
        idx[:P] = np.asarray(selected_pairs, np.int64)
        if device_gather:
            idx = torch.from_numpy(idx).to(dev)
            pair = torch.cat([out["sub_feats"].index_select(0, idx[:, 0]),
                              out["obj_feats"].index_select(0, idx[:, 1])],
                             dim=-1) * frame_valid[None, :, None]
        else:
            sub = out["sub_feats"][:n, :t].cpu().numpy()
            obj = out["obj_feats"][:n, :t].cpu().numpy()
            pair_feats = concatenate_sub_obj(sub, obj, selected_pairs)
            pf = np.zeros((pb, tb, pair_feats.shape[-1]), np.float32)
            pf[:P, :t] = pair_feats
            pair = torch.from_numpy(pf).to(dev)
        span, prob = model.predict(pair, frame_valid)
        # the spans cross binarized: generate_results thresholds at logit 0
        span_bin = (span[:P, :t] > 0).cpu().numpy()
        prob = prob[:P].cpu().numpy()
    gen = generate_pairwise_results if pairwise else generate_results
    return selected_pairs, gen(span_bin.astype(np.float32), prob, selected_pairs)


def _padded(feats: np.ndarray):
    """The video padded to the evaluation buckets, with its tube and frame
    validity."""
    n, t, d = feats.shape
    nb, tb = _bucket(n, TUBE_BUCKETS), _bucket(t, FRAME_BUCKETS)
    fp = np.zeros((nb, tb, d), np.float32)
    fp[:n, :t] = feats
    tube_valid = np.zeros(nb, bool)
    tube_valid[:n] = True
    frame_valid = np.zeros(tb, bool)
    frame_valid[:t] = True
    return fp, tube_valid, frame_valid


def _evaluate_video_mesh(executor, feats, num_top_pairs, pairwise, device_gather):
    n, t, _ = feats.shape
    fp, tube_valid, frame_valid = _padded(feats)
    out = executor.propose(fp, tube_valid=tube_valid, frame_valid=frame_valid)
    selected_pairs = pick_top_pairs_eval(out["pred_matrix"][:n, :n].cpu().numpy(),
                                         num_top_pairs)
    if not selected_pairs:
        return [], []
    P = len(selected_pairs)
    pb = _bucket(P, PAIR_BUCKETS)
    idx = np.zeros((pb, 2), np.int64)
    idx[:P] = np.asarray(selected_pairs, np.int64)
    if device_gather:
        span_bin, prob = executor.predict_pairs(out, idx, frame_valid)
        span_bin, prob = span_bin[:P, :t], prob[:P]
    else:
        sub = out["sub_feats"].full()[:n, :t].cpu().numpy()
        obj = out["obj_feats"].full()[:n, :t].cpu().numpy()
        pair_feats = concatenate_sub_obj(sub, obj, selected_pairs)
        pf = np.zeros((pb, fp.shape[1], pair_feats.shape[-1]), np.float32)
        pf[:P, :t] = pair_feats
        span, prob = executor.predict(pf, frame_valid=frame_valid)
        span_bin = (span[:P, :t] > 0).cpu().numpy()
        prob = prob[:P].cpu().numpy()
    gen = generate_pairwise_results if pairwise else generate_results
    return selected_pairs, gen(span_bin.astype(np.float32), prob, selected_pairs)


def evaluate(model: torch.nn.Module, dataset, num_top_pairs: int,
             relation_names: Sequence[str], pairwise: bool = True,
             executor=None, device_gather: bool = True) -> Dict:
    """dataset yields {'feats': (N, T, D), 'relations': [...]}. Returns
    {'pair_recall_20', K: {recall, mean_recall, weak_recall,
    weak_mean_recall}} (reference: rel_test.py evaluate)."""
    recall_dict = {
        K: {idx: {"name": name, "total": 0, "hit": 0, "weak_hit": 0}
            for idx, name in enumerate(relation_names)}
        for K in K_VALUES
    }
    pair_recalls: List[float] = []

    for item in dataset:
        feats = np.asarray(item["feats"], dtype=np.float32)
        gt_relations = item["relations"]
        selected_pairs, results = evaluate_video(
            model, feats, num_top_pairs, pairwise, executor=executor,
            device_gather=device_gather)
        gt_pairs = [[int(r["subject_index"]), int(r["object_index"])]
                    for r in gt_relations]
        pair_recalls.append(pair_recall_at_k(
            [tuple(p) for p in selected_pairs],
            [tuple(p) for p in gt_pairs], 20))

        for gt in gt_relations:
            rel_key = (int(gt["subject_index"]), int(gt["object_index"]),
                       int(gt["relation"]))
            for K in K_VALUES:
                recall_dict[K][rel_key[2]]["total"] += 1
            for idx, result in enumerate(results):
                if (result["subject_index"], result["object_index"],
                        result["relation"]) == rel_key:
                    t_iou = span_iou(np.asarray(gt["relation_span"]).reshape(-1),
                                     result["relation_span"])
                    for K in K_VALUES:
                        if idx < K:
                            recall_dict[K][rel_key[2]]["weak_hit"] += 1
                            if t_iou >= 0.5:
                                recall_dict[K][rel_key[2]]["hit"] += 1
                    break

    out = final_metrics(recall_dict, K_VALUES)
    out["pair_recall_20"] = float(np.mean(pair_recalls)) if pair_recalls else 0.0
    return out
