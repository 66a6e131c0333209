"""Pair selection, GT construction and result generation for the relation
head, copied from ``openpvsg_tpu/models/relation/utils.py`` (reference:
models/relation_head/train_utils.py:30-125 and test_utils.py). Host-side
numpy: they shape the variable-size GT lists into the fixed-size tensors
the model consumes, and rank its outputs.
"""
from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

import numpy as np


def pick_top_pairs(gt_relations: Sequence[Dict], pred_matrix: np.ndarray,
                   num_total_pairs: int = 100) -> List[List[int]]:
    """GT pairs + top predicted pairs, deduped (reference:
    train_utils.py:30-55)."""
    flat = np.asarray(pred_matrix).reshape(-1)
    max_pairs = min(flat.size, num_total_pairs)
    gt_pairs = [(int(r["subject_index"]), int(r["object_index"]))
                for r in gt_relations]
    k = max(max_pairs - len(gt_pairs), 0)
    top_idx = np.argsort(-flat)[:k]
    n = pred_matrix.shape[0]
    top_pairs = [(int(i // n), int(i % n)) for i in top_idx if i // n != i % n]
    combined = list(dict.fromkeys(gt_pairs + top_pairs))
    return [[s, o] for s, o in combined]


def get_gt_pairs(gt_relations: Sequence[Dict],
                 num_total_pairs: int = 100,
                 rng: random.Random | None = None) -> List[List[int]]:
    """Unique GT (subject, object) pairs, subsampled to the budget
    (reference: train_utils.py:58-64)."""
    rng = rng or random
    gt_pairs = list({(int(r["subject_index"]), int(r["object_index"]))
                     for r in gt_relations})
    if len(gt_pairs) > num_total_pairs:
        gt_pairs = rng.sample(gt_pairs, num_total_pairs)
    return [[s, o] for s, o in gt_pairs]


def concatenate_sub_obj(sub_feats: np.ndarray, obj_feats: np.ndarray,
                        selected_pairs: Sequence[Sequence[int]]) -> np.ndarray:
    """(N, T, D) x2 + P pairs -> (P, T, 2D) (reference: train_utils.py:67-81)."""
    pairs = np.asarray(selected_pairs, dtype=int)
    return np.concatenate(
        [np.asarray(sub_feats)[pairs[:, 0]], np.asarray(obj_feats)[pairs[:, 1]]],
        axis=-1)


def generate_gt_matrix(gt_relations: Sequence[Dict],
                       selected_pairs: Sequence[Sequence[int]],
                       span_shape: Tuple[int, int, int],
                       custom_span: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Span + probability targets honoring the sampled frame window
    (reference: train_utils.py:84-109)."""
    num_pairs, num_frames, num_relations = span_shape
    gt_span = np.zeros(span_shape, dtype=np.float32)
    gt_prob = np.zeros((num_pairs, num_relations), dtype=np.float32)
    pairs = [list(map(int, p)) for p in selected_pairs]
    for rel in gt_relations:
        key = [int(rel["subject_index"]), int(rel["object_index"])]
        if key in pairs:
            pi = pairs.index(key)
            ri = int(rel["relation"])
            span = np.asarray(rel["relation_span"]).reshape(-1)
            gt_span[pi, :, ri] = span[custom_span[0]:custom_span[1]]
            gt_prob[pi, ri] = 1.0
    return gt_span, gt_prob


def reshape_and_filter(gt_span: np.ndarray, span_pred: np.ndarray):
    """Keep only (pair, relation) rows with a nonzero GT span (reference:
    train_utils.py:112-125)."""
    gt = np.transpose(gt_span, (0, 2, 1)).reshape(-1, gt_span.shape[1])
    pred = np.transpose(np.asarray(span_pred), (0, 2, 1)).reshape(-1, span_pred.shape[1])
    nz = np.any(gt != 0, axis=1)
    return gt[nz], pred[nz]


def filter_span_mask(gt_span: np.ndarray) -> np.ndarray:
    """The masked form of reshape_and_filter: a (P, R) bool mask of rows
    with any GT span, for a masked-mean loss instead of a gather."""
    return np.any(gt_span != 0, axis=1)


# ---------------------------------------------------------------------------
# Test-time utilities
# ---------------------------------------------------------------------------

def pick_top_pairs_eval(pred_matrix: np.ndarray,
                        num_total_pairs: int = 100) -> List[List[int]]:
    """Top-K pairs of the pair matrix, diagonal masked (reference:
    test_utils.py:4-22)."""
    m = np.asarray(pred_matrix, dtype=np.float64).copy()
    np.fill_diagonal(m, -np.inf)
    flat = m.reshape(-1)
    k = min(flat.size, num_total_pairs)
    idx = np.argsort(-flat)[:k]
    n = m.shape[0]
    return [[int(i // n), int(i % n)] for i in idx if i // n != i % n]


def generate_results(span_pred: np.ndarray, prob: np.ndarray,
                     selected_pairs: Sequence[Sequence[int]]) -> List[Dict]:
    """Rank triplets by per-(pair, relation) probability; spans binarized at
    logit 0 (reference: test_utils.py:25-53)."""
    prob = np.asarray(prob)
    span_pred = np.asarray(span_pred)
    num_relations = prob.shape[1]
    order = np.argsort(-prob.reshape(-1))
    results = []
    for idx in order:
        pair_index = int(idx // num_relations)
        relation_index = int(idx % num_relations)
        s, o = selected_pairs[pair_index]
        span = (span_pred[pair_index, :, relation_index] > 0).astype(float)
        results.append({
            "subject_index": int(s), "object_index": int(o),
            "relation": relation_index, "relation_span": span,
        })
    return results


def generate_pairwise_results(span_pred: np.ndarray, prob: np.ndarray,
                              selected_pairs: Sequence[Sequence[int]]) -> List[Dict]:
    """One (max-probability) relation per pair (reference:
    test_utils.py:56-84)."""
    prob = np.asarray(prob)
    span_pred = np.asarray(span_pred)
    max_idx = prob.argmax(axis=1)
    max_probs = prob.max(axis=1)
    results = []
    for pair_idx in np.argsort(-max_probs):
        relation_index = int(max_idx[pair_idx])
        s, o = selected_pairs[pair_idx]
        span = (span_pred[pair_idx, :, relation_index] > 0).astype(float)
        results.append({
            "subject_index": int(s), "object_index": int(o),
            "relation": relation_index, "relation_span": span,
        })
    return results
