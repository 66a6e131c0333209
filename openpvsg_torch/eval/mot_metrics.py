"""MOTS tracking metrics: CLEAR (MOTA/MOTP), IDF1, HOTA and J&F over mask
tubes; the port's copy of ``openpvsg_tpu/eval/mot_metrics.py`` (host numpy
on the port's ``native.pairwise_mask_iou`` and ``linear_sum_assignment``,
the same C++ library).

The reference vendors ~10 kLoC of TrackEval/MOTS/poseval harnesses that the
PVSG pipeline imports but never calls (SURVEY §2.5 'inert'). This module
provides the actually-useful subset natively: per-frame mask matching at
IoU > 0.5 (Hungarian), CLEAR event accounting, and global IDF1 via one
assignment over accumulated id-overlap counts.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from openpvsg_torch import native


FrameMasks = Dict[int, np.ndarray]  # track_id -> binary mask


def _frame_match(gt: FrameMasks, pred: FrameMasks, iou_thr: float = 0.5):
    gids = sorted(gt.keys())
    pids = sorted(pred.keys())
    if not gids or not pids:
        return [], gids, pids
    gt_map = np.full(next(iter(gt.values())).shape, -1, np.int32)
    for i, g in enumerate(gids):
        gt_map[gt[g].astype(bool)] = i
    pr_map = np.full(gt_map.shape, -1, np.int32)
    for j, p in enumerate(pids):
        pr_map[pred[p].astype(bool)] = j
    iou = native.pairwise_mask_iou(gt_map, pr_map, len(gids), len(pids))
    cost = 1.0 - iou
    ri, ci = native.linear_sum_assignment(cost)
    matches = [(gids[i], pids[j], iou[i, j])
               for i, j in zip(ri, ci) if iou[i, j] > iou_thr]
    mg = {m[0] for m in matches}
    mp = {m[1] for m in matches}
    return (matches, [g for g in gids if g not in mg],
            [p for p in pids if p not in mp])


def evaluate_mots(gt_frames: Sequence[FrameMasks],
                  pred_frames: Sequence[FrameMasks],
                  iou_thr: float = 0.5) -> Dict[str, float]:
    """-> {MOTA, MOTP, IDF1, id_switches, fp, fn, matches}."""
    tp = fp = fn = idsw = 0
    iou_sum = 0.0
    last_match: Dict[int, int] = {}
    id_overlap: Dict[Tuple[int, int], int] = {}
    gt_count: Dict[int, int] = {}
    pr_count: Dict[int, int] = {}
    n_gt_total = 0

    for gt, pred in zip(gt_frames, pred_frames):
        matches, miss_g, miss_p = _frame_match(gt, pred, iou_thr)
        tp += len(matches)
        fn += len(miss_g)
        fp += len(miss_p)
        n_gt_total += len(gt)
        for g, p, iou in matches:
            iou_sum += iou
            if g in last_match and last_match[g] != p:
                idsw += 1
            last_match[g] = p
            id_overlap[(g, p)] = id_overlap.get((g, p), 0) + 1
        for g in gt:
            gt_count[g] = gt_count.get(g, 0) + 1
        for p in pred:
            pr_count[p] = pr_count.get(p, 0) + 1

    mota = 1.0 - (fn + fp + idsw) / max(n_gt_total, 1)
    motp = iou_sum / max(tp, 1)

    # IDF1: optimal global gt-id <-> pred-id assignment over overlap counts
    gids = sorted(gt_count)
    pids = sorted(pr_count)
    idtp = 0
    if gids and pids:
        overlap = np.zeros((len(gids), len(pids)))
        for (g, p), c in id_overlap.items():
            overlap[gids.index(g), pids.index(p)] = c
        ri, ci = native.linear_sum_assignment(-overlap)
        idtp = int(overlap[ri, ci].sum())
    denom = sum(gt_count.values()) + sum(pr_count.values())
    idf1 = 2.0 * idtp / max(denom, 1)

    return {"MOTA": mota, "MOTP": motp, "IDF1": idf1,
            "id_switches": idsw, "fp": fp, "fn": fn, "matches": tp}


def _frame_similarity(gt: FrameMasks, pred: FrameMasks):
    """(gt_ids, pred_ids, mask-IoU matrix) for one frame."""
    gids = sorted(gt.keys())
    pids = sorted(pred.keys())
    if not gids or not pids:
        return gids, pids, np.zeros((len(gids), len(pids)))
    gt_map = np.full(next(iter(gt.values())).shape, -1, np.int32)
    for i, g in enumerate(gids):
        gt_map[gt[g].astype(bool)] = i
    pr_map = np.full(gt_map.shape, -1, np.int32)
    for j, p in enumerate(pids):
        pr_map[pred[p].astype(bool)] = j
    return gids, pids, native.pairwise_mask_iou(gt_map, pr_map,
                                                len(gids), len(pids))


def evaluate_hota(gt_frames: Sequence[FrameMasks],
                  pred_frames: Sequence[FrameMasks]) -> Dict[str, float]:
    """HOTA over mask tubes, TrackEval semantics (reference:
    models/unitrack/eval/trackeval/metrics/hota.py:38-118): per-alpha
    Hungarian matching on global-alignment-weighted similarity, then
    HOTA(a) = sqrt(DetA(a) * AssA(a)), averaged over
    alpha in {0.05..0.95}. Similarity is mask IoU.

    Returns {HOTA, DetA, AssA, LocA} (means over the alpha grid).
    """
    alphas = np.arange(0.05, 0.99, 0.05)
    eps = np.finfo(float).eps

    # index tracks
    gid_index: Dict[int, int] = {}
    pid_index: Dict[int, int] = {}
    per_frame = []
    for gt, pred in zip(gt_frames, pred_frames):
        gids, pids, sim = _frame_similarity(gt, pred)
        for g in gids:
            gid_index.setdefault(g, len(gid_index))
        for p in pids:
            pid_index.setdefault(p, len(pid_index))
        per_frame.append((np.asarray([gid_index[g] for g in gids], int),
                          np.asarray([pid_index[p] for p in pids], int),
                          np.asarray(sim)))
    n_gt, n_pr = len(gid_index), len(pid_index)
    if n_gt == 0 or n_pr == 0:
        z = float(n_gt == 0 and n_pr == 0)
        return {"HOTA": z, "DetA": z, "AssA": z, "LocA": 1.0}

    # pass 1: global alignment scores
    potential = np.zeros((n_gt, n_pr))
    gt_count = np.zeros((n_gt, 1))
    pr_count = np.zeros((1, n_pr))
    for gids, pids, sim in per_frame:
        if len(gids) and len(pids):
            denom = sim.sum(0)[None, :] + sim.sum(1)[:, None] - sim
            sim_iou = np.zeros_like(sim)
            m = denom > eps
            sim_iou[m] = sim[m] / denom[m]
            potential[gids[:, None], pids[None, :]] += sim_iou
        gt_count[gids] += 1
        pr_count[0, pids] += 1
    global_align = potential / (gt_count + pr_count - potential)

    # pass 2: per-alpha matching
    A = len(alphas)
    tp = np.zeros(A)
    fn = np.zeros(A)
    fp = np.zeros(A)
    loca = np.zeros(A)
    matches_counts = [np.zeros((n_gt, n_pr)) for _ in alphas]
    for gids, pids, sim in per_frame:
        if len(gids) == 0:
            fp += len(pids)
            continue
        if len(pids) == 0:
            fn += len(gids)
            continue
        score = global_align[gids[:, None], pids[None, :]] * sim
        ri, ci = native.linear_sum_assignment(-score)
        for a, alpha in enumerate(alphas):
            ok = sim[ri, ci] >= alpha - eps
            n = int(ok.sum())
            tp[a] += n
            fn[a] += len(gids) - n
            fp[a] += len(pids) - n
            if n:
                loca[a] += sim[ri[ok], ci[ok]].sum()
                matches_counts[a][gids[ri[ok]], pids[ci[ok]]] += 1

    det_a = tp / np.maximum(1, tp + fn + fp)
    ass_a = np.zeros(A)
    for a in range(A):
        mc = matches_counts[a]
        pair_ass = mc / np.maximum(1, gt_count + pr_count - mc)
        ass_a[a] = np.sum(mc * pair_ass) / np.maximum(1, tp[a])
    loca = np.maximum(1e-10, loca) / np.maximum(1e-10, tp)
    hota = np.sqrt(det_a * ass_a)
    return {"HOTA": float(hota.mean()), "DetA": float(det_a.mean()),
            "AssA": float(ass_a.mean()), "LocA": float(loca.mean())}


def _mask_boundary(mask: np.ndarray) -> np.ndarray:
    """Boundary pixels: mask minus its 8-connected erosion (the DAVIS
    seg2bmap approximation used by TrackEval's JAndF, reference:
    models/unitrack/eval/trackeval/metrics/j_and_f.py)."""
    from scipy import ndimage

    m = mask.astype(bool)
    er = ndimage.binary_erosion(m, structure=np.ones((3, 3), bool),
                                border_value=0)
    return m & ~er


def _boundary_f(gt_mask: np.ndarray, pred_mask: np.ndarray,
                bound_th: float = 0.008) -> float:
    """DAVIS boundary F-measure: precision/recall of boundary pixels within
    a disk tolerance of bound_th * image diagonal."""
    from scipy import ndimage

    gb = _mask_boundary(gt_mask)
    pb = _mask_boundary(pred_mask)
    n_g, n_p = int(gb.sum()), int(pb.sum())
    if n_g == 0 and n_p == 0:
        return 1.0
    if n_g == 0 or n_p == 0:
        return 0.0
    h, w = gt_mask.shape
    r = max(1, int(np.ceil(bound_th * np.hypot(h, w))))
    yy, xx = np.ogrid[-r:r + 1, -r:r + 1]
    disk = (yy * yy + xx * xx) <= r * r
    gd = ndimage.binary_dilation(gb, structure=disk)
    pd = ndimage.binary_dilation(pb, structure=disk)
    precision = float((pb & gd).sum()) / n_p
    recall = float((gb & pd).sum()) / n_g
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def evaluate_jf(gt_frames: Sequence[FrameMasks],
                pred_frames: Sequence[FrameMasks],
                bound_th: float = 0.008) -> Dict[str, float]:
    """DAVIS J&F over mask tubes, matching TrackEval JAndF semantics
    (reference: models/unitrack/eval/trackeval/metrics/j_and_f.py —
    vendored, inert; optim_type='J', its default):

    - missing detections count as all-zero masks, so every track spans every
      timestep and J/F average over ALL timesteps — a prediction that
      persists where GT is absent is penalized (j_and_f.py:49-64),
    - per-timestep IoU of two empty masks is 1 (j_and_f.py:301), and the
      boundary F of two empty masks is 1 (precision=recall=1,
      j_and_f.py:255-257),
    - prediction tracks are zero-padded up to the GT track count, then
      assigned to GT tracks by maximising MEAN per-timestep J
      (j_and_f.py:59-64,81-87).
    Returns {"J": mean J, "F": mean F, "J&F": (J+F)/2} over GT tracks.
    """
    gid_index: Dict[int, int] = {}
    pid_index: Dict[int, int] = {}
    for gt, pred in zip(gt_frames, pred_frames):
        for g in gt:
            gid_index.setdefault(g, len(gid_index))
        for p in pred:
            pid_index.setdefault(p, len(pid_index))
    n_gt, n_pr = len(gid_index), len(pid_index)
    num_t = len(gt_frames)
    if n_gt == 0 or num_t == 0:
        v = 1.0 if n_pr == 0 else 0.0
        return {"J": v, "F": v, "J&F": v}

    # Mean-over-timesteps J per (track, gt) pair without materialising the
    # (n_tr, n_gt, T) tensor (O(tracks^2 x frames) memory on long,
    # fragmented videos): per-timestep J is 1 for both-absent, 0 for
    # present-vs-absent, sim for both-present — so
    #   mean J[p, g] = (sum of both-present sims + #both-absent frames) / T.
    # Rows >= n_pr are the virtual all-empty padding tracks.
    n_tr = max(n_pr, n_gt)
    present_p = np.zeros((n_tr, num_t), bool)
    present_g = np.zeros((n_gt, num_t), bool)
    jsum = np.zeros((n_tr, n_gt))
    for t, (gt, pred) in enumerate(zip(gt_frames, pred_frames)):
        for g in gt:
            present_g[gid_index[g], t] = True
        for p in pred:
            present_p[pid_index[p], t] = True
        gids, pids, sim = _frame_similarity(gt, pred)
        for i, g in enumerate(gids):
            for k, p in enumerate(pids):
                jsum[pid_index[p], gid_index[g]] += sim[i, k]
    both_absent = ((~present_p).astype(np.float64)
                   @ (~present_g).astype(np.float64).T)
    jmean = (jsum + both_absent) / num_t

    # assignment maximises mean J over timesteps (optim_type='J')
    ri, ci = native.linear_sum_assignment(-jmean)
    inv_p = {v: k for k, v in pid_index.items()}
    inv_g = {v: k for k, v in gid_index.items()}

    js, fs = [], []
    for tr, gi in zip(ri, ci):
        js.append(float(jmean[tr, gi]))
        pid = inv_p.get(tr)          # None for virtual padding rows
        gid = inv_g[gi]
        f_vals = []
        for gt, pred in zip(gt_frames, pred_frames):
            gmask = gt.get(gid)
            pmask = pred.get(pid) if pid is not None else None
            if gmask is None and pmask is None:
                f_vals.append(1.0)
            elif gmask is None or pmask is None:
                f_vals.append(0.0)
            else:
                f_vals.append(_boundary_f(gmask.astype(bool),
                                          pmask.astype(bool), bound_th))
        fs.append(float(np.mean(f_vals)))
    j_mean, f_mean = float(np.mean(js)), float(np.mean(fs))
    return {"J": j_mean, "F": f_mean, "J&F": (j_mean + f_mean) / 2}
