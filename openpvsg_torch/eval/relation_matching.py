"""Tube matching and GT-relation translation (pipeline stage 3), the port
of ``openpvsg_tpu/eval/relation_matching.py`` (reference:
utils/relation_matching.py).

Predicted mask tubes are matched to GT object tubes by per-frame IoU > 0.5
with class agreement; matched frames are compacted into ranges, GT relation
spans are intersected with them, and the result is joined with the
query-feature tubes into the ``relations.pickle`` payload. Each frame's
(gt, pred) IoU matrix is one C++ pass (``native.pairwise_mask_iou``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from openpvsg_torch import native


def match_gt_tubes(
    gt_pan_masks: np.ndarray,                # (T, H, W) object-id maps
    gt_objects: Sequence[Dict],              # [{object_id, category(int)}]
    pred_mask_tubes: Dict[int, Dict],        # {tid: {cid, mask: [{frame: m}]}}
) -> Dict[int, Dict[int, List[int]]]:
    """-> {gt_object_id: {pred_tid: [matched frame ids]}}: IoU > 0.5 on
    frames where the classes agree (reference: match_and_process_gt_tubes,
    relation_matching.py:207-264)."""
    T, H, W = gt_pan_masks.shape
    tids = sorted(pred_mask_tubes.keys())
    tid_of = {k: tid for k, tid in enumerate(tids)}
    cls_of_tid = {tid: int(pred_mask_tubes[tid]["cid"]) for tid in tids}

    pred_frames: Dict[int, Dict[int, np.ndarray]] = {}
    for k, tid in enumerate(tids):
        for entry in pred_mask_tubes[tid]["mask"]:
            ((frame, mask),) = entry.items()
            pred_frames.setdefault(frame, {})[k] = mask

    oids = [int(o["object_id"]) for o in gt_objects]
    cls_of_oid = {int(o["object_id"]): int(o["category"]) for o in gt_objects}
    oid_index = {oid: i for i, oid in enumerate(oids)}

    matching: Dict[int, Dict[int, List[int]]] = {}
    n_gt, n_pred = len(oids), len(tids)
    if n_gt == 0 or n_pred == 0:
        return matching

    for frame in range(T):
        if frame not in pred_frames:
            continue
        gt_map = np.full((H, W), -1, dtype=np.int32)
        for oid in oids:
            gt_map[gt_pan_masks[frame] == oid] = oid_index[oid]
        pred_map = np.full((H, W), -1, dtype=np.int32)
        for k, mask in pred_frames[frame].items():
            pred_map[mask.astype(bool)] = k
        iou = native.pairwise_mask_iou(gt_map, pred_map, n_gt, n_pred)
        gi, pi = np.nonzero(iou > 0.5)
        for g, p in zip(gi.tolist(), pi.tolist()):
            oid, tid = oids[g], tid_of[p]
            if cls_of_oid[oid] != cls_of_tid[tid]:
                continue
            matching.setdefault(oid, {}).setdefault(tid, []).append(frame)
    return matching


def find_ranges(nums: Sequence[int]) -> List[str]:
    """Split a sorted frame list into 'start-end' ranges at gaps > 5
    (reference: relation_matching.py:267-278)."""
    ranges = []
    start = nums[0]
    for i in range(1, len(nums)):
        if nums[i] > nums[i - 1] + 5:
            ranges.append(f"{start}-{nums[i - 1]}")
            start = nums[i]
    ranges.append(f"{start}-{nums[-1]}")
    return ranges


def compact_matching_dict(matching: Dict[int, Dict[int, List[int]]]) -> Dict:
    """Drop matches of fewer than 5 frames; frame lists become range
    strings (reference: compact_matching_dict, relation_matching.py:280-302)."""
    out: Dict[int, Dict[int, object]] = {}
    for oid, inner in matching.items():
        processed = {}
        for tid, frames in inner.items():
            if len(frames) < 5:
                continue
            if len(inner) == 1:
                processed[tid] = f"{min(frames)}-{max(frames)}"
            else:
                processed[tid] = find_ranges(sorted(frames))
        if processed:
            out[oid] = processed
    return out


def translate_gt_relations(matching: Dict, gt_relations: Sequence) -> List:
    """Project GT relations onto the matched predicted tube ids,
    intersecting spans (reference: translate_gt_relations,
    relation_matching.py:305-369). gt_relations rows: [subj_oid, obj_oid,
    relation_idx, [[s, e], ...]]; returns rows [pred_sub_tid, pred_obj_tid,
    relation, [overlap, ...]]."""
    def overlap(r1, r2):
        return [max(r1[0], r2[0]), min(r1[1], r2[1])]

    translated = []
    for rel in gt_relations:
        t1, t2, label, time_ranges = rel[0], rel[1], rel[2], rel[3]
        if t1 not in matching or t2 not in matching:
            continue
        for time_range in time_ranges:
            for tid1, ranges1 in matching[t1].items():
                if isinstance(ranges1, str):
                    ranges1 = [ranges1]
                for r1 in ranges1:
                    s1, e1 = map(int, r1.split("-"))
                    for tid2, ranges2 in matching[t2].items():
                        if isinstance(ranges2, str):
                            ranges2 = [ranges2]
                        for r2 in ranges2:
                            s2, e2 = map(int, r2.split("-"))
                            o1 = overlap(time_range, [s1, e1 + 1])
                            o2 = overlap(time_range, [s2, e2 + 1])
                            both = overlap(o1, o2)
                            if both[0] < both[1]:
                                translated.append([tid1, tid2, label, both])
    merged: Dict[Tuple, List] = {}
    for row in translated:
        merged.setdefault(tuple(row[:-1]), []).append(row[-1])
    return [list(k) + [v] for k, v in merged.items()]


def process_feats_and_relations(
    pred_relations: Sequence, pred_feat_tubes: Dict[int, List],
    d: int = 256,
) -> Dict:
    """The relations.pickle payload (reference: process_feats_and_relations,
    relation_matching.py:452-486): binary spans clipped to the frames where
    both tubes have features, relations with a span under 3 frames dropped,
    tube features densified to (T, d) float32 arrays."""
    some_tid = next(iter(pred_feat_tubes))
    video_length = len(pred_feat_tubes[some_tid])

    relations = []
    for sub_tid, obj_tid, relation, time_span in pred_relations:
        span = np.zeros(video_length)
        for s, e in time_span:
            span[s:e] = 1
        for frame in range(video_length):
            if (pred_feat_tubes[sub_tid][frame] is None
                    or pred_feat_tubes[obj_tid][frame] is None):
                span[frame] = 0
        if span.sum() >= 3:
            relations.append({
                "subject_index": sub_tid,
                "object_index": obj_tid,
                "relation": relation,
                "relation_span": span,
            })

    feats = {}
    for tid, tube in pred_feat_tubes.items():
        arr = np.zeros((video_length, d), dtype=np.float32)
        for frame in range(video_length):
            if tube[frame] is not None:
                arr[frame] = np.asarray(tube[frame]["query_feat"]).reshape(-1)[:d]
        feats[tid] = arr
    return {"feats": feats, "relations": relations}
