"""Stage runners of the file-mediated cascade, ports of
``openpvsg_tpu/infer/stages.py``:

  stage 2 VPS: ``run_query_tube_vps`` — windowed MinVIS inference over one
               video, tube identity from panoptic segment ids ->
               ``{save_root}/quantitive/masks.txt`` and
               ``{save_root}/query_feats.pickle`` (reference:
               tools/prepare_query_tube_vps.py + concat_seq)
  stage 3:     ``run_rel_set`` — predicted-tube / GT matching ->
               ``{work_dir}/{vid}/relations.pickle`` (reference:
               tools/prepare_rel_set.py)
"""
from __future__ import annotations

import os
from collections import deque
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from openpvsg_torch import INSTANCE_OFFSET
from openpvsg_torch.data import io as data_io
from openpvsg_torch.data import rle as rle_codec
from openpvsg_torch.data.pipeline import load_frame, load_mask
from openpvsg_torch.data.pvsg import PVSGRelationAnnotation, frame_paths
from openpvsg_torch.eval.relation_matching import (
    compact_matching_dict, match_gt_tubes, process_feats_and_relations,
    translate_gt_relations)
from openpvsg_torch.infer.segmenter import SegmenterInference
from openpvsg_torch.tracker.tubes import SimpleTube


def _frame(f: Union[str, np.ndarray]) -> np.ndarray:
    return f if isinstance(f, np.ndarray) else load_frame(f)


def run_query_tube_vps(
    segmenter: SegmenterInference,
    frames: Sequence[Union[str, np.ndarray]],
    save_root: str,
    window: int = 2,
    chain_windows: bool = False,
    pipeline_depth: int = 2,
) -> int:
    """VPS stage 2 for one video; returns the number of tubes.

    frames: image paths (decoded with ``load_frame``) or (H, W, 3) uint8
    arrays, which are taken as already decoded RGB frames.

    chain_windows carries the last frame's aligned query embeddings across
    windows (off by default, as in the reference). Each window runs as one
    forward; pipeline_depth windows are enqueued on the device before the
    oldest is fetched and stitched. Results are identical at any depth."""
    total_frames = len(frames)
    results = []
    object_list: List[int] = []
    feat_tubes: Dict[int, Dict[int, Dict]] = {}

    def dispatch(lo: int):
        raw = np.stack([_frame(f) for f in frames[lo:lo + window]])
        return segmenter.infer_windows_vps_async(raw)

    offsets = list(range(0, total_frames, window))
    pending: deque = deque()
    next_i = 0
    frame_id = 0
    prev_embds = None
    while next_i < len(offsets) or pending:
        while next_i < len(offsets) and len(pending) < max(pipeline_depth, 1):
            pending.append(dispatch(offsets[next_i]))
            next_i += 1
        outputs, prev_embds = segmenter.finish_windows_vps(
            pending.popleft(), window, prev_embds=prev_embds,
            chain_windows=chain_windows, return_embds=True)
        if not chain_windows:
            prev_embds = None
        for out in outputs:
            rles, tids = [], []
            for seg_id, feat in out["query_feats"].items():
                if seg_id not in object_list:
                    object_list.append(seg_id)
                    feat_tubes[object_list.index(seg_id) + 1] = {}
                tid = object_list.index(seg_id) + 1
                feat_tubes[tid][frame_id] = {
                    "query_feat": np.asarray(feat, np.float32),
                    "cls_id": int(seg_id % INSTANCE_OFFSET),
                }
                rle = rle_codec.encode(
                    (out["pan_results"] == seg_id).astype(np.uint8))
                rle["class_id"] = seg_id % INSTANCE_OFFSET
                rles.append(rle)
                tids.append(tid)
            results.append((frame_id + 1, rles, tids))
            frame_id += 1

    data_io.write_masks_txt(
        os.path.join(save_root, "quantitive", "masks.txt"), results)
    tubes = []
    for tid, per_frame in feat_tubes.items():
        tube = SimpleTube(tid)
        for i in range(total_frames):
            tube.append(per_frame.get(i))
        tubes.append(tube)
    data_io.save_pickle(os.path.join(save_root, "query_feats.pickle"), tubes)
    return len(tubes)


def run_rel_set(
    vid: str,
    work_dir: str,
    anno: PVSGRelationAnnotation,
    data_dir: str,
) -> Optional[str]:
    """Stage 3 for one video: masks.txt + query_feats.pickle + the GT mask
    PNGs under ``data_dir`` -> relations.pickle; returns its path, or None
    when the video has no predicted tube (reference:
    tools/prepare_rel_set.py:23-50)."""
    save_path = os.path.join(work_dir, vid, "relations.pickle")
    pred_tubes = data_io.get_pred_mask_tubes(
        os.path.join(work_dir, vid, "quantitive", "masks.txt"))
    if not pred_tubes:
        return None

    gt_pan = np.stack([load_mask(p) for p in frame_paths(data_dir, vid, "masks")])
    info = anno[vid]

    matching = match_gt_tubes(gt_pan, info["objects"], pred_tubes)
    matching = compact_matching_dict(matching)
    translated = translate_gt_relations(matching, info["relations"])

    qf_tubes = data_io.load_pickle(
        os.path.join(work_dir, vid, "query_feats.pickle"))
    pred_feat_tubes = {t.track_id: t.qf_tube for t in qf_tubes}
    if not pred_feat_tubes:
        return None
    payload = process_feats_and_relations(translated, pred_feat_tubes)
    data_io.save_pickle(save_path, payload)
    return save_path
