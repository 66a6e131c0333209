"""Stage runners of the file-mediated cascade, ports of
``openpvsg_tpu/infer/stages.py``:

  stage 2 IPS: ``run_query_tube_ips`` — per-frame IPS inference over one
               video and UniTrack-style association (``MaskAssociationTracker``)
               -> the same two files (reference:
               tools/prepare_query_tube_ips.py +
               models/unitrack/test_mots_from_mask2former.py eval_seq)
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
from openpvsg_torch.tracker.tracker import MaskAssociationTracker
from openpvsg_torch.tracker.tubes import SimpleTube
from openpvsg_torch.utils.profiling import RECORDER, Timer, count, span


def _frame(f: Union[str, np.ndarray]) -> np.ndarray:
    return f if isinstance(f, np.ndarray) else load_frame(f)


def _segments_to_masks(pan: np.ndarray, query_feats: Dict[int, np.ndarray]):
    """Split an mmdet-format pan map into per-object binary masks aligned
    with query features (reference: unitrack/data/single_video.py:10-103)."""
    masks, feats = [], []
    for seg_id, feat in query_feats.items():
        mask = (pan == seg_id).astype(np.uint8)
        if mask.sum() == 0:
            continue
        masks.append(mask)
        feats.append({"query_feat": np.asarray(feat), "cls_id": seg_id % INSTANCE_OFFSET})
    if not masks:
        return np.zeros((0, *pan.shape), np.uint8), []
    return np.stack(masks), feats


def save_tracking_overlay(save_root: str, frame_id: int, img: np.ndarray,
                          masks: Sequence[np.ndarray],
                          track_ids: Sequence[int]) -> None:
    """Per-frame qualitative overlay PNG (reference:
    models/unitrack/test_mots_from_mask2former.py:72-78 and
    mask2former_vps/utils.py:55-69; the 'qualititive/' spelling is kept for
    output-tree compatibility): each track's mask blended in its stable
    palette color, annotated with the track id."""
    from PIL import Image, ImageDraw

    from openpvsg_torch.utils.palette import color_for

    out = img.astype(np.float32)
    for mask, tid in zip(masks, track_ids):
        m = mask.astype(bool)
        out[m] = 0.5 * out[m] + 0.5 * np.asarray(color_for(int(tid)),
                                                 np.float32)
    im = Image.fromarray(out.astype(np.uint8))
    draw = ImageDraw.Draw(im)
    for mask, tid in zip(masks, track_ids):
        ys, xs = np.nonzero(mask)
        if len(ys):
            draw.text((int(xs.min()), int(ys.min())), str(int(tid)),
                      fill=(255, 255, 255))
    d = os.path.join(save_root, "qualititive")
    os.makedirs(d, exist_ok=True)
    im.save(os.path.join(d, f"{frame_id:06d}.png"))


def run_query_tube_ips(
    segmenter: SegmenterInference,
    tracker: MaskAssociationTracker,
    frames: Sequence[Union[str, np.ndarray]],
    save_root: str,
    batch_size: int = 8,
    log_fn=None,
    save_images: bool = False,
    pipeline_depth: int = 2,
) -> int:
    """IPS stage 2 for one video; returns the number of tubes. Logs the
    running fps every 20 frames through ``log_fn`` (the reference's only
    throughput surface, test_mots_from_mask2former.py:44-49).

    frames: image paths or decoded (H, W, 3) uint8 RGB frames.
    pipeline_depth: frame batches enqueued on the device before the oldest
    is fetched, packaged and tracked, so batch N+1's upload and forward run
    while the host tracks batch N; 1 is the serial loop. Results are the
    same at any depth: the tracker consumes the frames in order."""
    num_frames = len(frames)
    results = []
    frame_id = 0

    def dispatch(lo: int):
        raw = [_frame(f) for f in frames[lo:lo + batch_size]]
        # raw uint8 batch: normalization and padding run in the forward
        return raw, segmenter.infer_frames_ips_async(np.stack(raw))

    timer = Timer()
    offsets = list(range(0, num_frames, batch_size))
    pending: deque = deque()
    next_i = 0
    while next_i < len(offsets) or pending:
        while next_i < len(offsets) and len(pending) < max(pipeline_depth, 1):
            pending.append(dispatch(offsets[next_i]))
            next_i += 1
        # timed after the refill: fps is frames consumed per interval
        timer.tic()
        raw, handle = pending.popleft()
        for img, out in zip(raw, segmenter.package_ips(handle)):
            frame_id += 1
            masks, qfeats = _segments_to_masks(out["pan_results"], out["query_feats"])
            online, _ = tracker.update(img, masks, qfeats)
            rles, tids, vis_masks = [], [], []
            for t in online:
                if t.mask is None:
                    continue
                rle = rle_codec.encode(t.mask)
                rle["class_id"] = t.cls_id
                rles.append(rle)
                tids.append(t.track_id)
                vis_masks.append(t.mask)
            results.append((frame_id, rles, tids))
            if save_images:
                save_tracking_overlay(save_root, frame_id, img, vis_masks, tids)
        timer.toc()
        if log_fn and frame_id % 20 < batch_size:
            fps = len(raw) / max(timer.diff, 1e-5)
            log_fn(f"frame {frame_id}/{num_frames} ({fps:.2f} fps)")

    tubes = tracker.finalize(num_frames)
    data_io.write_masks_txt(
        os.path.join(save_root, "quantitive", "masks.txt"), results)
    data_io.save_pickle(os.path.join(save_root, "query_feats.pickle"), tubes)
    return len(tubes)


def run_query_tube_vps(
    segmenter: SegmenterInference,
    frames: Sequence[Union[str, np.ndarray]],
    save_root: str,
    window: int = 2,
    chain_windows: bool = False,
    pipeline_depth: int = 2,
    save_images: bool = False,
    windows_per_batch: Optional[int] = None,
) -> int:
    """VPS stage 2 for one video; returns the number of tubes.

    frames: image paths (decoded with ``load_frame``) or (H, W, 3) uint8
    arrays, which are taken as already decoded RGB frames.

    chain_windows carries the last frame's aligned query embeddings across
    windows (off by default, as in the reference). save_images writes the
    ``qualititive/`` overlays. ``windows_per_batch`` windows run as one
    forward (by default one per replica of the segmenter's mesh, 1 without
    one, as ``openpvsg_tpu/infer/stages.py:182-196``: each replica then
    takes one window); pipeline_depth such batches are enqueued on the
    device before the oldest is fetched and stitched. Each frame's forward
    and fusion are its own and the MinVIS stitch runs per window on the
    host, so results are identical at any batch and depth, chained or not
    (``openpvsg_tpu/infer/stages.py:171-207``).

    Under ``torch.profiler`` the call records its spans and counters in
    ``utils/profiling.RECORDER`` as one request, each batch by its index."""
    total_frames = len(frames)
    results = []
    object_list: List[int] = []
    feat_tubes: Dict[int, Dict[int, Dict]] = {}

    if windows_per_batch is None:
        windows_per_batch = (segmenter.mesh.shape["data"]
                             if segmenter.mesh is not None else 1)
    per_batch = window * windows_per_batch

    def dispatch(b: int):
        RECORDER.batch = b
        with span("stages.stack"):
            raw = np.stack([_frame(f) for f in frames[offsets[b]:offsets[b] + per_batch]])
        return b, raw, segmenter.infer_windows_vps_async(raw)

    RECORDER.begin_request()
    offsets = list(range(0, total_frames, per_batch))
    pending: deque = deque()
    next_i = 0
    frame_id = 0
    prev_embds = None
    while next_i < len(offsets) or pending:
        while next_i < len(offsets) and len(pending) < max(pipeline_depth, 1):
            pending.append(dispatch(next_i))
            next_i += 1
        RECORDER.batch, raw, handle = pending.popleft()
        outputs = segmenter.finish_windows_vps(
            handle, window, prev_embds=prev_embds,
            chain_windows=chain_windows, return_embds=chain_windows)
        if chain_windows:
            outputs, prev_embds = outputs
        with span("stages.tubes"):
            count("batches")
            count("frames", len(raw))
            for img, out in zip(raw, outputs):
                rles, tids, vis_masks = [], [], []
                for seg_id, feat in out["query_feats"].items():
                    if seg_id not in object_list:
                        object_list.append(seg_id)
                        feat_tubes[object_list.index(seg_id) + 1] = {}
                    tid = object_list.index(seg_id) + 1
                    feat_tubes[tid][frame_id] = {
                        "query_feat": np.asarray(feat, np.float32),
                        "cls_id": int(seg_id % INSTANCE_OFFSET),
                    }
                    mask = (out["pan_results"] == seg_id).astype(np.uint8)
                    rle = rle_codec.encode(mask)
                    rle["class_id"] = seg_id % INSTANCE_OFFSET
                    rles.append(rle)
                    tids.append(tid)
                    vis_masks.append(mask)
                results.append((frame_id + 1, rles, tids))
                count("segments", len(rles))
                if save_images:
                    save_tracking_overlay(save_root, frame_id + 1, img, vis_masks,
                                          tids)
                frame_id += 1

    RECORDER.batch = -1
    with span("stages.write_masks"):
        data_io.write_masks_txt(
            os.path.join(save_root, "quantitive", "masks.txt"), results)
    with span("stages.write_tubes"):
        tubes = []
        for tid, per_frame in feat_tubes.items():
            tube = SimpleTube(tid)
            for i in range(total_frames):
                tube.append(per_frame.get(i))
            tubes.append(tube)
        data_io.save_pickle(os.path.join(save_root, "query_feats.pickle"), tubes)
    RECORDER.end_request()
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
