"""Alternative trackers, the port of ``openpvsg_tpu/tracker/variants.py``.

Rebuild of the reference's tracker zoo beyond the main mask tracker:
- BoxAssociationTracker (reference: models/unitrack/box.py:16-51): boxes in,
  appearance features from box crops.
- EmbedAssociationTracker (reference: models/unitrack/mask_with_train_embs.py
  :19-207): associates directly on the Mask2Former 256-d query embeddings
  with cosine distance (center_emb_distance, thresh 0.7) instead of running
  a second appearance network.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from openpvsg_torch.config import TrackerConfig
from openpvsg_torch.tracker import matching
from openpvsg_torch.tracker.appearance import mask_to_box, remove_duplicated_boxes
from openpvsg_torch.tracker.kalman import tlbr_to_tlwh
from openpvsg_torch.tracker.tracker import MaskAssociationTracker
from openpvsg_torch.tracker.tracks import STrack


class EmbedAssociationTracker(MaskAssociationTracker):
    """Appearance = the segmenter's own query embeddings (no second
    network); first association on cosine distance with thresh 0.7."""

    def __init__(self, cfg: TrackerConfig, device=None):
        super().__init__(cfg, appearance_state=None, device=device)
        # reference uses thresh 0.7 for center-embedding association
        self.embed_thresh = 0.7

    def prepare_obs(self, frame, masks):
        if masks.shape[0] == 0:
            return [], np.empty(0, dtype=int)
        boxes = np.stack([mask_to_box(m) for m in masks])
        keep_idx = remove_duplicated_boxes(boxes, iou_th=0.7)
        dets = []
        for k in keep_idx:
            det = STrack(tlbr_to_tlwh(boxes[k]), 1.0, None,
                         buffer_size=self.cfg.track_buffer,
                         mask=masks[k], activated=True)
            dets.append(det)
        return dets, keep_idx

    def _post_prepare(self, detections, query_feats):
        # detections carry their query feature as curr_feat for EMA updates
        for det, q in zip(detections, query_feats):
            det.smooth_feat = None
            det.update_features(np.asarray(q["query_feat"]).reshape(-1))

    def _appearance_cost(self, tracks, detections, query_feats):
        if not tracks or not detections:
            return np.zeros((len(tracks), len(detections)))
        det_feats = np.stack([np.asarray(q["query_feat"]).reshape(-1)
                              for q in query_feats])
        track_feats = np.stack([np.asarray(t.smooth_feat).reshape(-1)
                                for t in tracks])
        dists = matching.cosine_distance(track_feats, det_feats)
        for i, track in enumerate(tracks):
            for j in range(len(detections)):
                if track.cls_id != query_feats[j]["cls_id"] % 1000:
                    dists[i, j] = np.inf
        return dists


class BoxAssociationTracker(MaskAssociationTracker):
    """Box-based tracker (IoU + appearance of box regions); PVSG itself is
    mask-based — provided for the capability surface."""

    def prepare_boxes(self, frame: np.ndarray, boxes: np.ndarray):
        """boxes: (N, 4) tlbr -> detections with box-cropped masks."""
        return self.prepare_obs(frame, _box_masks(frame, boxes))

    def update_boxes(self, frame: np.ndarray, boxes: np.ndarray,
                     query_feats: Sequence[Dict], prev_tubes: int = 0):
        return self.update(frame, _box_masks(frame, boxes), query_feats,
                           prev_tubes)


def _box_masks(frame: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N, H, W) uint8 masks filling each tlbr box, clipped at the top-left
    border as the reference's slices are."""
    h, w = frame.shape[:2]
    masks = np.zeros((len(boxes), h, w), np.uint8)
    for i, (x1, y1, x2, y2) in enumerate(boxes.astype(int)):
        masks[i, max(y1, 0):y2 + 1, max(x1, 0):x2 + 1] = 1
    return masks
