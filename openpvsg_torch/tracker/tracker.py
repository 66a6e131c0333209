"""Mask-tube association tracker (ByteTrack-style host orchestration with the
appearance encoder and the reconsdot cost on the device), the port of
``openpvsg_tpu/tracker/tracker.py``.

Rebuild of the reference AssociationTracker / MaskAssociationTracker
(reference: models/unitrack/multitracker.py:36-205, mask.py:16-59): per frame

  1. prepare detections: per-object appearance pixel-feature sets (device),
     mask->box, duplicate-box removal (IoU > 0.7)
  2. first association on appearance (reconsdot cost, class-gated to inf on
     class mismatch), optional Kalman motion fusion, LAPJV thresh 0.9
  3. second association on IoU (thresh 0.5) for remaining Tracked tracks
  4. unconfirmed-track handling (confirm IoU 0.7)
  5. new-track init (score >= conf_thres), lost/removed bookkeeping
     (track_buffer 300), duplicate suppression (IoU dist < 0.15)

QueryFeatTube bookkeeping records the Mask2Former query feature of every
matched detection per frame (reference: multitracker.py:101-172). A
detection's appearance set stays on the tracker's device: all
``max_pixels`` rows of the extractor's output, its zero padding included,
as the JAX tracker passes them (``tracker.py:73``).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from openpvsg_torch.config import TrackerConfig
from openpvsg_torch.tracker import matching
from openpvsg_torch.tracker.appearance import (
    extract_object_embeddings, make_appearance_model, mask_to_box,
    remove_duplicated_boxes, resolve_appearance_spec)
from openpvsg_torch.tracker.kalman import KalmanFilter, tlbr_to_tlwh
from openpvsg_torch.tracker.tracks import (
    IdCounter, STrack, TrackState, joint_stracks, remove_duplicate_stracks,
    sub_stracks)
from openpvsg_torch.tracker.tubes import QueryFeatTube


class MaskAssociationTracker:
    """``appearance_state``: the port's float32 state dict of the appearance
    encoder that ``resolve_appearance_spec(cfg)`` names
    (``weights.appearance_from_jax_params``,
    ``weights.random_appearance_state_dict``), or None for a tracker that
    needs no encoder. ``device=None`` means the GPU and raises when there is
    none; pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, cfg: TrackerConfig,
                 appearance_state: Optional[Mapping[str, torch.Tensor]] = None,
                 device=None):
        from openpvsg_torch.infer.segmenter import resolve_device

        self.cfg = cfg
        self.device = resolve_device(device)
        self.ids = IdCounter()
        self.tracked_stracks: List[STrack] = []
        self.lost_stracks: List[STrack] = []
        self.removed_stracks: List[STrack] = []
        self.query_feat_tubes: List[QueryFeatTube] = []
        self.frame_id = 0
        self.det_thresh = cfg.conf_thres
        self.max_time_lost = cfg.track_buffer
        self.kalman_filter = KalmanFilter()
        self.appearance_model = None
        if appearance_state is not None:
            depth, model_type, remove_layers = resolve_appearance_spec(cfg)
            model = make_appearance_model(depth=depth, model_type=model_type,
                                          remove_layers=remove_layers)
            model.load_state_dict(appearance_state, strict=True)
            self.appearance_model = model.to(self.device).eval()
        self.motion_lambda = cfg.motion_lambda if cfg.asso_with_motion else 1.0
        self.motion_gated = cfg.motion_gated if cfg.asso_with_motion else False

    # ------------------------------------------------------------------
    def prepare_obs(self, frame: np.ndarray, masks: np.ndarray):
        """frame: (H, W, 3); masks: (N, H, W) binary. Returns (detections,
        keep_idx into the original mask order)."""
        if masks.shape[0] == 0:
            return [], np.empty(0, dtype=int)
        if self.appearance_model is None:
            raise ValueError("MaskAssociationTracker needs appearance_state "
                             "to extract appearance features")
        feats, valid = extract_object_embeddings(
            self.appearance_model, frame, masks,
            max_mask_area=self.cfg.max_mask_area)
        boxes = np.stack([mask_to_box(m) for m in masks])
        keep_idx = remove_duplicated_boxes(boxes, iou_th=0.7)
        n_valid = valid.sum(1).tolist()
        detections = []
        for k in keep_idx:
            # pixel-feature set (D, P) with padding already zeroed
            det = STrack(tlbr_to_tlwh(boxes[k]), 1.0, feats[k].T,
                         buffer_size=self.cfg.track_buffer,
                         mask=masks[k], activated=True)
            det._n_valid = n_valid[k]
            detections.append(det)
        return detections, keep_idx

    # ------------------------------------------------------------------
    def _post_prepare(self, detections, query_feats):
        """Hook for variants to attach per-detection data after duplicate
        filtering aligns detections with query_feats."""

    def _appearance_cost(self, tracks: Sequence[STrack],
                         detections: Sequence[STrack],
                         query_feats: Sequence[Dict]) -> np.ndarray:
        if not tracks or not detections:
            return np.zeros((len(tracks), len(detections)))
        dists = np.array(matching.reconsdot_distance(
            [t.curr_feat for t in tracks], [d.curr_feat for d in detections],
            device=self.device))
        # class gate (reference: multitracker.py:27-34 class_aware_distance)
        for i, track in enumerate(tracks):
            for j in range(len(detections)):
                if track.cls_id != query_feats[j]["cls_id"] % 1000:
                    dists[i, j] = np.inf
        return dists

    def _tube_update(self, track: STrack, query_feat: Dict, offset: int):
        self.query_feat_tubes[track.track_id - 1 - offset].update(
            query_feat, self.frame_id)

    # ------------------------------------------------------------------
    def update(self, frame: np.ndarray, masks: np.ndarray,
               query_feats: Sequence[Dict],
               total_num_tubes_previous: int = 0):
        """One tracking step. query_feats[i] = {'query_feat': (256,),
        'cls_id': int} aligned with masks[i]."""
        cfg = self.cfg
        self.frame_id += 1
        activated, refind, lost, removed = [], [], [], []

        detections, keep_idx = self.prepare_obs(frame, masks)
        query_feats = [query_feats[k] for k in keep_idx]
        self._post_prepare(detections, query_feats)

        unconfirmed = [t for t in self.tracked_stracks if not t.is_activated]
        tracked = [t for t in self.tracked_stracks if t.is_activated]

        # --- step 2: first association on appearance
        tracks = joint_stracks(tracked, self.lost_stracks)
        dists = self._appearance_cost(tracks, detections, query_feats)
        if cfg.use_kalman:
            STrack.multi_predict(tracks)
            dists = matching.fuse_motion(
                self.kalman_filter, dists, tracks, detections,
                lambda_=self.motion_lambda, gate=self.motion_gated)
        matches, u_track, u_detection = matching.linear_assignment(
            dists, thresh=cfg.first_assoc_thresh)

        for itracked, idet in matches:
            track, det = tracks[itracked], detections[idet]
            self._tube_update(track, query_feats[idet], total_num_tubes_previous)
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id)
                refind.append(track)

        if cfg.use_kalman:
            # --- step 3: second association on IoU
            tracks = [tracks[i] for i in u_track
                      if tracks[i].state == TrackState.Tracked]
            detections = [detections[i] for i in u_detection]
            query_feats = [query_feats[i] for i in u_detection]
            dists = matching.iou_distance(
                np.stack([t.tlbr for t in tracks]) if tracks else np.zeros((0, 4)),
                np.stack([d.tlbr for d in detections]) if detections else np.zeros((0, 4)))
            matches, u_track, u_detection = matching.linear_assignment(
                dists, thresh=cfg.second_assoc_iou_thresh)
            for itracked, idet in matches:
                track, det = tracks[itracked], detections[idet]
                self._tube_update(track, query_feats[idet], total_num_tubes_previous)
                if track.state == TrackState.Tracked:
                    track.update(det, self.frame_id)
                    activated.append(track)
                else:
                    track.re_activate(det, self.frame_id)
                    refind.append(track)

            # --- unconfirmed tracks
            detections = [detections[i] for i in u_detection]
            query_feats = [query_feats[i] for i in u_detection]
            dists = matching.iou_distance(
                np.stack([t.tlbr for t in unconfirmed]) if unconfirmed else np.zeros((0, 4)),
                np.stack([d.tlbr for d in detections]) if detections else np.zeros((0, 4)))
            matches, u_unconfirmed, u_detection = matching.linear_assignment(
                dists, thresh=cfg.confirm_iou_thres)
            for itracked, idet in matches:
                unconfirmed[itracked].update(detections[idet], self.frame_id)
                activated.append(unconfirmed[itracked])
                self._tube_update(unconfirmed[itracked], query_feats[idet],
                                  total_num_tubes_previous)
            for it in u_unconfirmed:
                track = unconfirmed[it]
                track.mark_removed()
                removed.append(track)

        for it in u_track:
            track = tracks[it]
            if track.state != TrackState.Lost:
                track.mark_lost()
                lost.append(track)

        # --- step 4: init new tracks
        for inew in u_detection:
            track = detections[inew]
            if track.score < self.det_thresh:
                continue
            track.activate(self.kalman_filter, self.frame_id, self.ids)
            self.query_feat_tubes.append(
                QueryFeatTube(self.frame_id, track.track_id, query_feats[inew]))
            track.cls_id = query_feats[inew]["cls_id"] % 1000
            activated.append(track)

        # --- step 5: state update
        for track in self.lost_stracks:
            if self.frame_id - track.end_frame > self.max_time_lost:
                track.mark_removed()
                removed.append(track)

        self.tracked_stracks = [t for t in self.tracked_stracks
                                if t.state == TrackState.Tracked]
        self.tracked_stracks = joint_stracks(self.tracked_stracks, activated)
        self.tracked_stracks = joint_stracks(self.tracked_stracks, refind)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.tracked_stracks)
        self.lost_stracks.extend(lost)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.removed_stracks)
        self.removed_stracks.extend(removed)
        self.tracked_stracks, self.lost_stracks = remove_duplicate_stracks(
            self.tracked_stracks, self.lost_stracks, ioudist=cfg.dup_iou_thres)

        self.query_feat_tubes.sort(key=lambda t: t.track_id)
        outputs = [t for t in self.tracked_stracks if t.is_activated]
        return outputs, len(self.query_feat_tubes)

    def finalize(self, total_frames: int):
        for tube in self.query_feat_tubes:
            tube.complete_empty_postfix(total_frames)
        return self.query_feat_tubes
