"""Track state machine (host-side, inherently sequential): the port's copy
of ``openpvsg_tpu/tracker/tracks.py``. Appearance features are opaque here:
numpy arrays or torch tensors (the mask tracker's stay on its device).

Rebuild of the reference BaseTrack/STrack (reference:
models/unitrack/basetrack.py:10-263): Kalman-backed box state, EMA-smoothed
appearance features (α = 0.9), New/Tracked/Lost/Removed lifecycle, global
per-video id counter.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from openpvsg_torch.tracker.kalman import KalmanFilter, tlwh_to_xyah


class TrackState:
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


class IdCounter:
    """Per-video id source (reference: BaseTrack._count + reset_count)."""

    def __init__(self):
        self.count = 0

    def next_id(self) -> int:
        self.count += 1
        return self.count

    def reset(self):
        self.count = 0


class STrack:
    shared_kalman = KalmanFilter()

    def __init__(self, tlwh, score, temp_feat, buffer_size: int = 30,
                 mask=None, activated: bool = False, category: int = -1,
                 use_kalman: bool = True):
        self._tlwh = np.asarray(tlwh, dtype=np.float64)
        self.kalman_filter: Optional[KalmanFilter] = None
        self.mean = None
        self.covariance = None
        self.use_kalman = use_kalman
        self.is_activated = activated or not use_kalman

        self.score = score
        self.category = category
        self.cls_id = -1
        self.tracklet_len = 0
        self.track_id = 0
        self.state = TrackState.New
        self.start_frame = 0
        self.frame_id = 0

        self.alpha = 0.9
        self.smooth_feat = None
        self.curr_feat = None
        self.update_features(temp_feat)
        self.mask = mask

    @property
    def end_frame(self) -> int:
        return self.frame_id

    def update_features(self, feat):
        self.curr_feat = feat
        if self.smooth_feat is None:
            self.smooth_feat = feat
        elif np.shape(self.smooth_feat) == np.shape(feat):
            self.smooth_feat = self.alpha * self.smooth_feat + (1 - self.alpha) * feat
        # shape mismatch (variable pixel sets): keep previous smooth feat

    @staticmethod
    def multi_predict(stracks: List["STrack"]):
        """One batched KF predict over all tracks (reference loops per
        track; here it is a single vectorized call)."""
        if not stracks:
            return
        means = np.stack([st.mean.copy() for st in stracks])
        covs = np.stack([st.covariance for st in stracks])
        for i, st in enumerate(stracks):
            if st.state != TrackState.Tracked:
                means[i][7] = 0
        means, covs = STrack.shared_kalman.multi_predict(means, covs)
        for st, m, c in zip(stracks, means, covs):
            st.mean = m
            st.covariance = c

    def activate(self, kalman_filter: KalmanFilter, frame_id: int,
                 ids: IdCounter):
        self.kalman_filter = kalman_filter
        self.track_id = ids.next_id()
        self.mean, self.covariance = kalman_filter.initiate(tlwh_to_xyah(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        if frame_id == 1:
            self.is_activated = True
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track: "STrack", frame_id: int,
                    new_id: bool = False, ids: Optional[IdCounter] = None,
                    update_feature: bool = True):
        if self.use_kalman:
            self.mean, self.covariance = self.kalman_filter.update(
                self.mean, self.covariance, tlwh_to_xyah(new_track.tlwh))
        else:
            self._tlwh = np.asarray(new_track.tlwh, dtype=np.float64)
        if update_feature:
            self.update_features(new_track.curr_feat)
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id and ids is not None:
            self.track_id = ids.next_id()
        if new_track.mask is not None:
            self.mask = new_track.mask

    def update(self, new_track: "STrack", frame_id: int,
               update_feature: bool = True):
        self.frame_id = frame_id
        self.tracklet_len += 1
        if self.use_kalman:
            self.mean, self.covariance = self.kalman_filter.update(
                self.mean, self.covariance, tlwh_to_xyah(new_track.tlwh))
        else:
            self._tlwh = np.asarray(new_track.tlwh, dtype=np.float64)
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.category = new_track.category
        if update_feature:
            self.update_features(new_track.curr_feat)
        if new_track.mask is not None:
            self.mask = new_track.mask

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed

    @property
    def tlwh(self) -> np.ndarray:
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()
        ret[2] *= ret[3]
        ret[:2] -= ret[2:] / 2
        return ret

    @property
    def tlbr(self) -> np.ndarray:
        ret = self.tlwh
        ret[2:] += ret[:2]
        return ret

    def to_xyah(self) -> np.ndarray:
        return tlwh_to_xyah(self.tlwh)

    def __repr__(self):
        return f"OT_{self.track_id}_({self.start_frame}-{self.end_frame})"


def joint_stracks(a: List[STrack], b: List[STrack]) -> List[STrack]:
    seen = {t.track_id for t in a}
    return list(a) + [t for t in b if t.track_id not in seen]


def sub_stracks(a: List[STrack], b: List[STrack]) -> List[STrack]:
    drop = {t.track_id for t in b}
    return [t for t in a if t.track_id not in drop]


def remove_duplicate_stracks(a: List[STrack], b: List[STrack],
                             ioudist: float = 0.15):
    from openpvsg_torch.tracker.matching import iou_distance

    if not a or not b:
        return a, b
    pdist = iou_distance(np.stack([t.tlbr for t in a]),
                         np.stack([t.tlbr for t in b]))
    pairs = np.where(pdist < ioudist)
    dupa, dupb = set(), set()
    for p, q in zip(*pairs):
        timep = a[p].frame_id - a[p].start_frame
        timeq = b[q].frame_id - b[q].start_frame
        if timep > timeq:
            dupb.add(q)
        else:
            dupa.add(p)
    return ([t for i, t in enumerate(a) if i not in dupa],
            [t for i, t in enumerate(b) if i not in dupb])
