"""Query-feature tubes: one 256-d feature (or None) per frame per track.

``QueryFeatTube`` (IPS, filled by the tracker) and ``SimpleTube`` (VPS)
keep the attribute names of ``openpvsg_tpu.tracker.tubes`` (``track_id``,
``qf_tube``, ``start_frame_id``) so ``query_feats.pickle`` holds the same
content in both packages; the pickled class path differs.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class QueryFeatTube:
    """A tracked object's query features (reference:
    models/unitrack/data/query_feat_tracklet.py:1-38); gaps are None."""

    def __init__(self, start_frame_id: int, track_id: int, query_feat: Dict):
        """query_feat: {'query_feat': (D,), 'cls_id': int} (reference keys)."""
        self.start_frame_id = start_frame_id
        self.track_id = track_id
        self.qf_tube: List[Optional[Dict]] = [None] * (start_frame_id - 1)
        self.qf_tube.append(query_feat)

    def update(self, query_feat: Optional[Dict], frame_id: int):
        """Record this frame's feature; None-pad skipped frames (reference:
        query_feat_tracklet.py:24-30)."""
        gap = frame_id - 1 - len(self.qf_tube)
        self.qf_tube.extend([None] * max(gap, 0))
        if len(self.qf_tube) == frame_id - 1:
            self.qf_tube.append(query_feat)
        else:  # already has an entry for this frame: overwrite
            self.qf_tube[frame_id - 1] = query_feat

    def complete_empty_postfix(self, total_frames: int):
        self.qf_tube.extend([None] * (total_frames - len(self.qf_tube)))

    def __len__(self):
        return len(self.qf_tube)

    def as_array(self, total_frames: int, dim: int = 256):
        """-> (feats (T, D) float32 with zeros at gaps, valid (T,) bool)."""
        feats = np.zeros((total_frames, dim), dtype=np.float32)
        valid = np.zeros(total_frames, dtype=bool)
        for t, item in enumerate(self.qf_tube[:total_frames]):
            if item is not None:
                feats[t] = np.asarray(item["query_feat"]).reshape(-1)[:dim]
                valid[t] = True
        return feats, valid


class SimpleTube:
    """Identity comes from the stitched query's segment id, so no tracker is
    needed (reference: mask2former_vps/utils.py concat_seq)."""

    def __init__(self, track_id: int):
        self.track_id = track_id
        self.qf_tube: List[Optional[Dict]] = []

    def append(self, query_feat: Optional[Dict]):
        self.qf_tube.append(query_feat)

    as_array = QueryFeatTube.as_array
    __len__ = QueryFeatTube.__len__
