"""Online (streaming) PVSG inference, the port of
``openpvsg_tpu/infer/streaming.py``.

The offline cascade reads each stage's files for a whole video. For serving,
``StreamingPVSG`` processes a live frame stream incrementally:

  push frames -> windowed segmenter forward (``infer_window_vps``: MinVIS
  stitching inside the window, segment-id tube identity across windows, as
  stage 2 VPS) -> rolling query-feature tubes -> every
  ``relation_interval`` frames, the relation head re-scores the retained
  tubes and emits the current top-K triplets.

State is O(num_tubes x max_history) feature memory with a rolling history
bound (O(frames_seen) without one); masks are returned per window, never
kept.

Two relation-history backends:

- ``device_history=True`` (default): ``_DeviceRing``, a (slots, capacity,
  D) float32 tensor on the segmenter's device. Each window ships only its
  (slots, window, D) update block; scoring keeps the encoder outputs on the
  device, fetches the (slots, slots) pair matrix, sends the chosen pair
  indices back, and gathers, concatenates and predicts on the device.
- ``device_history=False``: features in host dicts, rebuilt densely and
  scored through ``eval.rel_eval.evaluate_video`` every interval (the
  oracle of the ring).

The relation model runs in IEEE float32 (TF32 off) on either backend.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from openpvsg_torch import INSTANCE_OFFSET
from openpvsg_torch.eval.rel_eval import evaluate_video
from openpvsg_torch.infer.segmenter import SegmenterInference
from openpvsg_torch.models.relation.heads import RelationModel
from openpvsg_torch.models.relation.utils import (generate_results,
                                                  pick_top_pairs_eval)
from openpvsg_torch.train.segmenter import ieee_float32

# slot-capacity growth schedule (as eval.rel_eval.TUBE_BUCKETS)
SLOT_BUCKETS = (20, 50, 100, 200)


class StreamingPVSG:
    """Incremental video scene-graph engine.

    >>> engine = StreamingPVSG(segmenter, rel_model)
    >>> for frame in video:                       # uint8 RGB (H, W, 3)
    ...     out = engine.push(frame)              # None until a window fills
    ...     if out and out["triplets"] is not None: ...
    >>> final = engine.finish()

    ``rel_model`` is a ``RelationModel`` holding its weights (or None: the
    engine then segments only); it is moved to the segmenter's device, the
    engine's device. ``max_history`` keeps only the last K frames of tube
    features, so state is O(num_tubes x K) and each scoring costs O(K)
    however long the stream runs. Spans in emitted triplets are clipped to
    the retained frames and reported in absolute frame ids; a tube with no
    detection inside them is dropped from scoring (``finish()``'s tube
    summary keeps it). None keeps every frame, as the offline cascade.

    ``last_scores`` holds, after each scoring of the device backend, the
    probabilities of every ranked (pair, relation) in emitted order (the
    emitted triplets are its first ``num_top_pairs``); None on the host
    backend.
    """

    def __init__(self, segmenter: SegmenterInference,
                 rel_model: Optional[RelationModel] = None,
                 window: int = 2,
                 relation_interval: int = 16,
                 num_top_pairs: int = 20,
                 feat_dim: int = 256,
                 max_history: Optional[int] = None,
                 device_history: bool = True):
        if max_history is not None and max_history < window:
            # a bound below the window would age out every frame the moment
            # it lands: an engine that runs but never scores a relation
            raise ValueError(
                f"max_history ({max_history}) must be >= window ({window})")
        self.seg = segmenter
        self.device = segmenter.device
        self.rel_model = (None if rel_model is None
                          else rel_model.to(self.device).eval())
        self.window = window
        self.relation_interval = relation_interval
        self.num_top_pairs = num_top_pairs
        self.feat_dim = feat_dim
        self.max_history = max_history
        self.device_history = device_history and rel_model is not None
        self.last_scores: Optional[np.ndarray] = None

        self._buf: List[np.ndarray] = []
        self._frame_id = 0
        self._object_list: List[int] = []
        self._tube_cls: Dict[int, int] = {}
        # host backend state: tid -> {frame: feat}
        self._tubes: Dict[int, Dict[int, np.ndarray]] = {}
        if self.device_history:
            self._ring = _DeviceRing(self.rel_model, window, feat_dim,
                                     max_history, num_top_pairs, self.device)

    # ------------------------------------------------------------------
    def push(self, frame: np.ndarray) -> Optional[Dict]:
        """Add one frame; returns the window's results when it completes:
        {'frames': [frame ids], 'pan_results': [maps], 'triplets': list or
        None}."""
        self._buf.append(frame)
        if len(self._buf) < self.window:
            return None
        return self._flush_window()

    def _flush_window(self) -> Dict:
        frames = self._buf
        self._buf = []
        outputs = self.seg.infer_window_vps(np.stack(frames))

        frame_ids, pans = [], []
        window_feats: Dict[int, List[Tuple[int, np.ndarray]]] = {}
        for out in outputs:
            fid = self._frame_id
            self._frame_id += 1
            frame_ids.append(fid)
            pans.append(out["pan_results"])
            for seg_id, feat in out["query_feats"].items():
                if seg_id not in self._object_list:
                    self._object_list.append(seg_id)
                tid = self._object_list.index(seg_id) + 1
                f = np.asarray(feat, np.float32).reshape(-1)[: self.feat_dim]
                self._tube_cls[tid] = int(seg_id % INSTANCE_OFFSET)
                if self.device_history:
                    window_feats.setdefault(tid, []).append(
                        (fid - frame_ids[0], f))
                else:
                    self._tubes.setdefault(tid, {})[fid] = f

        if self.device_history:
            self._ring.update(window_feats, self._frame_id)
        elif self.max_history is not None:
            cutoff = self._frame_id - self.max_history
            if cutoff > 0:
                for tid in list(self._tubes):
                    d = self._tubes[tid]
                    for f in [f for f in d if f < cutoff]:
                        del d[f]
                    if not d:       # aged out of the window entirely
                        del self._tubes[tid]

        triplets = None
        if (self.rel_model is not None and self._has_tubes()
                and self._frame_id % self.relation_interval < self.window):
            triplets = self._score_relations()
        # results are returned, never retained: engine memory stays
        # O(num_tubes x max_history) however long the stream runs
        return {"frames": frame_ids, "pan_results": pans,
                "triplets": triplets}

    def _has_tubes(self) -> bool:
        return bool(self._ring.live_tids() if self.device_history
                    else self._tubes)

    # ------------------------------------------------------------------
    def _score_relations(self) -> List[Dict]:
        T = self._frame_id
        if self.device_history:
            # the ring's retained window is its own truth: capacity is
            # max_history rounded DOWN to a window multiple, so column 0 may
            # sit up to window-1 frames later than the nominal bound
            lo = self._ring.lo
            ranked, self.last_scores = self._ring.score()
        else:
            lo = (max(0, T - self.max_history)
                  if self.max_history is not None else 0)
            tids = sorted(self._tubes)
            feats = np.zeros((len(tids), T - lo, self.feat_dim), np.float32)
            for k, tid in enumerate(tids):
                for f, v in self._tubes[tid].items():
                    if f >= lo:
                        feats[k, f - lo] = v.reshape(-1)[: self.feat_dim]
            _, results = evaluate_video(self.rel_model, feats,
                                        num_top_pairs=self.num_top_pairs,
                                        pairwise=False)
            ranked = [(tids[r["subject_index"]], tids[r["object_index"]],
                       r["relation"], r["relation_span"]) for r in results]
        out = []
        for s_tid, o_tid, rel, span_bin in ranked[: self.num_top_pairs]:
            span = np.flatnonzero(span_bin)
            out.append({
                "subject_tube": s_tid,
                "object_tube": o_tid,
                "subject_cls": self._tube_cls[s_tid],
                "object_cls": self._tube_cls[o_tid],
                "relation": rel,
                # spans are window-relative on the device; report absolute
                "span": [int(span[0]) + lo, int(span[-1]) + lo]
                if span.size else None,
            })
        return out

    def finish(self) -> Dict:
        """Flush any partial window (padded by repeating its last frame) and
        emit the final triplets and tube summary. num_tubes counts every
        tube ever seen, aged-out tubes included."""
        if self._buf:
            while len(self._buf) < self.window:  # pad the tail window
                self._buf.append(self._buf[-1])
            self._flush_window()
        triplets = self._score_relations() if (
            self.rel_model is not None and self._has_tubes()) else []
        return {
            "num_frames": self._frame_id,
            "num_tubes": len(self._tube_cls),
            "tube_classes": dict(self._tube_cls),
            "triplets": triplets,
        }


class _DeviceRing:
    """Device-resident rolling tube-feature window.

    hist: (S, C, D) float32 on the device: S slot rows (grown through
    SLOT_BUCKETS, zero-padded), C frame columns (``max_history`` rounded
    down to a window multiple, or a capacity that doubles when unbounded),
    the newest frame always at column t_valid-1. The host keeps only the
    slot <-> tube-id maps and each tube's last-seen frame; features never
    come back to the host.

    Each window's update is one (S, W, D) block upload; aged-out slots are
    zeroed in the same update (a keep-mask multiply), so a reused slot never
    leaks an earlier tube's features.
    """

    def __init__(self, model: RelationModel, window: int, feat_dim: int,
                 max_history: Optional[int], num_top_pairs: int, device):
        self.model = model
        self.window = window
        self.feat_dim = feat_dim
        self.max_history = max_history
        self.num_top_pairs = num_top_pairs
        self.device = device
        self.S = SLOT_BUCKETS[0]
        # capacity: the rolling bound ROUNDED DOWN to a window multiple, so
        # the shift-by-W ring stays exact (t_valid is always a window
        # multiple; the effective bound loses at most W-1 frames), or a
        # growing size when unbounded (padding keeps the contents)
        if max_history is not None:
            self.C = max(max_history // window, 1) * window
        else:
            self.C = max(128 // window, 1) * window
        self.hist = torch.zeros((self.S, self.C, feat_dim), dtype=torch.float32,
                                device=device)
        self.t_valid = 0
        self.frames_pushed = 0
        self._slot_of: Dict[int, int] = {}      # tid -> slot
        self._tid_of: Dict[int, int] = {}       # slot -> tid
        self._last_seen: Dict[int, int] = {}    # tid -> frame of last detection

    # -- slot management ------------------------------------------------
    @property
    def lo(self) -> int:
        """Absolute frame id of ring column 0."""
        return self.frames_pushed - self.t_valid

    def live_tids(self):
        return list(self._slot_of)

    def _assign_slot(self, tid: int) -> int:
        if tid in self._slot_of:
            return self._slot_of[tid]
        used = set(self._slot_of.values())
        free = [s for s in range(self.S) if s not in used]
        if not free:
            self._grow_slots()
            free = [s for s in range(self.S) if s not in used]
        slot = free[0]
        self._slot_of[tid] = slot
        self._tid_of[slot] = tid
        return slot

    def _grow_slots(self):
        new_s = next((b for b in SLOT_BUCKETS if b > self.S), self.S * 2)
        self.hist = torch.nn.functional.pad(self.hist,
                                            (0, 0, 0, 0, 0, new_s - self.S))
        self.S = new_s

    def _grow_capacity(self, needed: int):
        new_c = self.C
        while new_c < needed:
            new_c *= 2
        self.hist = torch.nn.functional.pad(self.hist,
                                            (0, 0, 0, new_c - self.C))
        self.C = new_c

    def _append(self, keep: torch.Tensor, block: torch.Tensor):
        """Zero the aged-out slots, shift left by W when the ring is full,
        and write the W new columns at min(t_valid, C - W)."""
        W, C = self.window, self.C
        hist = self.hist * keep[:, None, None]
        if self.t_valid + W > C:
            hist = torch.roll(hist, -W, dims=1)
        start = min(self.t_valid, C - W)
        hist[:, start:start + W] = block
        self.hist = hist

    # -- per-window update ----------------------------------------------
    def update(self, window_feats: Dict[int, List[Tuple[int, np.ndarray]]],
               frame_id: int):
        """window_feats: tid -> [(offset within window, feat)]; frame_id:
        the number of frames seen, this window's included."""
        # age out tubes unseen within the rolling bound BEFORE assigning
        # slots, so a full slot table frees space for new tubes first. A
        # tube's last-seen frame is that of its last detection: it ages out
        # exactly when none of its detections is in the retained frames, as
        # on the host backend (the JAX ring records the window's end and
        # keeps such a tube one window longer, on zero features)
        for tid, entries in window_feats.items():
            self._last_seen[tid] = (frame_id - self.window
                                    + max(off for off, _ in entries))
        keep = np.ones(self.S, np.float32)
        if self.max_history is not None:
            cutoff = frame_id - self.max_history
            for tid in [t for t, last in self._last_seen.items()
                        if last < cutoff]:
                del self._last_seen[tid]
                if tid in self._slot_of:
                    slot = self._slot_of.pop(tid)
                    del self._tid_of[slot]
                    keep[slot] = 0.0
        # slot growth may be triggered by assignment; pad keep after it
        slots = {tid: self._assign_slot(tid) for tid in window_feats}
        if self.S > keep.shape[0]:
            keep = np.pad(keep, (0, self.S - keep.shape[0]),
                          constant_values=1.0)
        if self.max_history is None and self.t_valid + self.window > self.C:
            self._grow_capacity(self.t_valid + self.window)

        block = np.zeros((self.S, self.window, self.feat_dim), np.float32)
        for tid, entries in window_feats.items():
            for off, feat in entries:
                block[slots[tid], off] = feat
        self._append(torch.from_numpy(keep).to(self.device),
                     torch.from_numpy(block).to(self.device))
        self.t_valid = min(self.t_valid + self.window, self.C)
        self.frames_pushed += self.window

    # -- scoring ----------------------------------------------------------
    @torch.no_grad()
    def score(self) -> Tuple[List[Tuple[int, int, int, np.ndarray]], np.ndarray]:
        """Ranked (subject_tid, object_tid, relation, span) with the span
        binarized over the valid columns (column 0 = the oldest retained
        frame), the same content as the host backend's ranking, and the
        probability of each ranked entry."""
        tube_valid = np.zeros(self.S, bool)
        tube_valid[list(self._tid_of)] = True
        frame_valid = torch.arange(self.C, device=self.device) < self.t_valid
        with ieee_float32():
            out = self.model(self.hist,
                             tube_valid=torch.from_numpy(tube_valid).to(self.device),
                             frame_valid=frame_valid)
            # (S, S): the only sizeable fetch
            pm = out["pred_matrix"].cpu().numpy().astype(np.float64)
            pm[~tube_valid, :] = -np.inf  # never pair an empty slot
            pm[:, ~tube_valid] = -np.inf
            pairs = [p for p in pick_top_pairs_eval(pm, self.num_top_pairs)
                     if np.isfinite(pm[p[0], p[1]])]
            if not pairs:
                return [], np.zeros(0)
            # the pair axis is padded to the budget; padded rows rank last
            P = len(pairs)
            idx = np.zeros((self.num_top_pairs, 2), np.int64)
            idx[:P] = np.asarray(pairs, np.int64)
            sel = torch.from_numpy(idx).to(self.device)
            pair = torch.cat([out["sub_feats"].index_select(0, sel[:, 0]),
                              out["obj_feats"].index_select(0, sel[:, 1])],
                             dim=-1)
            span, prob = self.model.predict(pair, frame_valid)
            # the spans cross binarized
            span_bin = (span[:, :self.t_valid] > 0).cpu().numpy()
            prob = prob.cpu().numpy().astype(np.float64)
        prob[P:] = -np.inf  # padded pair rows rank strictly last
        results = generate_results(span_bin.astype(float), prob, idx.tolist())
        # generate_results orders by descending prob over all budget * R
        # entries; padded rows are exactly the -inf tail
        n = P * prob.shape[1]
        scores = -np.sort(-prob.reshape(-1))[:n]
        return [(self._tid_of[int(r["subject_index"])],
                 self._tid_of[int(r["object_index"])],
                 r["relation"], r["relation_span"]) for r in results[:n]], scores


def triplets_agree(a: Sequence[Dict], b: Sequence[Dict],
                   scores: Sequence[float], tol: float) -> bool:
    """Whether two ranked triplet lists are equal wherever adjacent scores
    (``scores``: the probabilities of one side's full ranking, in order)
    are more than ``tol`` apart: entries closer than that form a block
    whose members may come in any order, and a block that crosses the end
    of the emitted list may be cut differently."""
    if len(a) != len(b):
        return False
    scores = np.asarray(scores, np.float64)
    cuts = np.flatnonzero(scores[:-1] - scores[1:] > tol) + 1
    bounds = [0, *cuts.tolist(), max(len(scores), len(a))]
    key = lambda t: json.dumps(t, sort_keys=True)  # noqa: E731
    for lo, hi in zip(bounds, bounds[1:]):
        if lo >= len(a):
            break
        if hi > len(a):
            continue
        if sorted(map(key, a[lo:hi])) != sorted(map(key, b[lo:hi])):
            return False
    return True
