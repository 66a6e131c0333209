"""Association costs and the linear assignment of the mask tracker, the port
of ``openpvsg_tpu/tracker/matching.py``.

Rebuild of the reference matching library (reference:
models/unitrack/core/association/matching.py). UniTrack's bidirectional
soft-reconstruction cost over per-object pixel-feature sets
(``reconsdot_distance``) runs in torch on the sets' device, in IEEE float32;
box IoU, cosine distance, the class gate and the Kalman fusion are host
numpy, and the assignment is the shared C++ LAPJV (``native.lapjv``).

Feature sets are zero-padded to a fixed pixel count with validity masks;
padding leaves the softmaxes through ``finfo(float32).min`` masking, as in
the JAX package (the reference zero-pads and lets the zero vectors take
part).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from openpvsg_torch import native

# bytes a reconsdot intermediate may hold per chunk: the reconstructions are
# (rows, other sets, D) float32, ~1.7 GB each at 40 tracks x 20 detections
# of 512 pixels and D = 1024 when built whole
CHUNK_BYTES = 1 << 28

FeatureSet = Union[np.ndarray, torch.Tensor]


def linear_assignment(cost: np.ndarray, thresh: float):
    """LAPJV with cost limit; returns (matches (M, 2), unmatched_rows,
    unmatched_cols) — reference: matching.py:29-40."""
    cost = np.asarray(cost, dtype=np.float64)
    if cost.size == 0:
        return (np.empty((0, 2), dtype=int),
                tuple(range(cost.shape[0])), tuple(range(cost.shape[1])))
    # guard against inf entries breaking the solver: clamp to a huge finite
    # value above any cost_limit rejection threshold
    big = 1e18
    cost = np.where(np.isfinite(cost), cost, big)
    _, x, _ = native.lapjv(cost, cost_limit=thresh)
    matches = [[i, int(x[i])] for i in range(len(x)) if x[i] >= 0]
    matched_cols = {j for _, j in matches}
    u_rows = tuple(i for i in range(cost.shape[0]) if x[i] < 0)
    u_cols = tuple(j for j in range(cost.shape[1]) if j not in matched_cols)
    return np.asarray(matches, dtype=int).reshape(-1, 2), u_rows, u_cols


def box_ious(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of tlbr boxes (replaces cython_bbox.bbox_overlaps;
    reference: matching.py:43-60)."""
    a = np.asarray(a, dtype=np.float64).reshape(-1, 4)
    b = np.asarray(b, dtype=np.float64).reshape(-1, 4)
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]))
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    iw = np.clip(ix2 - ix1 + 1, 0, None)
    ih = np.clip(iy2 - iy1 + 1, 0, None)
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def iou_distance(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    return 1.0 - box_ious(boxes_a, boxes_b)


def _flat_norm(x: torch.Tensor) -> torch.Tensor:
    """L2-normalize over the last axis (``x / (||x|| + 1e-12)``)."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def _reconsdot(ftrk: torch.Tensor, trk_valid: torch.Tensor,
               fdet: torch.Tensor, det_valid: torch.Tensor,
               tmp: float = 100.0) -> torch.Tensor:
    """Bidirectional soft-reconstruction cosine cost, the port of
    ``_reconsdot_kernel`` (``openpvsg_tpu/tracker/matching.py:71``).

    ftrk: (T, P, D) L2-normalized pixel features (zero rows = padding),
    trk_valid: (T, P) bool; likewise (N, Pd, D) / (N, Pd) for the
    detections. Returns the (T, N) cost. Reference: matching.py:194-238.

    Both softmaxes run over the GLOBAL pixel axis (all detections jointly,
    all tracks jointly; reference matching.py:215-216), so each direction is
    chunked along the axis its softmax does not reduce: track rows for the
    detection-axis softmax, detection columns for the track-axis softmax.
    Each chunk holds whole sets, so the per-set norms need no second pass.
    """
    T, P, D = ftrk.shape
    N, Pd, _ = fdet.shape
    aff = ftrk.reshape(T * P, D) @ fdet.reshape(N * Pd, D).T  # (T*P, N*Pd)
    neg = torch.finfo(aff.dtype).min
    scaled = tmp * aff
    del aff

    ft_flat = _flat_norm((ftrk * trk_valid[..., None]).reshape(T, P * D))
    fd_flat = _flat_norm((fdet * det_valid[..., None]).reshape(N, Pd * D))

    # track pixels reconstructed from the detections' pixel sets
    dot_td = scaled.new_empty((T, N))
    dmask = det_valid.reshape(1, N * Pd)
    step = max(1, CHUNK_BYTES // (P * N * D * 4))
    for lo in range(0, T, step):
        hi = min(lo + step, T)
        a = torch.softmax(torch.where(dmask, scaled[lo * P:hi * P], neg), dim=1)
        # (rows, N, Pd) x (N, Pd, D) -> (rows, N, D)
        r = torch.einsum("xnp,npd->xnd", a.reshape(-1, N, Pd), fdet)
        r = r.reshape(hi - lo, P, N, D).transpose(1, 2)      # (t, N, P, D)
        r = r * trk_valid[lo:hi, None, :, None]
        rt = _flat_norm(r.reshape(hi - lo, N, P * D))
        dot_td[lo:hi] = torch.einsum("tnd,td->tn", rt, ft_flat[lo:hi])
        del a, r, rt

    # detection pixels reconstructed from each track's pixel set; the
    # softmax over the track axis runs on the transposed block, made
    # contiguous first: a softmax over dim 0 of a row-major block is a
    # strided reduction several times slower than the products
    dot_dt = scaled.new_empty((N, T))
    tmask = trk_valid.reshape(1, T * P)
    step = max(1, CHUNK_BYTES // (Pd * T * D * 4))
    for lo in range(0, N, step):
        hi = min(lo + step, N)
        block = scaled[:, lo * Pd:hi * Pd].T.contiguous()    # (n*Pd, T*P)
        a = torch.softmax(torch.where(tmask, block, neg), dim=1).reshape(-1, T, P)
        del block
        r = torch.einsum("xtp,tpd->xtd", a, ftrk)            # (n*Pd, T, D)
        r = r.reshape(hi - lo, Pd, T, D).transpose(1, 2)     # (n, T, Pd, D)
        r = r * det_valid[lo:hi, None, :, None]
        rd = _flat_norm(r.reshape(hi - lo, T, Pd * D))
        dot_dt[lo:hi] = torch.einsum("ntd,nd->nt", rd, fd_flat[lo:hi])
        del a, r, rd
    return 1.0 - 0.5 * (dot_td + dot_dt.T)


def pad_feature_sets(feats: Sequence[FeatureSet], max_pixels: int,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """List of (D, n_i) pixel-feature sets (numpy or torch) -> ((N, P, D)
    float32 L2-normalized padded stack, (N, P) validity) on ``device`` (the
    sets' own device when None). Each pixel's channels are normalized first
    (reference F.normalize along dim=1), then the set is padded."""
    sets = [(f if isinstance(f, torch.Tensor) else torch.from_numpy(np.array(f)))
            .to(device=device, dtype=torch.float32)[:, :max_pixels] for f in feats]
    widths = [f.shape[1] for f in sets]
    # the tracker's sets all have one width: one stack, then one pad (zero
    # columns normalize to zero, so padding before normalizing is exact)
    w = max(widths)
    x = torch.stack([f if f.shape[1] == w else F.pad(f, (0, w - f.shape[1]))
                     for f in sets])
    x = F.pad(x, (0, max_pixels - w))                          # (N, D, P)
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)
    valid = (torch.arange(max_pixels, device=x.device)[None, :]
             < torch.tensor(widths, device=x.device)[:, None])
    return x.transpose(1, 2).contiguous(), valid


def reconsdot_distance(track_feats: Sequence[FeatureSet],
                       det_feats: Sequence[FeatureSet],
                       max_pixels: int = 512, tmp: float = 100.0,
                       device=None) -> np.ndarray:
    """(T, N) float32 cost matrix between track and detection pixel-feature
    sets (each a (D, n_px) array or tensor), computed on ``device`` (the
    sets' own device when None) in IEEE float32 whatever the caller's TF32
    settings."""
    from openpvsg_torch.train.segmenter import ieee_float32

    if len(track_feats) == 0 or len(det_feats) == 0:
        return np.zeros((len(track_feats), len(det_feats)))
    ft, vt = pad_feature_sets(track_feats, max_pixels, device)
    fd, vd = pad_feature_sets(det_feats, max_pixels, ft.device)
    with torch.no_grad(), ieee_float32():
        return _reconsdot(ft, vt, fd, vd, tmp=tmp).cpu().numpy()


def cosine_distance(track_feats: np.ndarray, det_feats: np.ndarray) -> np.ndarray:
    """1 - cosine similarity of flat feature vectors (reference:
    matching.py:115-132 center_emb_distance)."""
    if len(track_feats) == 0 or len(det_feats) == 0:
        return np.zeros((len(track_feats), len(det_feats)))
    a = np.asarray(track_feats, dtype=np.float32)
    b = np.asarray(det_feats, dtype=np.float32)
    a = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
    b = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-12)
    return 1.0 - a @ b.T


def category_gate(cost_matrix: np.ndarray, tracks, detections) -> np.ndarray:
    """Penalize category mismatches additively (reference:
    matching.py:241-256 — used when observations carry a category column)."""
    if cost_matrix.size == 0:
        return cost_matrix
    det_c = np.array([d.category for d in detections], dtype=np.float64)
    trk_c = np.array([t.category for t in tracks], dtype=np.float64)
    return cost_matrix + np.abs(det_c[None, :] - trk_c[:, None])


def fuse_motion(kf, cost_matrix: np.ndarray, tracks, detections,
                only_position: bool = False, lambda_: float = 0.98,
                gate: bool = True) -> np.ndarray:
    """Blend appearance cost with Kalman gating distance (reference:
    matching.py:100-112)."""
    if cost_matrix.size == 0:
        return cost_matrix
    gating_dim = 2 if only_position else 4
    from openpvsg_torch.tracker.kalman import CHI2INV95
    gating_threshold = CHI2INV95[gating_dim]
    measurements = np.asarray([d.to_xyah() for d in detections])
    for row, track in enumerate(tracks):
        gd = kf.gating_distance(track.mean, track.covariance, measurements,
                                only_position)
        if gate:
            cost_matrix[row, gd > gating_threshold] = np.inf
        cost_matrix[row] = lambda_ * cost_matrix[row] + (1 - lambda_) * gd
    return cost_matrix
