"""Panoptic fusion for a batch of frames, the port of
``openpvsg_tpu/models/fusion.py:33-92``::

  keep      = (argmax class != void) & (score > object_mask_thr)
  owner     = per-pixel argmax of score-weighted sigmoid masks
  seg valid = mask_area / original_area >= iou_thr
  pan map   = class + instance_id * INSTANCE_OFFSET (things, numbered 1.. in
              query order) or class (stuff); void = num_classes

The owner and area step runs as kernel B2 (``kernels/fusion.py``) on the
stride-4 logits, so the upsampled (Q, H, W) masks are never materialized on
the card; the rest (valid, cumulative instance ids, paint) is torch.
``query_feats_by_segment`` attaches the kept queries' features to their
segments on the host. ``instance_postprocess`` is the reference's top-k
instance extraction (its IPS test surface).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from openpvsg_torch import INSTANCE_OFFSET
from openpvsg_torch.kernels.fusion import fusion_maps
from openpvsg_torch.ops.sampling import top_k_indices


def panoptic_fusion(cls_logits: torch.Tensor, mask_low: torch.Tensor,
                    num_things_classes: int, num_stuff_classes: int,
                    object_mask_thr: float, iou_thr: float,
                    padded_hw: Tuple[int, int], ori_hw: Tuple[int, int]
                    ) -> Dict[str, torch.Tensor]:
    """cls_logits (N, Q, K+1); mask_low (N, Q, h, w) stride-4 mask logits of
    the padded frame, padded_hw = (4h, 4w); the result covers the top-left
    ori_hw crop. Returns per frame:
      pan_seg    (N, H, W) int32 mmdet-format panoptic map (H, W = ori_hw)
      query_keep (N, Q) bool — the query wrote a segment
      segment_id (N, Q) int32 — its segment id, -1 where not kept
      labels     (N, Q) int32; scores (N, Q) float32
    """
    num_classes = num_things_classes + num_stuff_classes
    oh, ow = int(ori_hw[0]), int(ori_hw[1])
    probs = torch.softmax(cls_logits.float(), dim=-1)
    scores = probs.amax(dim=-1)
    labels = probs.argmax(dim=-1).to(torch.int32)
    keep = (labels != num_classes) & (scores > object_mask_thr)

    owner, binary, mask_area, original_area = fusion_maps(
        mask_low.float().contiguous(),
        torch.where(keep, scores, torch.full_like(scores, float("-inf"))),
        padded_hw, (oh, ow))
    owner = owner[:, :oh, :ow].long()
    binary = binary[:, :oh, :ow]

    valid = (keep & (mask_area > 0) & (original_area > 0)
             & (mask_area >= iou_thr * original_area))
    is_thing = labels < num_things_classes
    inst_id = torch.cumsum((valid & is_thing).to(torch.int32), dim=1)
    segment_id = torch.where(is_thing, labels + inst_id * INSTANCE_OFFSET,
                             labels).to(torch.int32)

    N = owner.shape[0]
    flat = owner.reshape(N, -1)
    owner_valid = valid.gather(1, flat).reshape_as(owner) & binary
    pan_seg = torch.where(owner_valid,
                          segment_id.gather(1, flat).reshape_as(owner),
                          torch.full_like(owner, num_classes, dtype=torch.int32))
    return {
        "pan_seg": pan_seg.to(torch.int32),
        "query_keep": valid,
        "segment_id": torch.where(valid, segment_id,
                                  torch.full_like(segment_id, -1)),
        "labels": labels,
        "scores": scores,
    }


def query_feats_by_segment(fusion: Dict[str, np.ndarray],
                           query_feats: np.ndarray) -> Dict[int, np.ndarray]:
    """Host side, one frame: {segment_id: query feature}; a stuff segment
    that merged several queries averages their features (reference:
    mask2former_fusion_head.py:96-171 and the stuff averaging in
    unitrack/data/single_video.py:60-76). ``fusion`` holds the frame's
    ``query_keep`` (Q,) and ``segment_id`` (Q,) as numpy arrays."""
    out: Dict[int, list] = {}
    keep = np.asarray(fusion["query_keep"])
    seg_ids = np.asarray(fusion["segment_id"])
    for q in np.flatnonzero(keep):
        out.setdefault(int(seg_ids[q]), []).append(np.asarray(query_feats[q]))
    return {k: np.mean(v, axis=0) for k, v in out.items()}


def instance_postprocess(cls_logits, mask_logits, num_things_classes: int,
                         max_per_image: int = 100
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Top-k instance extraction of one frame (``instance_postprocess``,
    ``openpvsg_tpu/models/fusion.py:121``; reference:
    mask2former_fusion_head.py:192-242): cls_logits (Q, K+1) and mask
    logits (Q, H, W), tensors or arrays -> (labels, scores, masks) as numpy
    of the ``max_per_image`` best (query, class) pairs that are things. The
    class softmax drops the void column; the top-k over the Q x K scores
    takes ``lax.top_k``'s order, the lower flat index first among ties
    (``top_k_indices``); a mask is ``sigmoid >= 0.5``."""
    cls_logits, mask_logits = (t if torch.is_tensor(t) else torch.from_numpy(np.asarray(t))
                               for t in (cls_logits, mask_logits))
    num_classes = cls_logits.shape[-1] - 1
    scores = torch.softmax(cls_logits.float(), dim=-1)[:, :-1].reshape(-1)
    idx = top_k_indices(scores, max_per_image)
    labels = idx % num_classes
    is_thing = labels < num_things_classes
    keep = idx[is_thing]
    masks = torch.sigmoid(mask_logits.float()[keep // num_classes]) >= 0.5
    return (labels[is_thing].cpu().numpy(), scores[keep].cpu().numpy(),
            masks.cpu().numpy())
