"""Palette-mask decoding and panoptic segment-id conventions: the port's
copy of ``openpvsg_tpu/data/masks.py`` (integer outputs bit-identical).

PVSG ground-truth masks are single-channel palette PNGs whose pixel value is
the annotation `object_id` (0 = background/void). Decoding produces the same
tensors the reference pipeline builds (reference:
datasets/pipelines/loading.py:94-186):

  gt_semantic_seg  HxW int32, per-pixel class id; background = num_classes
  gt_panoptic_seg  HxW int64, sem * EVAL_DIVISOR + object_id ("hb" format)
  gt_masks         NxHxW uint8 binary instance masks
  gt_labels        N    int32 class ids
  gt_instance_ids  N    int32 raw object ids
  gt_bboxes        Nx4  float32 xyxy boxes derived from masks

Everything is vectorized (no per-instance python loops over pixels).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from openpvsg_torch import EVAL_DIVISOR, INSTANCE_OFFSET


def decode_palette_mask(
    pan_mask: np.ndarray,
    objects_info: Sequence[Dict],
    class_index: Dict[str, int],
    num_classes: int,
) -> Dict[str, np.ndarray]:
    """Decode an object-id palette mask into the training target dict.

    `objects_info` is the video's `objects` list; entry i describes
    object_id == i + 1 (reference: loading.py:125 `objects_info[instance_id-1]`).
    """
    pan_mask = pan_mask.astype(np.int64)
    h, w = pan_mask.shape

    # per-object category lookup table indexed by object_id
    max_oid = int(pan_mask.max()) if pan_mask.size else 0
    lut = np.full(max(max_oid + 1, 1), num_classes, dtype=np.int32)
    for oid in range(1, max_oid + 1):
        if oid - 1 < len(objects_info):
            lut[oid] = class_index[objects_info[oid - 1]["category"]]

    gt_semantic_seg = lut[pan_mask]
    gt_panoptic_seg = gt_semantic_seg.astype(np.int64) * EVAL_DIVISOR + pan_mask

    present = np.unique(pan_mask)
    present = present[present > 0]
    gt_instance_ids = present.astype(np.int32)
    gt_labels = lut[present].astype(np.int32)
    gt_masks = (pan_mask[None, :, :] == present[:, None, None]).astype(np.uint8)

    return {
        "gt_semantic_seg": gt_semantic_seg.astype(np.int32),
        "gt_panoptic_seg": gt_panoptic_seg,
        "gt_masks": gt_masks,
        "gt_labels": gt_labels,
        "gt_instance_ids": gt_instance_ids,
        "gt_bboxes": masks_to_boxes(gt_masks),
    }


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """NxHxW binary masks -> Nx4 float32 xyxy boxes; empty mask -> zeros
    (reference: datasets/pipelines/loading.py:12-23 bitmasks2bboxes)."""
    n = masks.shape[0]
    boxes = np.zeros((n, 4), dtype=np.float32)
    if n == 0:
        return boxes
    x_any = masks.any(axis=1)  # (N, W)
    y_any = masks.any(axis=2)  # (N, H)
    for i in range(n):
        xs = np.flatnonzero(x_any[i])
        ys = np.flatnonzero(y_any[i])
        if xs.size and ys.size:
            boxes[i] = (xs[0], ys[0], xs[-1], ys[-1])
    return boxes


def pan_mm2hb(pred_pan_map: np.ndarray, num_classes: int,
              divisor: int = EVAL_DIVISOR) -> np.ndarray:
    """Convert an mmdet-format panoptic map (label + inst*INSTANCE_OFFSET)
    into the evaluation format (label*divisor + inst), vectorized
    (reference: datasets/datasets/utils.py:107-119)."""
    pan = pred_pan_map.astype(np.int64)
    cls = pan % INSTANCE_OFFSET
    ins = pan // INSTANCE_OFFSET
    out = cls * divisor + ins
    # ids below INSTANCE_OFFSET are pure semantic labels (inst = 0); the
    # num_classes id is "void" and maps to num_classes*divisor.
    return out


def pan_hb2mm(pan_hb: np.ndarray, divisor: int = EVAL_DIVISOR) -> np.ndarray:
    """Inverse of pan_mm2hb (eval format -> mmdet format)."""
    pan = pan_hb.astype(np.int64)
    cls = pan // divisor
    ins = pan % divisor
    return cls + ins * INSTANCE_OFFSET


def panoptic_from_instance_map(pan_mask: np.ndarray, lut: np.ndarray,
                               divisor: int = EVAL_DIVISOR) -> np.ndarray:
    """object-id map + object_id->class LUT -> eval-format panoptic map."""
    sem = lut[pan_mask.astype(np.int64)]
    return sem.astype(np.int64) * divisor + pan_mask.astype(np.int64)


def check_label_consistency(frames: Sequence[Dict]) -> None:
    """Assert that every instance id carries ONE class label across a clip's
    frames (reference: LabelConsistencyChecker,
    datasets/pipelines/formatting.py:314-336). frames: per-frame dicts with
    gt_instance_ids + gt_labels. Raises ValueError on conflict."""
    label_of: Dict[int, int] = {}
    for t, f in enumerate(frames):
        for iid, lab in zip(np.asarray(f["gt_instance_ids"]).tolist(),
                            np.asarray(f["gt_labels"]).tolist()):
            if iid in label_of and label_of[iid] != lab:
                raise ValueError(
                    f"instance {iid} labeled {label_of[iid]} and {lab} "
                    f"(frame {t}) — inconsistent clip annotation")
            label_of[iid] = lab
