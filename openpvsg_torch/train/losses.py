"""Mask2Former training losses in the query layout: the port of
``openpvsg_tpu/train/losses.py:29-168,187-319``.

  loss_cls : softmax CE over K+1 classes, weight 2.0, background class
             weight 0.1, avg_factor = sum of class_weight[label]
  loss_mask: sigmoid BCE over P points, weight 5.0,
             avg_factor = num_total_masks * P
  loss_dice: naive dice over the same points, weight 5.0,
             avg_factor = num_total_masks

The points are every stride-4 pixel (dense mode) or, in points mode, the
reference's point-rend estimate: per layer, ``num_points`` points for each
(item, query), uncertainty-sampled on the detached logits of the clip as
one tall (T*H, W) image; the logits (with their gradient) and the targets
are sampled there. Each layer is sampled on its own, as the JAX loop does:
the candidates of all layers at once would not fit at full width.

All queries keep fixed shapes: unassigned queries get the background label
and contribute to the mask losses through zero weights. The assignment is
made on detached predictions, so no gradient reaches the costs. Every
reduction runs in float32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from openpvsg_torch.ops.sampling import (Draw, point_sample,
                                         uncertainty_sampled_points)
from openpvsg_torch.train.assign import hungarian_assign_layers


def gather_targets(assigned: torch.Tensor, gt_labels: torch.Tensor,
                   gt_masks: torch.Tensor, num_classes: int):
    """assigned (B, Q) target index or -1 -> per-query labels (background =
    num_classes), target masks (B, Q, T, H, W) and positive flags (B, Q)."""
    B = assigned.shape[0]
    pos = assigned >= 0
    safe = assigned.clamp(min=0).long()
    labels = torch.where(pos, gt_labels.long().gather(1, safe), num_classes)
    tgt_masks = gt_masks[torch.arange(B, device=safe.device)[:, None], safe]
    return labels, tgt_masks, pos


def softmax_cls_loss(cls_pred: torch.Tensor, labels: torch.Tensor,
                     num_classes: int, cls_weight: float = 2.0,
                     bg_cls_weight: float = 0.1) -> torch.Tensor:
    """Softmax CE with down-weighted background class; avg_factor is the
    summed class weight (mmdet CrossEntropyLoss semantics)."""
    class_weight = torch.ones(num_classes + 1, device=cls_pred.device)
    class_weight[num_classes] = bg_cls_weight
    logp = F.log_softmax(cls_pred.float(), dim=-1)
    ce = -logp.gather(-1, labels[..., None])[..., 0]
    w = class_weight[labels]
    return cls_weight * (ce * w).sum() / w.sum().clamp(min=1e-6)


def mask2former_layer_loss(cls_pred, mask_pred, labels, tgt_masks, pos,
                           num_total_masks, num_classes: int,
                           cls_weight: float = 2.0, mask_weight: float = 5.0,
                           dice_weight: float = 5.0,
                           bg_cls_weight: float = 0.1, num_points: int = 0,
                           oversample_ratio: float = 3.0,
                           importance_sample_ratio: float = 0.75,
                           draw: Optional[Draw] = None) -> Dict[str, torch.Tensor]:
    """One decoder layer: cls_pred (B, Q, K+1), mask_pred (B, Q, T, H, W),
    tgt_masks (B, Q, T, Hm, Wm), labels and pos (B, Q). Dense
    (``num_points`` 0) needs Hm, Wm = H, W; points mode samples both in
    normalized coordinates, with the two draws of
    ``uncertainty_sampled_points``."""
    B, Q = labels.shape
    loss_cls = softmax_cls_loss(cls_pred, labels, num_classes, cls_weight,
                                bg_cls_weight)
    if num_points > 0:
        if draw is None:
            raise ValueError("points mode (num_points > 0) needs a draw")
        # each clip as one tall (T*H, W) image
        mp_img = mask_pred.reshape(B * Q, -1, mask_pred.shape[-1], 1)
        mt_img = tgt_masks.reshape(B * Q, -1, tgt_masks.shape[-1], 1)
        pts = uncertainty_sampled_points(draw, mp_img[..., 0].detach(), num_points,
                                         oversample_ratio, importance_sample_ratio)
        mp = point_sample(mp_img, pts)[..., 0]
        mt = point_sample(mt_img, pts)[..., 0]
    else:
        mp = mask_pred.reshape(B * Q, -1).float()
        mt = tgt_masks.reshape(B * Q, -1).float()
    P = mp.shape[-1]
    posw = pos.reshape(B * Q, 1).to(mp.dtype)

    bce = mp.clamp(min=0) - mp * mt + torch.log1p(torch.exp(-mp.abs()))
    loss_mask = mask_weight * (bce * posw).sum() / (num_total_masks * P).clamp(min=1.0)

    pred = torch.sigmoid(mp)
    numer = 2.0 * (pred * mt).sum(-1)
    denom = pred.sum(-1) + mt.sum(-1)
    dice = 1.0 - (numer + 1.0) / (denom + 1.0)
    loss_dice = dice_weight * (dice * posw[:, 0]).sum() / num_total_masks.clamp(min=1.0)
    return {"loss_cls": loss_cls, "loss_mask": loss_mask, "loss_dice": loss_dice}


def mask2former_loss(cls_preds: torch.Tensor, mask_preds: torch.Tensor,
                     gt_labels: torch.Tensor, gt_masks: torch.Tensor,
                     gt_valid: torch.Tensor, num_classes: int,
                     cls_weight: float = 2.0, mask_weight: float = 5.0,
                     dice_weight: float = 5.0, bg_cls_weight: float = 0.1,
                     assigned: Optional[np.ndarray] = None,
                     num_points: int = 0, oversample_ratio: float = 3.0,
                     importance_sample_ratio: float = 0.75,
                     draw: Optional[Draw] = None, num_stuff_queries: int = 0,
                     num_things_classes: int = 0
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Deep-supervised loss over every decoder layer: cls_preds (L, B, Q,
    K+1), mask_preds (L, B, Q, T, H, W), gt_masks (B, N, T, H, W) binary at
    the prediction's resolution, gt_valid (B, N).

    ``num_points`` > 0 is points mode, whose uniform draws come from
    ``draw``: the assignment's (L, B, num_points, 2), then each layer's
    two. ``num_stuff_queries`` > 0 splits the queries (the last ones take
    only stuff targets). ``assigned`` (L, B, Q), when given, is the
    assignment ``hungarian_assign_layers`` computes for these detached
    predictions (the trainer makes it itself to time it); otherwise it is
    computed here. Returns (total, logs) with the JAX package's keys:
    ``loss_cls``, ``loss_mask``, ``loss_dice`` for the last layer, with
    ``.d{l}`` for the earlier ones."""
    L = cls_preds.shape[0]
    num_total_masks = gt_valid.sum().float().clamp(min=1.0)
    if assigned is None:
        assigned = hungarian_assign_layers(
            cls_preds.detach(), mask_preds.detach(), gt_labels, gt_masks,
            gt_valid, cls_weight, mask_weight, dice_weight, num_points, draw,
            num_stuff_queries, num_things_classes)
    assigned = torch.as_tensor(assigned, device=cls_preds.device)

    total = 0.0
    logs: Dict[str, torch.Tensor] = {}
    for layer in range(L):
        labels, tgt_masks, pos = gather_targets(
            assigned[layer], gt_labels, gt_masks, num_classes)
        losses = mask2former_layer_loss(
            cls_preds[layer], mask_preds[layer], labels, tgt_masks, pos,
            num_total_masks, num_classes, cls_weight, mask_weight,
            dice_weight, bg_cls_weight, num_points, oversample_ratio,
            importance_sample_ratio, draw)
        total = total + sum(losses.values())
        tag = "" if layer == L - 1 else f".d{layer}"
        for k, v in losses.items():
            logs[k + tag] = v
    return total, logs
