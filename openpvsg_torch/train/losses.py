"""Mask2Former training losses: the port of
``openpvsg_tpu/train/losses.py``.

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
and contribute to the mask losses through zero weights (the 'query'
layout). The 'target' layout (dense only) inverts the assignment and
gathers the <= N matched predictions instead: the same summands. The
assignment is made on detached predictions, so no gradient reaches the
costs. Options: the sigmoid focal classification loss in place of the
softmax one, and the semantic head's per-pixel cross entropy when the
batch carries ``gt_semantic``. bfloat16 mask logits (``mask_logits_dtype``)
are widened to float32 in the loss, and every reduction runs in float32.

Over several ranks (``global_sum``, the trainer's all-reduce) each rank
computes the loss of its block of the global batch with the global
normalizers, as JAX's sharded step does (``losses.py:8-17,254``):
``num_total_masks``, the class loss's ``avg_factor``, the focal loss's
foreground count and the semantic loss's pixel count are summed over the
ranks, so the ranks' losses add up to the global batch's.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from openpvsg_torch.ops.sampling import (Draw, point_sample,
                                         uncertainty_sampled_points)
from openpvsg_torch.train.assign import _wide, hungarian_assign_layers


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


GlobalSum = Callable[[torch.Tensor], torch.Tensor]


def _global(t: torch.Tensor, global_sum: Optional[GlobalSum]) -> torch.Tensor:
    """A normalizer summed over the ranks (``t`` itself on one)."""
    return t if global_sum is None else global_sum(t)


def softmax_cls_loss(cls_pred: torch.Tensor, labels: torch.Tensor,
                     num_classes: int, cls_weight: float = 2.0,
                     bg_cls_weight: float = 0.1,
                     global_sum: Optional[GlobalSum] = None) -> torch.Tensor:
    """Softmax CE with down-weighted background class; avg_factor is the
    summed class weight (mmdet CrossEntropyLoss semantics), over every rank
    with ``global_sum``."""
    class_weight = torch.ones(num_classes + 1, device=cls_pred.device)
    class_weight[num_classes] = bg_cls_weight
    logp = F.log_softmax(cls_pred.float(), dim=-1)
    ce = -logp.gather(-1, labels[..., None])[..., 0]
    w = class_weight[labels]
    return cls_weight * (ce * w).sum() / _global(w.sum(), global_sum).clamp(min=1e-6)


def mask2former_layer_loss(cls_pred, mask_pred, labels, tgt_masks, pos,
                           num_total_masks, num_classes: int,
                           cls_weight: float = 2.0, mask_weight: float = 5.0,
                           dice_weight: float = 5.0,
                           bg_cls_weight: float = 0.1, num_points: int = 0,
                           oversample_ratio: float = 3.0,
                           importance_sample_ratio: float = 0.75,
                           draw: Optional[Draw] = None,
                           global_sum: Optional[GlobalSum] = None
                           ) -> Dict[str, torch.Tensor]:
    """One decoder layer: cls_pred (B, Q, K+1), mask_pred (B, Q, T, H, W),
    tgt_masks (B, Q, T, Hm, Wm), labels and pos (B, Q). Dense
    (``num_points`` 0) needs Hm, Wm = H, W; points mode samples both in
    normalized coordinates, with the two draws of
    ``uncertainty_sampled_points``."""
    B, Q = labels.shape
    loss_cls = softmax_cls_loss(cls_pred, labels, num_classes, cls_weight,
                                bg_cls_weight, global_sum)
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
        mp = _wide(mask_pred.reshape(B * Q, -1))
        mt = _wide(tgt_masks.reshape(B * Q, -1))
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


def invert_assignment(assigned: torch.Tensor, n_targets: int) -> torch.Tensor:
    """(B, Q) target index or -1 -> (B, N) int32 index of the query that
    took each target, or -1 (``invert_assignment``,
    ``openpvsg_tpu/train/losses.py:56``). Each target is taken by at most
    one query; unassigned queries write a discarded overflow column."""
    B, Q = assigned.shape
    tgt = torch.where(assigned >= 0, assigned, n_targets).long()
    qi = torch.arange(Q, dtype=torch.int32, device=assigned.device).expand(B, Q)
    inv = torch.full((B, n_targets + 1), -1, dtype=torch.int32,
                     device=assigned.device)
    return inv.scatter(1, tgt, qi)[:, :n_targets]


def dense_mask_losses_target_layout(assigned, mask_pred, gt_masks, gt_valid,
                                    num_total_masks, mask_weight: float = 5.0,
                                    dice_weight: float = 5.0
                                    ) -> Dict[str, torch.Tensor]:
    """Dense loss_mask / loss_dice in the target layout: assigned (B, Q),
    mask_pred (B, Q, T, H, W), gt_masks (B, N, T, H, W), gt_valid (B, N).
    The matched prediction rows are gathered to their targets; the sums are
    the query layout's, whose unmatched rows contribute exactly 0
    (``dense_mask_losses_target_layout``, ``losses.py:70-111``)."""
    B, Q = assigned.shape
    N = gt_valid.shape[1]
    inv = invert_assignment(assigned, N)
    valid = (inv >= 0) & gt_valid
    rows = inv.clamp(min=0).long()
    mp = _wide(mask_pred.reshape(B, Q, -1)[torch.arange(B, device=rows.device)[:, None], rows])
    mt = _wide(gt_masks.reshape(B, N, -1))
    P = mp.shape[-1]
    w = valid.to(mp.dtype)
    bce = mp.clamp(min=0) - mp * mt + torch.log1p(torch.exp(-mp.abs()))
    loss_mask = mask_weight * (bce * w[..., None]).sum() / (num_total_masks * P).clamp(min=1.0)
    pred = torch.sigmoid(mp)
    numer = 2.0 * (pred * mt).sum(-1)
    denom = pred.sum(-1) + mt.sum(-1)
    dice = 1.0 - (numer + 1.0) / (denom + 1.0)
    loss_dice = dice_weight * (dice * w).sum() / num_total_masks.clamp(min=1.0)
    return {"loss_mask": loss_mask, "loss_dice": loss_dice}


def focal_cls_loss(cls_pred: torch.Tensor, labels: torch.Tensor,
                   num_classes: int, gamma: float = 2.0, alpha: float = 0.25,
                   weight: float = 2.0,
                   global_sum: Optional[GlobalSum] = None) -> torch.Tensor:
    """Sigmoid focal classification loss over the K foreground logits;
    background is the all-zero one-hot, and the sum is divided by the
    number of foreground labels (at least 1) (``focal_cls_loss``,
    ``losses.py:171``)."""
    logits = _wide(cls_pred[..., :num_classes])
    onehot = F.one_hot(labels, num_classes + 1)[..., :num_classes].to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = logits.clamp(min=0) - logits * onehot + torch.log1p(torch.exp(-logits.abs()))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    a_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    num_pos = _global((labels != num_classes).sum().to(logits.dtype),
                      global_sum).clamp(min=1.0)
    return weight * loss.sum() / num_pos


def sem_seg_loss(sem_seg_logits: torch.Tensor, gt_semantic: torch.Tensor,
                 weight: float = 1.0,
                 global_sum: Optional[GlobalSum] = None) -> torch.Tensor:
    """Per-pixel softmax cross entropy of the semantic head: logits (B, T,
    H, W, K+1), gt_semantic (B, T, H, W) class ids; mean over pixels
    (``mask2former_loss``, ``losses.py:312-317``)."""
    logp = F.log_softmax(_wide(sem_seg_logits), dim=-1)
    ce = -logp.gather(-1, gt_semantic.long()[..., None])[..., 0]
    if global_sum is None:
        return weight * ce.mean()
    return weight * ce.sum() / global_sum(ce.new_full((), ce.numel()))


def mask2former_loss(cls_preds: torch.Tensor, mask_preds: torch.Tensor,
                     gt_labels: torch.Tensor, gt_masks: torch.Tensor,
                     gt_valid: torch.Tensor, num_classes: int,
                     cls_weight: float = 2.0, mask_weight: float = 5.0,
                     dice_weight: float = 5.0, bg_cls_weight: float = 0.1,
                     assigned: Optional[np.ndarray] = None,
                     num_points: int = 0, oversample_ratio: float = 3.0,
                     importance_sample_ratio: float = 0.75,
                     draw: Optional[Draw] = None, num_stuff_queries: int = 0,
                     num_things_classes: int = 0, assigner: str = "hungarian",
                     match_downsample: int = 1, loss_layout: str = "query",
                     focal: bool = False, focal_gamma: float = 2.0,
                     focal_alpha: float = 0.25,
                     sem_seg_logits: Optional[torch.Tensor] = None,
                     gt_semantic: Optional[torch.Tensor] = None,
                     sem_seg_weight: float = 1.0,
                     global_sum: Optional[GlobalSum] = None
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
    computed here with ``assigner`` and ``match_downsample``.
    ``loss_layout`` 'target' (dense only) computes the mask losses in the
    target layout; ``focal`` replaces each layer's loss_cls by the focal
    loss; the semantic loss is added when both ``sem_seg_logits`` and
    ``gt_semantic`` are given. ``global_sum`` (a sum over the ranks of a
    process group) makes the normalizers the global batch's. Returns
    (total, logs) with the JAX package's
    keys: ``loss_cls``, ``loss_mask``, ``loss_dice`` for the last layer,
    with ``.d{l}`` for the earlier ones, and ``loss_sem_seg``."""
    if loss_layout == "target" and num_points > 0:
        raise ValueError("loss_layout='target' requires dense mode "
                         "(loss_sampling='dense'): point sampling needs the "
                         "per-query layout")
    L = cls_preds.shape[0]
    num_total_masks = _global(gt_valid.sum().float(), global_sum).clamp(min=1.0)
    if assigned is None:
        assigned = hungarian_assign_layers(
            cls_preds.detach(), mask_preds.detach(), gt_labels, gt_masks,
            gt_valid, cls_weight, mask_weight, dice_weight, num_points, draw,
            num_stuff_queries, num_things_classes, assigner, match_downsample)
    assigned = torch.as_tensor(assigned, device=cls_preds.device)

    total = 0.0
    logs: Dict[str, torch.Tensor] = {}
    for layer in range(L):
        if loss_layout == "target":
            a = assigned[layer]
            pos = a >= 0
            labels = torch.where(pos, gt_labels.long().gather(1, a.clamp(min=0).long()),
                                 num_classes)
            losses = dense_mask_losses_target_layout(
                a, mask_preds[layer], gt_masks, gt_valid, num_total_masks,
                mask_weight, dice_weight)
            losses["loss_cls"] = softmax_cls_loss(
                cls_preds[layer], labels, num_classes, cls_weight, bg_cls_weight,
                global_sum)
        else:
            labels, tgt_masks, pos = gather_targets(
                assigned[layer], gt_labels, gt_masks, num_classes)
            losses = mask2former_layer_loss(
                cls_preds[layer], mask_preds[layer], labels, tgt_masks, pos,
                num_total_masks, num_classes, cls_weight, mask_weight,
                dice_weight, bg_cls_weight, num_points, oversample_ratio,
                importance_sample_ratio, draw, global_sum)
        if focal:
            losses["loss_cls"] = focal_cls_loss(
                cls_preds[layer], labels, num_classes, focal_gamma,
                focal_alpha, cls_weight, global_sum)
        total = total + sum(losses.values())
        tag = "" if layer == L - 1 else f".d{layer}"
        for k, v in losses.items():
            logs[k + tag] = v
    if sem_seg_logits is not None and gt_semantic is not None:
        loss_sem = sem_seg_loss(sem_seg_logits, gt_semantic, sem_seg_weight,
                                global_sum)
        total = total + loss_sem
        logs["loss_sem_seg"] = loss_sem
    return total, logs
