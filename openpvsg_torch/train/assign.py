"""Hungarian target assignment for Mask2Former training: the port of
``openpvsg_tpu/train/assign.py:28-76,218-328``.

  cost = 2.0 * classification cost (-softmax prob at the gt label)
       + 5.0 * sigmoid-BCE mask cost over P points
       + 5.0 * dice cost over the same points

The points are every stride-4 pixel of the clip (dense mode, P = T*H*W) or,
in points mode, ``num_points`` uniform draws per (layer, item), shared by
the Q predictions and the N targets, each clip sampled as one tall
(T*H, W) image (``_make_single``'s ``num_points > 0`` branch). With the
thing/stuff split the last ``num_stuff_queries`` queries may take only
stuff targets and the rest only things: two problems per (layer, item)
(``openpvsg_tpu/train/losses.py:187-220``).

The costs of every decoder layer and batch item are computed on the device
over padded targets (invalid ones get ``BIG_COST``), copied to the host in
one (L, B, Q, N) transfer, and solved there by the same C++ LAP as the JAX
package (``native.linear_sum_assignment``), so ties break alike.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from openpvsg_torch import native
from openpvsg_torch.ops.sampling import Draw, point_sample

BIG_COST = 1e8


def _host_lap(cost: np.ndarray) -> np.ndarray:
    """cost (Q, N) -> assigned target index per query, -1 if unassigned.
    Padded (invalid) targets carry BIG_COST and are stripped on return."""
    cost = np.asarray(cost, dtype=np.float64)
    q, _ = cost.shape
    out = np.full(q, -1, dtype=np.int32)
    ri, ci = native.linear_sum_assignment(cost)
    for i, j in zip(ri, ci):
        if cost[i, j] < BIG_COST / 2:
            out[i] = j
    return out


def classification_cost(cls_pred: torch.Tensor,
                        gt_labels: torch.Tensor) -> torch.Tensor:
    """(..., Q, K+1) logits x (..., N) labels -> (..., Q, N); mmdet
    ClassificationCost."""
    probs = torch.softmax(cls_pred, dim=-1)
    idx = gt_labels[..., None, :].expand(*probs.shape[:-1], gt_labels.shape[-1])
    return -probs.gather(-1, idx)


def mask_bce_cost(mask_pts: torch.Tensor, tgt_pts: torch.Tensor) -> torch.Tensor:
    """Pairwise mean sigmoid BCE: (..., Q, P) logits x (..., N, P) binary ->
    (..., Q, N); mmdet CrossEntropyLossCost(use_sigmoid=True)."""
    P = mask_pts.shape[-1]
    pos = F.logsigmoid(mask_pts)
    neg = F.logsigmoid(-mask_pts)
    cost = -(pos @ tgt_pts.transpose(-1, -2)
             + neg @ (1.0 - tgt_pts).transpose(-1, -2))
    return cost / P


def dice_cost(mask_pts: torch.Tensor, tgt_pts: torch.Tensor,
              eps: float = 1.0) -> torch.Tensor:
    """Pairwise dice cost with sigmoid activation (mmdet DiceCost,
    pred_act=True, naive dice): (..., Q, P) x (..., N, P) -> (..., Q, N)."""
    pred = torch.sigmoid(mask_pts)
    numer = 2.0 * (pred @ tgt_pts.transpose(-1, -2))
    denom = pred.sum(-1)[..., :, None] + tgt_pts.sum(-1)[..., None, :]
    return -(numer + eps) / (denom + eps)


def split_validity(gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                   num_queries: int, num_stuff_queries: int,
                   num_things_classes: int) -> torch.Tensor:
    """(B, N) -> (B, Q, N): which targets each query may take. Without the
    split (``num_stuff_queries`` 0) every valid one; with it, the last
    ``num_stuff_queries`` queries only stuff targets (label >=
    ``num_things_classes``), the others only things."""
    valid = gt_valid[:, None, :].expand(-1, num_queries, -1)
    if not num_stuff_queries:
        return valid
    thing_query = torch.arange(num_queries, device=gt_valid.device) < (
        num_queries - num_stuff_queries)
    thing_target = gt_labels < num_things_classes
    return valid & (thing_query[None, :, None] == thing_target[:, None, :])


def _tall_points(masks: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """masks (B, C, T, H, W) -> (B, C, P): each clip sampled as one tall
    (T*H, W) image at its item's points (B, P, 2), shared by its C masks
    (the channels of ``point_sample``)."""
    B, C, W = masks.shape[0], masks.shape[1], masks.shape[-1]
    return point_sample(masks.reshape(B, C, -1, W).permute(0, 2, 3, 1),
                        points).transpose(1, 2)


@torch.no_grad()
def assignment_costs(cls_preds: torch.Tensor, mask_preds: torch.Tensor,
                     gt_labels: torch.Tensor, gt_masks: torch.Tensor,
                     gt_valid: torch.Tensor, cls_weight: float = 2.0,
                     mask_weight: float = 5.0, dice_weight: float = 5.0,
                     num_points: int = 0, draw: Optional[Draw] = None,
                     num_stuff_queries: int = 0,
                     num_things_classes: int = 0) -> torch.Tensor:
    """cls_preds (L, B, Q, K+1), mask_preds (L, B, Q, T, H, W) logits,
    gt_labels (B, N), gt_masks (B, N, T, Hm, Wm) binary, gt_valid (B, N) ->
    the (L, B, Q, N) float32 cost, ``BIG_COST`` where a query may not take
    a target (``split_validity``). Dense (``num_points`` 0): clip masks are
    matched over all T*H*W pixels at once, at the prediction's resolution.
    Points: one ``draw`` of (L, B, num_points, 2), and the predictions and
    the targets are sampled there. One layer at a time."""
    L, B, Q = cls_preds.shape[:3]
    N = gt_labels.shape[1]
    valid = split_validity(gt_labels, gt_valid, Q, num_stuff_queries,
                           num_things_classes)
    if num_points > 0:
        if draw is None:
            raise ValueError("points mode (num_points > 0) needs a draw")
        points = draw((L, B, num_points, 2))
    else:
        tgt = gt_masks.reshape(B, N, -1).float()
    out = []
    for layer in range(L):
        if num_points > 0:
            mp = _tall_points(mask_preds[layer], points[layer])
            tgt = _tall_points(gt_masks, points[layer])
        else:
            mp = mask_preds[layer].reshape(B, Q, -1).float()
        cost = (cls_weight * classification_cost(cls_preds[layer].float(),
                                                 gt_labels)
                + mask_weight * mask_bce_cost(mp, tgt)
                + dice_weight * dice_cost(mp, tgt))
        out.append(torch.where(valid, cost, BIG_COST))
    return torch.stack(out)


def lap_assign(costs: np.ndarray, num_stuff_queries: int = 0) -> np.ndarray:
    """Host LAP of every (layer, item): (L, B, Q, N) cost -> (L, B, Q)
    int32 target index per query, -1 where unassigned. With the split, the
    thing queries and the last ``num_stuff_queries`` are two problems."""
    L, B, Q, _ = costs.shape
    blocks = ([slice(0, Q - num_stuff_queries), slice(Q - num_stuff_queries, Q)]
              if num_stuff_queries else [slice(0, Q)])
    out = np.empty((L, B, Q), dtype=np.int32)
    for layer in range(L):
        for b in range(B):
            for rows in blocks:
                out[layer, b, rows] = _host_lap(costs[layer, b, rows])
    return out


def hungarian_assign_layers(cls_preds, mask_preds, gt_labels, gt_masks,
                            gt_valid, cls_weight: float = 2.0,
                            mask_weight: float = 5.0,
                            dice_weight: float = 5.0, num_points: int = 0,
                            draw: Optional[Draw] = None,
                            num_stuff_queries: int = 0,
                            num_things_classes: int = 0) -> np.ndarray:
    """All decoder layers' assignments -> (L, B, Q) int32 on the host: the
    costs on the device, one copy, the LAPs on the host."""
    costs = assignment_costs(cls_preds, mask_preds, gt_labels, gt_masks,
                             gt_valid, cls_weight, mask_weight, dice_weight,
                             num_points, draw, num_stuff_queries,
                             num_things_classes)
    return lap_assign(costs.cpu().numpy(), num_stuff_queries)
