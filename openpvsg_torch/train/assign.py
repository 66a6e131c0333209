"""Hungarian target assignment for Mask2Former training, dense mode: the
port of ``openpvsg_tpu/train/assign.py:28-76,218-328``.

  cost = 2.0 * classification cost (-softmax prob at the gt label)
       + 5.0 * sigmoid-BCE mask cost over all P = T*H*W pixels
       + 5.0 * dice cost over the same pixels

The costs of every decoder layer and batch item are computed on the device
over padded targets (invalid ones get ``BIG_COST``), copied to the host in
one (L, B, Q, N) transfer, and solved there by the same C++ LAP as the JAX
package (``native.linear_sum_assignment``), so ties break alike. The JAX
package's per-(layer, item) rng and lockstep batching serve its point
sampling and device assigners, which dense host matching does not need.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from openpvsg_torch import native

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


@torch.no_grad()
def assignment_costs(cls_preds: torch.Tensor, mask_preds: torch.Tensor,
                     gt_labels: torch.Tensor, gt_masks: torch.Tensor,
                     gt_valid: torch.Tensor, cls_weight: float = 2.0,
                     mask_weight: float = 5.0,
                     dice_weight: float = 5.0) -> torch.Tensor:
    """cls_preds (L, B, Q, K+1), mask_preds (L, B, Q, T, H, W) logits,
    gt_labels (B, N), gt_masks (B, N, T, H, W) binary, gt_valid (B, N) ->
    the (L, B, Q, N) float32 cost, ``BIG_COST`` at invalid targets. Clip
    masks are matched over all T*H*W pixels at once, one layer at a time."""
    L, B, Q = cls_preds.shape[:3]
    N = gt_labels.shape[1]
    tgt = gt_masks.reshape(B, N, -1).float()
    out = []
    for layer in range(L):
        mp = mask_preds[layer].reshape(B, Q, -1).float()
        cost = (cls_weight * classification_cost(cls_preds[layer].float(),
                                                 gt_labels)
                + mask_weight * mask_bce_cost(mp, tgt)
                + dice_weight * dice_cost(mp, tgt))
        out.append(torch.where(gt_valid[:, None, :], cost, BIG_COST))
    return torch.stack(out)


def lap_assign(costs: np.ndarray) -> np.ndarray:
    """Host LAP of every (layer, item): (L, B, Q, N) cost -> (L, B, Q)
    int32 target index per query, -1 where unassigned."""
    L, B, Q, _ = costs.shape
    out = np.empty((L, B, Q), dtype=np.int32)
    for layer in range(L):
        for b in range(B):
            out[layer, b] = _host_lap(costs[layer, b])
    return out


def hungarian_assign_layers(cls_preds, mask_preds, gt_labels, gt_masks,
                            gt_valid, cls_weight: float = 2.0,
                            mask_weight: float = 5.0,
                            dice_weight: float = 5.0) -> np.ndarray:
    """All decoder layers' assignments -> (L, B, Q) int32 on the host: the
    costs on the device, one copy, the LAPs on the host."""
    costs = assignment_costs(cls_preds, mask_preds, gt_labels, gt_masks,
                             gt_valid, cls_weight, mask_weight, dice_weight)
    return lap_assign(costs.cpu().numpy())
