"""Relation-head losses, the port of ``openpvsg_tpu/models/relation/losses.py``
(reference: models/relation_head/train_utils.py:6-27)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def zlpr_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Multi-label log-sum-exp loss (https://kexue.fm/archives/7359).

    y_true: binary targets (..., C); y_pred: logits. Mean over the leading
    axes (train_utils.py:14-27)."""
    y_pred = (1 - 2 * y_true) * y_pred
    y_pred_neg = y_pred - y_true * 9999.0
    y_pred_pos = y_pred - (1 - y_true) * 9999.0
    zeros = torch.zeros_like(y_pred[..., :1])
    neg = torch.logsumexp(torch.cat([y_pred_neg, zeros], dim=-1), dim=-1)
    pos = torch.logsumexp(torch.cat([y_pred_pos, zeros], dim=-1), dim=-1)
    return (neg + pos).mean()


def rew_bce_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                 class_counts: torch.Tensor) -> torch.Tensor:
    """Class-frequency-reweighted BCE with logits: pos_weight =
    total_count / class_count (train_utils.py:6-11; torch
    BCEWithLogitsLoss's pos_weight)."""
    pos_weight = class_counts.sum() / class_counts
    loss = -(pos_weight * y_true * F.logsigmoid(y_pred)
             + (1 - y_true) * F.logsigmoid(-y_pred))
    return loss.mean()
