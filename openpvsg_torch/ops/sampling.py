"""Sampling primitives, the port of ``openpvsg_tpu/ops/sampling.py``:

- ``grid_sample`` / ``point_sample``: bilinear
  sampling at fractional locations with zero padding (reference:
  mmcv.ops.point_sample; the point-rend loss of
  models/mask2former/mask2former_head.py:184-293);
- ``ms_deform_attn``: the multi-scale deformable attention core (reference:
  mmcv's MultiScaleDeformableAttention, the MSDA pixel encoder);
- ``uncertainty_sampled_points``: importance sampling of uncertain points
  (mmcv get_uncertain_point_coords_with_randomness).

The JAX package computes these as plain jitted JAX (4-tap gathers), not
as Pallas kernels; here they are ``F.grid_sample`` (bilinear,
``padding_mode='zeros'``, ``align_corners=False``), which needs no index
tensors: a normalized location p in [0, 1] maps to the pixel coordinate
p * size - 0.5, points are (x, y). Sampling runs in float32 for bfloat16
and float32 inputs, as the JAX taps promote to float32 weights (float64
stays float64).

Random draws come through a ``Draw``, a callable taking a shape and
returning uniform [0, 1) float32 values on the caller's device:
``uniform_draw(generator)`` draws from an explicit ``torch.Generator``;
tests pass a source that replays the JAX package's threefry draws.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

Draw = Callable[[Tuple[int, ...]], torch.Tensor]


def uniform_draw(generator: torch.Generator) -> Draw:
    """Uniform [0, 1) float32 draws on ``generator``'s device."""
    return lambda shape: torch.rand(tuple(shape), generator=generator,
                                    device=generator.device)


def rank_draw(draw: Draw, rank: int, world: int) -> Draw:
    """The draws of one rank's contiguous block of a global batch split over
    ``world`` ranks: each call draws the global batch's shape from ``draw``
    and keeps this rank's slice, so the ranks together use exactly the
    draws one process makes on the global batch. The batch axis is 1 of the
    assignment's (L, B, P, 2) draw and 0 of a layer's (B * Q, k, 2) ones
    (items major)."""
    def sliced(shape):
        axis = 1 if len(shape) == 4 else 0
        full = list(shape)
        full[axis] *= world
        n = shape[axis]
        return draw(tuple(full)).narrow(axis, rank * n, n).contiguous()

    return sliced


def _sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """img (N, C, H, W), grid (N, P, 2) in [-1, 1] (x, y) -> (N, C, P), in
    float32 (float64 for float64 images)."""
    dtype = torch.promote_types(img.dtype, torch.float32)
    return F.grid_sample(img.to(dtype), grid.to(dtype)[:, None], mode="bilinear",
                         padding_mode="zeros", align_corners=False)[:, :, 0]


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``F.grid_sample`` (bilinear, zeros padding, align_corners=False) on
    channels-last tensors: img (B, H, W, C), grid (B, ..., 2) in [-1, 1]
    (x, y) -> (B, ..., C), float32 or wider."""
    B, C = img.shape[0], img.shape[3]
    out = _sample(img.permute(0, 3, 1, 2), grid.reshape(B, -1, 2))
    return out.transpose(1, 2).reshape(*grid.shape[:-1], C)


def point_sample(feats: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """mmcv.ops.point_sample on channels-last tensors: feats (B, H, W, C),
    points (B, P, 2) normalized [0, 1] (x, y) -> (B, P, C), float32 or
    wider."""
    return grid_sample(feats, points * 2.0 - 1.0)


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention aggregation.

    value (B, S, heads, head_dim) with S = sum(h_l * w_l);
    sampling_locations (B, Q, heads, levels, points, 2) in [0, 1];
    attention_weights (B, Q, heads, levels, points), softmaxed over
    (levels * points). Returns (B, Q, heads * head_dim), float32 or wider
    (mmcv's multi_scale_deform_attn_pytorch)."""
    B, S, nh, hd = value.shape
    Q, P = sampling_locations.shape[1], sampling_locations.shape[4]
    if sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"spatial shapes {spatial_shapes} disagree with S={S}")
    out = None
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(B * nh, hd, h, w)
        start += h * w
        grid = 2.0 * sampling_locations[:, :, :, lvl] - 1.0  # (B, Q, nh, P, 2)
        grid = grid.transpose(1, 2).reshape(B * nh, Q * P, 2)
        sampled = _sample(v, grid).reshape(B * nh, hd, Q, P)
        wgt = attention_weights[:, :, :, lvl].transpose(1, 2).reshape(B * nh, 1, Q, P)
        term = (sampled * wgt.to(sampled.dtype)).sum(-1)  # (B*nh, hd, Q)
        out = term if out is None else out + term
    return out.reshape(B, nh * hd, Q).transpose(1, 2)


def calculate_uncertainty(logits: torch.Tensor) -> torch.Tensor:
    """-|logit|: the distance from the 0.5 decision boundary (mmdet's
    point-rend uncertainty for single-channel mask logits)."""
    return -logits.abs()


def top_k_indices(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values along the last axis, as
    ``lax.top_k`` picks them: the lower index first among equal values
    (``torch.topk`` guarantees no order among ties)."""
    return torch.sort(-values, dim=-1, stable=True).indices[..., :k]


def uncertainty_sampled_points(draw: Draw, mask_logits: torch.Tensor,
                               num_points: int, oversample_ratio: float = 3.0,
                               importance_sample_ratio: float = 0.75
                               ) -> torch.Tensor:
    """Point-rend sampling of training points, biased to uncertain regions
    (mmcv get_uncertain_point_coords_with_randomness, used at
    mask2former_head.py:284-293): mask_logits (N, H, W) -> (N, P, 2) in
    [0, 1]. Two draws: the (N, P * oversample_ratio, 2) candidates, then
    the (N, P - P * importance_sample_ratio, 2) random points."""
    n = mask_logits.shape[0]
    n_sampled = int(num_points * oversample_ratio)
    n_unc = int(importance_sample_ratio * num_points)
    cand = draw((n, n_sampled, 2))
    logits = point_sample(mask_logits[..., None], cand)[..., 0]  # (N, n_sampled)
    idx = top_k_indices(calculate_uncertainty(logits), n_unc)
    unc_points = cand.gather(1, idx[..., None].expand(-1, -1, 2))
    rand_points = draw((n, num_points - n_unc, 2))
    return torch.cat([unc_points, rand_points], dim=1)
