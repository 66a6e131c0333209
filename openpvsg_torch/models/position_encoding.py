"""Sine positional encodings, channels last: the 2-D one (mmdet
SinePositionalEncoding, num_feats=128, normalize=True, all-valid mask) that
every T=1 forward uses, the 3-D one of the reference's
SinePositionalEncoding3D for clips (training runs T=2), and the 1-D one of
the relation head's temporal transformer, as in
``openpvsg_tpu/models/position_encoding.py``.
"""
from __future__ import annotations

import math

import torch


def _interleave_sincos(embed: torch.Tensor, num_feats: int,
                       temperature: float) -> torch.Tensor:
    """embed (...,) -> (..., num_feats) as [sin(e/t0), cos(e/t1), ...] with
    t_{2i} = t_{2i+1} = temperature^(2i/num_feats)."""
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=embed.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_feats)
    pos = embed[..., None] / dim_t
    sin = torch.sin(pos[..., 0::2])
    cos = torch.cos(pos[..., 1::2])
    return torch.stack([sin, cos], dim=-1).reshape(*embed.shape, num_feats)


def sine_pos_encoding(h: int, w: int, num_feats: int = 128,
                      temperature: float = 10000.0, normalize: bool = True,
                      scale: float = 2 * math.pi, eps: float = 1e-6,
                      offset: float = 0.0, device=None) -> torch.Tensor:
    """-> (H, W, 2*num_feats) float32, channels = concat(pos_y, pos_x)."""
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None]
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :]
    y = y.expand(h, w)
    x = x.expand(h, w)
    if normalize:
        y = (y + offset) / (h + eps) * scale
        x = (x + offset) / (w + eps) * scale
    pos_y = _interleave_sincos(y, num_feats, temperature)
    pos_x = _interleave_sincos(x, num_feats, temperature)
    return torch.cat([pos_y, pos_x], dim=-1)


def sine_pos_encoding_3d(t: int, h: int, w: int, num_feats: int = 128,
                         temperature: float = 10000.0, normalize: bool = True,
                         scale: float = 2 * math.pi, eps: float = 1e-6,
                         offset: float = 0.0, device=None) -> torch.Tensor:
    """-> (T, H, W, 2*num_feats) float32: concat(pos_y, pos_x) + pos_z,
    where pos_z spans all 2*num_feats channels."""
    pos2d = sine_pos_encoding(h, w, num_feats, temperature, normalize, scale,
                              eps, offset, device=device)
    z = torch.arange(1, t + 1, dtype=torch.float32, device=device)
    if normalize:
        z = (z + offset) / (t + eps) * scale
    pos_z = _interleave_sincos(z, 2 * num_feats, temperature)  # (T, 2F)
    return pos2d[None, :, :, :] + pos_z[:, None, None, :]


def sine_embed_1d(length: int, dim: int, temperature: float = 10000.0,
                  device=None) -> torch.Tensor:
    """Classic unnormalized transformer encoding over positions
    0..length-1 -> (length, dim) float32 (reference:
    models/relation_head/transformer.py:7-30)."""
    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(temperature) / dim))
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div[: (dim + 1) // 2])
    return pe
