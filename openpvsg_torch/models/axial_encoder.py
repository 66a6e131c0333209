"""Axial-attention multi-scale encoder of the pixel decoder, the port of
``openpvsg_tpu/models/axial_encoder.py``.

Per layer and level (weights shared across levels): row attention along W,
column attention along H, FFN, each followed by LayerNorm (eps 1e-6, the flax
default); then a top-down cross-scale pass adds a linear map of the
upsampled coarser level to each finer level (``mix_{layer}_{i}``).
Tensors are channels last (B, H, W, C). Attention logits and softmax run in
float32 whatever the compute dtype, as the JAX einsums do
(``preferred_element_type=float32``).
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from openpvsg_torch.config import PixelDecoderConfig
from openpvsg_torch.models.layers import Dense, LayerNorm
from openpvsg_torch.models.position_encoding import sine_pos_encoding
from openpvsg_torch.ops.resize import resize_bilinear

LN_EPS = 1e-6


class AxisMHA(nn.Module):
    """Multi-head attention over one spatial axis of a (B, H, W, C) tensor:
    axis=2 attends along W (rows), axis=1 along H (columns)."""

    def __init__(self, num_heads: int, dim: int, axis: int):
        super().__init__()
        self.num_heads = num_heads
        self.dim = dim
        self.axis = axis
        self.q_proj = Dense(dim, dim)
        self.k_proj = Dense(dim, dim)
        self.v_proj = Dense(dim, dim)
        self.out_proj = Dense(dim, dim)

    def forward(self, qk: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        nh = self.num_heads
        hd = self.dim // nh
        B, H, W, _ = qk.shape
        qp = self.q_proj(qk).reshape(B, H, W, nh, hd).float()
        kp = self.k_proj(qk).reshape(B, H, W, nh, hd).float()
        vp = self.v_proj(v).reshape(B, H, W, nh, hd)
        if self.axis == 2:  # along W: (B, H) are batch dims
            logits = torch.einsum("bhqnd,bhknd->bhnqk", qp, kp)
            attn = torch.softmax(logits / math.sqrt(hd), dim=-1)
            out = torch.einsum("bhnqk,bhknd->bhqnd", attn.to(vp.dtype), vp)
        else:  # along H: (B, W) are batch dims
            logits = torch.einsum("bqwnd,bkwnd->bwnqk", qp, kp)
            attn = torch.softmax(logits / math.sqrt(hd), dim=-1)
            out = torch.einsum("bwnqk,bkwnd->bqwnd", attn.to(vp.dtype), vp)
        return self.out_proj(out.reshape(B, H, W, self.dim))


class AxialAttentionBlock(nn.Module):
    def __init__(self, num_heads: int, dim: int, ffn_dim: int):
        super().__init__()
        self.row_attn = AxisMHA(num_heads, dim, axis=2)
        self.norm_row = LayerNorm(dim, eps=LN_EPS)
        self.col_attn = AxisMHA(num_heads, dim, axis=1)
        self.norm_col = LayerNorm(dim, eps=LN_EPS)
        self.ffn_fc1 = Dense(dim, ffn_dim)
        self.ffn_fc2 = Dense(ffn_dim, dim)
        self.norm_ffn = LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C); pos: (1, H, W, C)."""
        x = self.norm_row(x + self.row_attn(x + pos, x))
        x = self.norm_col(x + self.col_attn(x + pos, x))
        y = self.ffn_fc2(F.relu(self.ffn_fc1(x)))
        return self.norm_ffn(x + y)


class AxialPixelEncoder(nn.Module):
    """Takes the projected levels [stride32, stride16, stride8], each
    (B, h, w, C), and returns the enhanced levels in the same order."""

    def __init__(self, cfg: PixelDecoderConfig):
        super().__init__()
        C = cfg.feat_channels
        n = cfg.num_levels
        self.num_layers = cfg.encoder_layers
        self.level_embed = nn.Parameter(torch.zeros(n, C))
        for layer in range(cfg.encoder_layers):
            self.add_module(f"layer_{layer}", AxialAttentionBlock(
                cfg.num_heads, C, cfg.ffn_channels))
            for i in range(1, n):
                self.add_module(f"mix_{layer}_{i}", Dense(C, C))

    def forward(self, levels: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        C = self.level_embed.shape[1]
        dtype = levels[0].dtype
        poss = [sine_pos_encoding(f.shape[1], f.shape[2], num_feats=C // 2,
                                  device=f.device).to(dtype)[None]
                for f in levels]
        xs = [f + self.level_embed[i] for i, f in enumerate(levels)]
        for layer in range(self.num_layers):
            block = getattr(self, f"layer_{layer}")
            xs = [block(x, p) for x, p in zip(xs, poss)]
            # top-down cross-scale fusion: levels are ordered coarse -> fine
            mixed = [xs[0]]
            for i in range(1, len(xs)):
                up = resize_bilinear(mixed[i - 1], xs[i].shape[1:3])
                mixed.append(xs[i] + getattr(self, f"mix_{layer}_{i}")(up))
            xs = mixed
        return xs
