"""Masked-attention decoder layer, the port of
``openpvsg_tpu/models/transformer_decoder.py:29,64,77``.

Per layer: masked cross-attention over the level's tokens -> LayerNorm,
self-attention over the queries -> LayerNorm, FFN -> LayerNorm (eps 1e-6).
Attention logits and softmax run in float32; a masked logit is set to the
float32 minimum, as the JAX ``jnp.where(mask, logits, finfo.min)`` does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from openpvsg_torch.config import TransformerDecoderConfig
from openpvsg_torch.models.layers import Dense, LayerNorm

LN_EPS = 1e-6


class MultiheadAttention(nn.Module):
    """MHA with q/k/v/out projections and an optional boolean mask
    (True = may attend)."""

    def __init__(self, num_heads: int, dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.dim = dim
        self.q_proj = Dense(dim, dim)
        self.k_proj = Dense(dim, dim)
        self.v_proj = Dense(dim, dim)
        self.out_proj = Dense(dim, dim)

    def forward(self, q, k, v, mask: Optional[torch.Tensor] = None):
        H = self.num_heads
        hd = self.dim // H
        B, Lq, _ = q.shape
        Lk = k.shape[1]
        qp = self.q_proj(q).reshape(B, Lq, H, hd).float()
        kp = self.k_proj(k).reshape(B, Lk, H, hd).float()
        vp = self.v_proj(v).reshape(B, Lk, H, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", qp, kp) / math.sqrt(hd)
        if mask is not None:
            if mask.dim() == 3:  # (B, Lq, Lk) -> broadcast over heads
                mask = mask[:, None]
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        attn = torch.softmax(logits, dim=-1).to(vp.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vp).reshape(B, Lq, self.dim)
        return self.out_proj(out)


class DecoderFFN(nn.Module):
    def __init__(self, hidden: int, dim: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x):
        return x + self.fc2(F.relu(self.fc1(x)))


class MaskedDecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerDecoderConfig):
        super().__init__()
        C = cfg.feat_channels
        self.cross_attn = MultiheadAttention(cfg.num_heads, C)
        self.norm1 = LayerNorm(C, eps=LN_EPS)
        self.self_attn = MultiheadAttention(cfg.num_heads, C)
        self.norm2 = LayerNorm(C, eps=LN_EPS)
        self.ffn = DecoderFFN(cfg.ffn_channels, C)
        self.norm3 = LayerNorm(C, eps=LN_EPS)

    def forward(self, query, query_pos, feat, feat_pos, attn_mask):
        """query: (B, Q, C); feat: (B, S, C); attn_mask: (B, Q, S) bool
        (True = attend)."""
        x = self.cross_attn(query + query_pos, feat + feat_pos, feat,
                            mask=attn_mask)
        query = self.norm1(query + x)
        qp = query + query_pos
        query = self.norm2(query + self.self_attn(qp, qp, query))
        return self.norm3(self.ffn(query))
