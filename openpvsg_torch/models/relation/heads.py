"""Relation-head models, the port of ``openpvsg_tpu/models/relation/heads.py``
(reference: models/relation_head/base.py, transformer.py, convolution.py).

- ObjectEncoder: 2-layer post-norm transformer encoder (d 256, 8 heads, ffn
  512). The reference feeds (N_tubes, T, 256) to a torch encoder that is
  not batch-first, so attention runs across tubes, separately for each
  frame (base.py:39-40); so does this one.
- PairProposalNetwork: MLP(concat(s_i, o_j)) for every pair, as the rank-1
  split relu(s_i W_s + o_j W_o + b) with the first layer's kernel kept as
  one raw (2D, H) parameter in flax layout.
- VanillaModel / HandcraftedFilter / Learnable1DConv / TemporalTransformer:
  per-pair temporal models giving span logits (P, T, R) and max-pooled
  relation logits (P, R) through the shared ``_PredHeads`` stack.

Module and parameter names follow the flax names, so
``weights.relation_from_jax_params`` is a mechanical walk. Every LayerNorm
runs at flax's eps 1e-6. Padded tubes and frames are excluded with the
float32 minimum (not -inf), as the JAX ``jnp.where(mask, x, finfo.min)``
does: a padded query row still attends to the valid keys.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from openpvsg_torch.models.position_encoding import sine_embed_1d
from openpvsg_torch.models.transformer_decoder import LN_EPS, MultiheadAttention

_NEG = torch.finfo(torch.float32).min


class TorchEncoderLayer(nn.Module):
    """torch.nn.TransformerEncoderLayer semantics: post-norm, relu FFN.
    ``mask`` (broadcastable to (B, L, L), True = may attend) keeps padded
    keys out of every attention."""

    def __init__(self, d_model: int, num_heads: int, dim_ff: int):
        super().__init__()
        self.self_attn = MultiheadAttention(num_heads, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        x = self.norm1(x + self.self_attn(x, x, x, mask=mask))
        y = self.linear2(F.relu(self.linear1(x)))
        return self.norm2(x + y)


class ObjectEncoder(nn.Module):
    def __init__(self, feature_dim: int = 256, hidden_dim: int = 512,
                 num_heads: int = 8, num_layers: int = 2):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TorchEncoderLayer(
                feature_dim, num_heads, hidden_dim))
        self.num_layers = num_layers

    def forward(self, feats, tube_valid: Optional[torch.Tensor] = None):
        """feats (N_tubes, T, D) -> (N_tubes, T, D), attention across the
        tube axis per frame; tube_valid (N_tubes,) bool excludes padded
        tubes as keys."""
        x = feats.transpose(0, 1)  # (T, N, D): frames as the batch
        mask = None if tube_valid is None else tube_valid[None, None, :]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask=mask)
        return x.transpose(0, 1)


class PairProposalNetwork(nn.Module):
    def __init__(self, feature_dim: int = 256, hidden_dim: int = 1024):
        super().__init__()
        self.feature_dim = feature_dim
        # flax layout (2D, H), used as sub @ w[:D] + obj @ w[D:]
        self.fc1_kernel = nn.Parameter(torch.empty(2 * feature_dim, hidden_dim))
        self.fc1_bias = nn.Parameter(torch.zeros(hidden_dim))
        self.fc2 = nn.Linear(hidden_dim, 1)

    def forward(self, encoded_subjects, encoded_objects,
                frame_valid: Optional[torch.Tensor] = None):
        """(N, T, D) x2 -> (N, N) pair logits with a zero diagonal (the
        reference never fills i == j); frame_valid (T,) keeps padded frames
        out of the temporal max."""
        if frame_valid is not None:
            fv = frame_valid[None, :, None]
            encoded_subjects = encoded_subjects.masked_fill(~fv, _NEG)
            encoded_objects = encoded_objects.masked_fill(~fv, _NEG)
        sub = encoded_subjects.amax(dim=1)  # (N, D)
        obj = encoded_objects.amax(dim=1)
        d = self.feature_dim
        a_s = sub @ self.fc1_kernel[:d]
        a_o = obj @ self.fc1_kernel[d:]
        hidden = F.relu(a_s[:, None, :] + a_o[None, :, :] + self.fc1_bias)
        score = self.fc2(hidden)[..., 0]
        n = score.shape[0]
        return score * (1.0 - torch.eye(n, dtype=score.dtype, device=score.device))


class _PredHeads(nn.Module):
    """The fc1-fc2-span/pred stack every temporal model ends in;
    frame_valid (T,) keeps padded frames out of the relation max."""

    def __init__(self, input_dim: int, num_relations: int):
        super().__init__()
        self.fc1 = nn.Linear(input_dim, input_dim // 2)
        self.fc2 = nn.Linear(input_dim // 2, input_dim // 4)
        self.span_head = nn.Linear(input_dim // 4, num_relations)
        self.pred_head = nn.Linear(input_dim // 4, num_relations)

    def forward(self, x, frame_valid: Optional[torch.Tensor] = None):
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        span = self.span_head(x)
        pred = self.pred_head(x)
        if frame_valid is not None:
            pred = pred.masked_fill(~frame_valid[None, :, None], _NEG)
        return span, pred.amax(dim=1)


class VanillaModel(nn.Module):
    def __init__(self, input_dim: int = 512, num_relations: int = 57):
        super().__init__()
        self.heads = _PredHeads(input_dim, num_relations)

    def forward(self, x, frame_valid=None):
        """x (P, T, 2D) -> (span (P, T, R), relation (P, R))."""
        return self.heads(x, frame_valid)


class TemporalTransformer(nn.Module):
    def __init__(self, input_dim: int = 512, num_relations: int = 57,
                 num_layers: int = 1, num_heads: int = 4, dim_ff: int = 512):
        super().__init__()
        self.input_dim = input_dim
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TorchEncoderLayer(
                input_dim, num_heads, dim_ff))
        self.final_norm = nn.LayerNorm(input_dim, eps=LN_EPS)
        self.heads = _PredHeads(input_dim, num_relations)

    def forward(self, x, frame_valid=None):
        """x (P, T, 2D); frame_valid (T,) masks padded frames out of the
        temporal attention and the relation max."""
        T = x.shape[1]
        x = x + sine_embed_1d(T, self.input_dim, device=x.device).to(x.dtype)[None]
        mask = None if frame_valid is None else frame_valid[None, None, :]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask=mask)
        return self.heads(self.final_norm(x), frame_valid)


class HandcraftedFilter(nn.Module):
    """Fixed binomial temporal smoothing (kernel [1/4, 1/2, 1, 1/2, 1/4],
    zero padding) before the heads."""

    def __init__(self, input_dim: int = 512, num_relations: int = 57):
        super().__init__()
        self.heads = _PredHeads(input_dim, num_relations)

    def forward(self, x, frame_valid=None):
        kernel = (0.25, 0.5, 1.0, 0.5, 0.25)
        xp = F.pad(x, (0, 0, 2, 2))
        T = x.shape[1]
        out = sum(kernel[i] * xp[:, i:i + T, :] for i in range(5))
        return self.heads(out, frame_valid)


class Learnable1DConv(nn.Module):
    def __init__(self, input_dim: int = 512, num_relations: int = 57,
                 kernel_size: int = 5, num_layers: int = 1):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"conv_{i}", nn.Conv1d(
                input_dim, input_dim, kernel_size, padding=kernel_size // 2))
        self.heads = _PredHeads(input_dim, num_relations)

    def forward(self, x, frame_valid=None):
        x = x.transpose(1, 2)  # (P, C, T)
        for i in range(self.num_layers):
            x = F.relu(getattr(self, f"conv_{i}")(x))
        return self.heads(x.transpose(1, 2), frame_valid)


class RelationModel(nn.Module):
    """Subject and object encoders, the pair proposal network and one
    temporal model (reference: the 4-model bundle of tools/rel_train.py).
    The capacity knobs default to the reference's fixed hyperparameters;
    ``pair_interaction`` (beyond the reference) feeds [s, o, s-o, s*o]
    instead of [s, o] to the temporal model."""

    def __init__(self, model_name: str = "transformer", feature_dim: int = 256,
                 pair_hidden: int = 1024, num_relations: int = 57,
                 encoder_layers: int = 2, encoder_heads: int = 8,
                 encoder_ffn: int = 512, temporal_layers: int = 1,
                 temporal_heads: int = 4, temporal_ffn: int = 512,
                 conv_kernel: int = 5, pair_interaction: bool = False):
        super().__init__()
        self.model_name = model_name
        self.pair_interaction = pair_interaction
        self.subject_encoder = ObjectEncoder(feature_dim, encoder_ffn,
                                             encoder_heads, encoder_layers)
        self.object_encoder = ObjectEncoder(feature_dim, encoder_ffn,
                                            encoder_heads, encoder_layers)
        self.pair_proposal = PairProposalNetwork(feature_dim, pair_hidden)
        in_mult = 4 if pair_interaction else 2
        self.temporal = build_relation_model(
            model_name, in_mult * feature_dim, num_relations,
            num_layers=temporal_layers, num_heads=temporal_heads,
            dim_ff=temporal_ffn, kernel_size=conv_kernel)

    @classmethod
    def from_config(cls, cfg, model_name: Optional[str] = None) -> "RelationModel":
        """Build from a ``RelationHeadConfig``, honoring every capacity knob."""
        return cls(model_name=model_name or cfg.model_name,
                   feature_dim=cfg.d_model,
                   num_relations=cfg.num_relations,
                   encoder_layers=cfg.encoder_layers,
                   encoder_heads=cfg.encoder_heads,
                   encoder_ffn=cfg.encoder_ffn,
                   temporal_layers=cfg.temporal_layers,
                   temporal_heads=cfg.temporal_heads,
                   temporal_ffn=cfg.temporal_ffn,
                   conv_kernel=cfg.conv_kernel,
                   pair_interaction=cfg.pair_interaction)

    def encode(self, feats, tube_valid=None):
        return (self.subject_encoder(feats, tube_valid),
                self.object_encoder(feats, tube_valid))

    def propose_pairs(self, sub_feats, obj_feats, frame_valid=None):
        return self.pair_proposal(sub_feats, obj_feats, frame_valid)

    def predict(self, pair_feats, frame_valid=None):
        if self.pair_interaction:
            s, o = torch.chunk(pair_feats, 2, dim=-1)
            pair_feats = torch.cat([pair_feats, s - o, s * o], dim=-1)
        return self.temporal(pair_feats, frame_valid)

    def forward(self, feats, pair_feats=None, tube_valid=None,
                frame_valid=None):
        sub_feats, obj_feats = self.encode(feats, tube_valid)
        pred_matrix = self.propose_pairs(sub_feats, obj_feats, frame_valid)
        out = {"sub_feats": sub_feats, "obj_feats": obj_feats,
               "pred_matrix": pred_matrix}
        if pair_feats is not None:
            span, prob = self.predict(pair_feats, frame_valid)
            out.update(span_pred=span, prob=prob)
        return out


def build_relation_model(name: str, input_dim: int, num_relations: int,
                         num_layers: int = 1, num_heads: int = 4,
                         dim_ff: int = 512, kernel_size: int = 5) -> nn.Module:
    if name == "vanilla":
        return VanillaModel(input_dim, num_relations)
    if name == "filter":
        return HandcraftedFilter(input_dim, num_relations)
    if name == "conv":
        return Learnable1DConv(input_dim, num_relations, kernel_size, num_layers)
    if name == "transformer":
        return TemporalTransformer(input_dim, num_relations, num_layers,
                                   num_heads, dim_ff)
    raise ValueError(f"Model {name} unsupported")
