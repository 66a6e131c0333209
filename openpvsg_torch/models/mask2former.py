"""Mask2Former segmenter, the port of
``openpvsg_tpu/models/mask2former.py:34-226``.

Backbone (ResNet or Swin, ``backbone.kind``) -> pixel decoder ->
masked-attention head, with the optional per-pixel semantic head
(``with_sem_seg``: a 1x1 conv to K+1 classes on the mask features). Features carry a time
axis T; the decoder attends over the flattened (T*h*w) tokens of each level
with the 2-D sine encoding for T=1 and the 3-D one for clips.

- Inference (``train=False``, stage 2): every frame runs with T=1 (stage 2
  stitches frames with MinVIS afterwards) and the head emits mask logits for
  the final layer only; the intermediate layers need only their attention
  masks, computed from the mask features pre-resized to each level (resize
  is linear, so this equals resizing the full-resolution logits).
- Training (``train=True``, stage 1): (B, T) clips, training-mode
  BatchNorm for 'sync_bn', the unfused stride-4 chain and Swin's plain
  window attention, and mask logits for every layer (deep supervision).

A query whose mask blocks every token attends everywhere
(``openpvsg_tpu/models/mask2former.py:129-135``). The mask logits
accumulate in float32 and are stored in ``mask_logits_dtype`` (bfloat16
halves the training step's largest tensor), in both forwards.

Compute dtype: the serving model is cast whole (``SegmenterInference``'s
``dtype``). The bfloat16 trainer keeps float32 parameters and sets the
layers' ``compute_dtype`` (``models/layers.py``), as flax's
``Mask2Former(dtype=bfloat16)`` computes: the activations are bfloat16, the
norms take float32 statistics, the attention logits and softmaxes, the
mask logits and the MSDA locations are float32, and the query
embeddings and positional encodings are cast to bfloat16.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from openpvsg_torch.config import Mask2FormerConfig
from openpvsg_torch.models.layers import Conv, Dense, GroupNorm, LayerNorm
from openpvsg_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from openpvsg_torch.models.position_encoding import (sine_pos_encoding,
                                                     sine_pos_encoding_3d)
from openpvsg_torch.models.resnet import ResNet
from openpvsg_torch.models.swin import SwinTransformer, swin_window
from openpvsg_torch.models.transformer_decoder import MaskedDecoderLayer
from openpvsg_torch.ops.resize import resize_bilinear

LN_EPS = 1e-6


class MaskEmbedMLP(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc0 = Dense(dim, dim)
        self.fc1 = Dense(dim, dim)
        self.fc2 = Dense(dim, dim)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(F.relu(self.fc0(x)))))


class Mask2FormerHead(nn.Module):
    def __init__(self, cfg: Mask2FormerConfig):
        super().__init__()
        C = cfg.decoder.feat_channels
        self.num_layers = cfg.decoder.num_layers
        self.num_levels = cfg.num_transformer_feat_level
        self.query_feat = nn.Parameter(torch.zeros(cfg.num_queries, C))
        self.query_embed = nn.Parameter(torch.zeros(cfg.num_queries, C))
        self.level_embed = nn.Parameter(torch.zeros(self.num_levels, C))
        self.logits_dtype = (torch.bfloat16 if cfg.mask_logits_dtype == "bfloat16"
                             else torch.float32)
        self.decoder_norm = LayerNorm(C, eps=LN_EPS)
        self.cls_embed = Dense(C, cfg.num_classes + 1)
        self.mask_embed = MaskEmbedMLP(C)
        for layer in range(self.num_layers):
            self.add_module(f"layer_{layer}", MaskedDecoderLayer(cfg.decoder))

    def _head(self, q):
        out = self.decoder_norm(q)
        return self.cls_embed(out), self.mask_embed(out), out

    def forward(self, mask_features: torch.Tensor,
                multi_scale_feats: Sequence[torch.Tensor],
                all_layer_masks: bool = False):
        """mask_features (B, T, H4, W4, C); multi_scale_feats: (B, T, h_l,
        w_l, C) for strides [32, 16, 8].

        Returns (cls (L+1, B, Q, K+1), mask logits (L+1, B, Q, T, H4, W4)
        in ``mask_logits_dtype`` — (1, ...) of the final layer unless
        ``all_layer_masks`` —, query_feats (B, Q, C) final decoder-normed
        queries)."""
        B, T, H4, W4, C = mask_features.shape
        dtype = mask_features.dtype
        feats_flat: List[torch.Tensor] = []
        pos_flat: List[torch.Tensor] = []
        level_mask_feats: List[torch.Tensor] = []
        mf_flat = mask_features.reshape(B * T, H4, W4, C)
        for lvl, f in enumerate(multi_scale_feats):
            h, w = f.shape[2:4]
            if T == 1:
                pos = sine_pos_encoding(h, w, num_feats=C // 2, device=f.device)
            else:
                pos = sine_pos_encoding_3d(T, h, w, num_feats=C // 2,
                                           device=f.device)
            pos_flat.append(pos.reshape(1, T * h * w, C).to(dtype))
            feats_flat.append(f.reshape(B, T * h * w, C) + self.level_embed[lvl])
            level_mask_feats.append(
                resize_bilinear(mf_flat, (h, w)).reshape(B, T * h * w, C)
                .float())

        Q = self.query_feat.shape[0]
        query = self.query_feat[None].expand(B, Q, C).to(dtype)
        query_pos = self.query_embed[None].expand(B, Q, C).to(dtype)

        def attn_mask_for(membed, lvl):
            logits = torch.einsum("bqc,bsc->bqs", membed.float(),
                                  level_mask_feats[lvl])
            attend = logits >= 0.0
            return attend | ~attend.any(dim=-1, keepdim=True)

        def full_masks(membed):
            return torch.einsum("bqc,bthwc->bqthw", membed.float(),
                                mask_features.float()).to(self.logits_dtype)

        cls, membed, normed = self._head(query)
        cls_preds, mask_preds = [cls], []
        if all_layer_masks:
            mask_preds.append(full_masks(membed))
        for layer in range(self.num_layers):
            lvl = layer % self.num_levels
            query = getattr(self, f"layer_{layer}")(
                query, query_pos, feats_flat[lvl], pos_flat[lvl],
                attn_mask_for(membed, lvl))
            cls, membed, normed = self._head(query)
            cls_preds.append(cls)
            if all_layer_masks:
                mask_preds.append(full_masks(membed))
        if not all_layer_masks:
            mask_preds.append(full_masks(membed))
        return torch.stack(cls_preds), torch.stack(mask_preds), normed


class Mask2Former(nn.Module):
    """Backbone + pixel decoder + transformer head (``backbone``,
    ``pixel_decoder``, ``head``, and ``sem_seg_head`` with
    ``with_sem_seg``, as in the flax tree). ``train`` selects the training
    forward, as the flax module's attribute does. ``fast_norm`` (also
    settable later) makes the pixel decoder's and the head's LayerNorms and
    GroupNorms take their statistics in the compute dtype, as flax's
    ``Mask2Former(fast_norm=True)`` does (``models/layers.py``); the
    stride-4 chain's GroupNorms on the serving path are kernel B1's, whose
    statistics are float32, as in the JAX package's fused kernel."""

    def __init__(self, cfg: Mask2FormerConfig, train: bool = False,
                 fast_norm: bool = False):
        super().__init__()
        self.cfg = cfg
        self.train_mode = train
        if cfg.backbone.kind == "swin":
            variant = cfg.backbone.swin_variant
            self.backbone = SwinTransformer(variant, window=swin_window(variant),
                                            out_indices=cfg.backbone.out_indices,
                                            train=train)
        elif cfg.backbone.kind == "resnet":
            self.backbone = ResNet(cfg.backbone.depth, cfg.backbone.norm,
                                   cfg.backbone.out_indices, train=train)
        else:
            raise ValueError(f"backbone kind '{cfg.backbone.kind}': 'resnet' "
                             "or 'swin'")
        self.pixel_decoder = MSDeformAttnPixelDecoder(cfg.pixel_decoder,
                                                      train=train)
        self.head = Mask2FormerHead(cfg)
        if cfg.with_sem_seg:
            self.sem_seg_head = Conv(cfg.pixel_decoder.out_channels,
                                     cfg.num_classes + 1, 1)
        self.fast_norm = fast_norm

    @property
    def fast_norm(self) -> bool:
        return self._fast_norm

    @fast_norm.setter
    def fast_norm(self, on: bool) -> None:
        self._fast_norm = bool(on)
        for part in (self.pixel_decoder, self.head):
            for m in part.modules():
                if isinstance(m, (LayerNorm, GroupNorm)):
                    m.fast_norm = self._fast_norm

    def forward(self, images: torch.Tensor, return_sem_seg: bool = False):
        """Inference: images (N, H, W, 3) normalized frames, each run with
        T=1 -> (cls (N, Q, K+1), masks (N, Q, H/4, W/4) in
        ``mask_logits_dtype``, query (N, Q, C)).

        Training: images (B, T, H, W, 3) clips -> (cls_preds (L+1, B, Q,
        K+1), mask_preds (L+1, B, Q, T, H/4, W/4) in ``mask_logits_dtype``,
        query_feats (B, Q, C)); the backbone runs on the B*T frames.

        ``return_sem_seg`` appends the semantic head's logits (B, T, H/4,
        W/4, K+1) (inference: (N, H/4, W/4, K+1)), None without the head."""
        if not self.train_mode:
            images = images[:, None]
        B, T, H, W, _ = images.shape
        feats = self.backbone(images.reshape(B * T, H, W, 3))
        return self.decode(self.pixel_decoder(feats), B, T, return_sem_seg)

    def decode(self, pixel_out, B: int, T: int, return_sem_seg: bool = False):
        """The head on the pixel decoder's output ``pixel_out`` (mask
        features, multi-scale features) of B*T frames: ``forward``'s result
        from there on, for a caller that runs the backbone and the pixel
        decoder itself (the serving path, ``infer/segmenter.py``)."""
        mask_features, ms_feats = pixel_out

        def unflatten(f):
            return f.reshape(B, T, *f.shape[1:])

        cls, masks, query = self.head(
            unflatten(mask_features), [unflatten(f) for f in ms_feats],
            all_layer_masks=self.train_mode)
        out = ((cls, masks, query) if self.train_mode
               else (cls[-1], masks[0, :, :, 0], query))
        if not return_sem_seg:
            return out
        sem = None
        if self.cfg.with_sem_seg:
            head = self.sem_seg_head
            sem = F.linear(*head.cast(mask_features, head.weight[:, :, 0, 0],
                                      head.bias))
            sem = unflatten(sem) if self.train_mode else sem
        return (*out, sem)
