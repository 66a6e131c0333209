"""Pixel decoder, the port of ``openpvsg_tpu/models/pixel_decoder.py``.

The top three backbone scales are projected to ``feat_channels`` by 1x1
ConvGN (``input_conv_{i}``), run through the encoder, and the stride-4
chain ``lateral_conv_0`` -> + up2x -> ``output_conv_0`` -> ``mask_feature``
yields the mask features. The encoder is ``cfg.encoder``: 'axial' (the
dense encoder, ``models/axial_encoder.py``) or 'msda', the reference's
6-layer multi-scale deformable attention encoder (mmdet's
MSDeformAttnPixelDecoder; the one its checkpoints hold), whose sampling
is ``ops/sampling.py:ms_deform_attn``. At inference the stride-4 chain is
kernel B1 (``kernels/fpn.py``): the CUDA kernels for CUDA tensors, the
unfused chain ``fpn_stride4_plain`` for CPU tensors. Built with
``train=True`` the decoder runs ``fpn_stride4_plain`` on every device, as
the JAX package does with ``fused_fpn=False``
(``openpvsg_tpu/models/pixel_decoder.py:245-258``): the kernels have no
backward; with a compute dtype (the bfloat16 trainer) it runs the ConvGN
modules themselves, whose layers take that dtype. Its weights stay in the
ConvGN submodules, so the parameter tree is the flax one. Tensors are
channels last (B, H, W, C).

``model.pixel_decoder.fused_fpn`` selects nothing in the port: on the card
the serving forward always launches B1, on the CPU it always runs the
plain chain, and training never launches it. The field is read from
config files of either value, so they load.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from openpvsg_torch.config import PixelDecoderConfig
from openpvsg_torch.kernels import fpn
from openpvsg_torch.models.axial_encoder import AxialPixelEncoder
from openpvsg_torch.models.layers import Conv, Dense, GroupNorm, LayerNorm
from openpvsg_torch.models.position_encoding import sine_pos_encoding
from openpvsg_torch.models.transformer_decoder import DecoderFFN
from openpvsg_torch.ops.resize import resize_bilinear
from openpvsg_torch.ops.sampling import ms_deform_attn

GN_EPS = 1e-6
LN_EPS = 1e-6


def msda_offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Directional-grid bias init of the sampling offsets (mmcv
    MultiScaleDeformableAttention.init_weights, ``_msda_offset_bias``):
    head h points at angle 2*pi*h/H, scaled by the point index; (H*L*P*2,)
    in the (heads, levels, points, xy) order of the layer's output."""
    thetas = np.arange(n_heads) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # (H, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for p in range(n_points):
        grid[:, :, p, :] *= p + 1
    return grid.reshape(-1)


class MSDeformAttention(nn.Module):
    """Multi-scale deformable self-attention of the encoder
    (``MSDeformAttention``, ``pixel_decoder.py:41-81``). The sampling
    locations and attention weights are float32 whatever the compute
    dtype: at bfloat16 a location in [0, 1] on a 60-pixel level would be
    off by about 0.2 pixel, and the JAX package promotes them to float32."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 num_levels: int = 3, num_points: int = 4):
        super().__init__()
        self.num_heads, self.num_levels, self.num_points = num_heads, num_levels, num_points
        self.value_proj = Dense(embed_dim, embed_dim)
        self.sampling_offsets = Dense(embed_dim, num_heads * num_levels * num_points * 2)
        self.attention_weights = Dense(embed_dim, num_heads * num_levels * num_points)
        self.output_proj = Dense(embed_dim, embed_dim)
        # (w_l, h_l) of each level by (spatial shapes, device), built once:
        # a host-to-device copy per forward would also break graph capture
        self._normalizers: Dict[tuple, torch.Tensor] = {}

    def _normalizer(self, spatial_shapes: Sequence[Tuple[int, int]],
                    device: torch.device) -> torch.Tensor:
        key = (tuple(map(tuple, spatial_shapes)), device)
        if key not in self._normalizers:
            self._normalizers[key] = torch.tensor(
                [[w, h] for h, w in spatial_shapes], dtype=torch.float32, device=device)
        return self._normalizers[key]

    def forward(self, query: torch.Tensor, value: torch.Tensor,
                reference_points: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query, value (B, S, C); reference_points (B, S, 2) normalized,
        float32 -> (B, S, C)."""
        B, S, C = query.shape
        H, L, P = self.num_heads, self.num_levels, self.num_points
        v = self.value_proj(value).reshape(B, S, H, C // H)
        offsets = self.sampling_offsets(query).reshape(B, S, H, L, P, 2).float()
        attn = self.attention_weights(query).reshape(B, S, H, L * P).float()
        attn = torch.softmax(attn, dim=-1).reshape(B, S, H, L, P)
        # offsets are in pixels of each level: normalize by (w_l, h_l)
        normalizer = self._normalizer(spatial_shapes, query.device)
        locs = (reference_points[:, :, None, None, None, :]
                + offsets / normalizer[None, None, None, :, None, :])
        out = ms_deform_attn(v, spatial_shapes, locs, attn)
        return self.output_proj(out.to(query.dtype))


class ConvGN(nn.Module):
    """Conv (kernel k, zero pad k//2, bias) -> GroupNorm (eps 1e-6) ->
    optional relu, on channels-last tensors."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1,
                 num_groups: int = 32, act: bool = False):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, padding=kernel // 2)
        self.gn = GroupNorm(num_groups, out_ch, eps=GN_EPS)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.gn(self.conv(x.permute(0, 3, 1, 2)))
        if self.act:
            y = F.relu(y)
        return y.permute(0, 2, 3, 1)


class MSDeformAttnPixelDecoder(nn.Module):
    """Named after the flax module. With ``encoder='msda'`` the encoder's
    layers are ``encoder_layer_{i}_{attn,norm1,ffn,norm2}`` and its level
    embedding ``level_embed`` sits in the decoder's scope, as in flax."""

    def __init__(self, cfg: PixelDecoderConfig, train: bool = False):
        super().__init__()
        self.train_mode = train
        if cfg.encoder not in ("axial", "msda"):
            raise ValueError(f"pixel decoder encoder '{cfg.encoder}': 'axial' "
                             "or 'msda'")
        n_in = len(cfg.in_channels)
        if n_in - cfg.num_levels != 1:
            raise ValueError("the port runs exactly one stride-4 FPN level "
                             f"(got {n_in} inputs, {cfg.num_levels} encoder "
                             "levels)")
        self.cfg = cfg
        C = cfg.feat_channels
        for i in range(cfg.num_levels):
            self.add_module(f"input_conv_{i}", ConvGN(
                cfg.in_channels[n_in - i - 1], C, 1, cfg.num_groups))
        if cfg.encoder == "axial":
            self.axial_encoder = AxialPixelEncoder(cfg)
        else:
            self.level_embed = nn.Parameter(torch.zeros(cfg.num_levels, C))
            for i in range(cfg.encoder_layers):
                self.add_module(f"encoder_layer_{i}_attn", MSDeformAttention(
                    C, cfg.num_heads, cfg.num_levels, cfg.num_points))
                self.add_module(f"encoder_layer_{i}_norm1", LayerNorm(C, eps=LN_EPS))
                self.add_module(f"encoder_layer_{i}_ffn", DecoderFFN(cfg.ffn_channels, C))
                self.add_module(f"encoder_layer_{i}_norm2", LayerNorm(C, eps=LN_EPS))
        self.lateral_conv_0 = ConvGN(cfg.in_channels[0], C, 1, cfg.num_groups)
        self.output_conv_0 = ConvGN(C, C, 3, cfg.num_groups, act=True)
        self.mask_feature = Conv(C, cfg.out_channels, 1)

    def fpn_params(self):
        """The stride-4 chain's weights in the layout of
        ``fused_fpn_stride4``'s ``p`` (HWIO / (in, out))."""
        lat, out = self.lateral_conv_0, self.output_conv_0
        return {
            "w_lat": lat.conv.weight[:, :, 0, 0].t(),
            "b_lat": lat.conv.bias,
            "gn1_scale": lat.gn.weight,
            "gn1_bias": lat.gn.bias,
            "w_out": out.conv.weight.permute(2, 3, 1, 0),
            "b_out": out.conv.bias,
            "gn2_scale": out.gn.weight,
            "gn2_bias": out.gn.bias,
            "w_mask": self.mask_feature.weight[:, :, 0, 0].t(),
            "b_mask": self.mask_feature.bias,
        }

    def _msda_encoder(self, projs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``_msda_encoder`` (``pixel_decoder.py:124-176``): the levels
        [stride32, stride16, stride8], each (B, h, w, C), as one token axis
        through the deformable encoder; returns them enhanced, in the same
        order. Each token's reference point is its own normalized centre,
        shared across levels (no padding masks)."""
        B, C = projs[0].shape[0], projs[0].shape[3]
        dtype, dev = projs[0].dtype, projs[0].device
        shapes = [tuple(p.shape[1:3]) for p in projs]
        src = torch.cat([p.reshape(B, -1, C) for p in projs], dim=1)
        # the positional encoding is cast to the compute dtype, the level
        # embedding added in float32, as in flax
        pos = torch.cat([
            sine_pos_encoding(h, w, num_feats=C // 2, device=dev).to(dtype)
            .reshape(h * w, C).float() + self.level_embed[i].float()
            for i, (h, w) in enumerate(shapes)])[None]
        refs = []
        for h, w in shapes:
            ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
            xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            refs.append(torch.stack([gx, gy], -1).reshape(h * w, 2))
        ref = torch.cat(refs)[None].expand(B, -1, 2)
        x = src
        for i in range(self.cfg.encoder_layers):
            attn = getattr(self, f"encoder_layer_{i}_attn")(
                (x.float() + pos).to(dtype), x, ref, shapes)
            x = getattr(self, f"encoder_layer_{i}_norm1")(x + attn)
            x = getattr(self, f"encoder_layer_{i}_norm2")(
                getattr(self, f"encoder_layer_{i}_ffn")(x))
        parts = x.split([h * w for h, w in shapes], dim=1)
        return [t.reshape(B, h, w, C) for t, (h, w) in zip(parts, shapes)]

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: backbone outputs, low -> high stride, channels last.

        Returns (mask_feature (B, H/4, W/4, C_out),
                 multi-scale feats [stride32, stride16, stride8])."""
        cfg = self.cfg
        n_in = len(cfg.in_channels)
        projs: List[torch.Tensor] = [
            getattr(self, f"input_conv_{i}")(feats[n_in - i - 1])
            for i in range(cfg.num_levels)]
        if self.cfg.encoder == "axial":
            outs = self.axial_encoder(projs)
        else:
            outs = self._msda_encoder(projs)
        # outs = [stride32, stride16, stride8]
        if self.train_mode and self.mask_feature.compute_dtype is not None:
            # the module chain, whose convs and norms take the compute dtype
            lat = self.lateral_conv_0(feats[0])
            x = self.output_conv_0(lat + resize_bilinear(outs[-1], lat.shape[1:3]))
            mask_feature = self.mask_feature(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            return mask_feature, outs[:cfg.num_outs]
        chain = fpn.fpn_stride4_plain if self.train_mode else fpn.fpn_stride4
        mask_feature = chain(feats[0], outs[-1], self.fpn_params(),
                             num_groups=cfg.num_groups, eps=GN_EPS)
        return mask_feature, outs[:cfg.num_outs]
