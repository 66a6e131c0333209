"""Pixel decoder (axial encoder variant), the port of
``openpvsg_tpu/models/pixel_decoder.py:97,178-258``.

The top three backbone scales are projected to ``feat_channels`` by 1x1
ConvGN (``input_conv_{i}``), run through the axial encoder, and the
stride-4 chain ``lateral_conv_0`` -> + up2x -> ``output_conv_0`` ->
``mask_feature`` yields the mask features. At inference that chain is
kernel B1 (``kernels/fpn.py``): the CUDA kernels for CUDA tensors, the
unfused chain ``fpn_stride4_plain`` for CPU tensors. Built with
``train=True`` the decoder runs ``fpn_stride4_plain`` on every device, as
the JAX package does with ``fused_fpn=False``
(``openpvsg_tpu/models/pixel_decoder.py:245-258``): the kernels have no
backward. Its weights stay in the ConvGN submodules, so the parameter tree
is the flax one. Tensors are channels last (B, H, W, C).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from openpvsg_torch.config import PixelDecoderConfig
from openpvsg_torch.kernels import fpn
from openpvsg_torch.models.axial_encoder import AxialPixelEncoder

GN_EPS = 1e-6


class ConvGN(nn.Module):
    """Conv (kernel k, zero pad k//2, bias) -> GroupNorm (eps 1e-6) ->
    optional relu, on channels-last tensors."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1,
                 num_groups: int = 32, act: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2)
        self.gn = nn.GroupNorm(num_groups, out_ch, eps=GN_EPS)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.gn(self.conv(x.permute(0, 3, 1, 2)))
        if self.act:
            y = F.relu(y)
        return y.permute(0, 2, 3, 1)


class MSDeformAttnPixelDecoder(nn.Module):
    """Named after the flax module; only ``encoder='axial'`` is ported."""

    def __init__(self, cfg: PixelDecoderConfig, train: bool = False):
        super().__init__()
        self.train_mode = train
        if cfg.encoder != "axial":
            raise ValueError(f"pixel decoder encoder '{cfg.encoder}' is not "
                             "ported (only 'axial')")
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
        self.axial_encoder = AxialPixelEncoder(cfg)
        self.lateral_conv_0 = ConvGN(cfg.in_channels[0], C, 1, cfg.num_groups)
        self.output_conv_0 = ConvGN(C, C, 3, cfg.num_groups, act=True)
        self.mask_feature = nn.Conv2d(C, cfg.out_channels, 1)

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

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: backbone outputs, low -> high stride, channels last.

        Returns (mask_feature (B, H/4, W/4, C_out),
                 multi-scale feats [stride32, stride16, stride8])."""
        cfg = self.cfg
        n_in = len(cfg.in_channels)
        projs: List[torch.Tensor] = [
            getattr(self, f"input_conv_{i}")(feats[n_in - i - 1])
            for i in range(cfg.num_levels)]
        outs = self.axial_encoder(projs)  # [stride32, stride16, stride8]
        chain = fpn.fpn_stride4_plain if self.train_mode else fpn.fpn_stride4
        mask_feature = chain(feats[0], outs[-1], self.fpn_params(),
                             num_groups=cfg.num_groups, eps=GN_EPS)
        return mask_feature, outs[:cfg.num_outs]
