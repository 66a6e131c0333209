"""Swin Transformer backbone, the port of ``openpvsg_tpu/models/swin.py``.

Patch embed 4x4 + LayerNorm, four stages of pre-norm shifted-window blocks
(relative position bias; window 7, or 12 for Swin-L, ``SWIN_WINDOWS``) with
patch merging between them, and a LayerNorm on each output scale: strides
4/8/16/32 with C*(1, 2, 4, 8) channels, channels last (B, H, W, C), as the
pixel decoder takes them.

The JAX package's semantics, which differ from timm's and mmdet's:

- each stage is zero-padded once to window multiples, before its blocks,
  so the pad goes through ``norm1`` and is carried by the residual stream
  of every block of the stage; the stage output is cropped after them;
- the shifted-window mask (-100 between regions) is built on the padded
  grid, and unshifted windows do not mask the pad;
- the cyclic shift is ``roll(-shift)`` before the attention and
  ``roll(+shift)`` after it;
- GELU is flax's default, the tanh approximation;
- the attention logits are q.k accumulated in float32, then divided by
  sqrt(head dim); the bias and the mask are added after; the softmax runs
  in float32 and its result is cast to the compute dtype;
- LayerNorm eps is 1e-6 (flax's);
- ``PatchMerging`` concatenates each 2x2 patch in (dy, dx, c) order after
  padding an odd size, and its reduction has no bias;
- the patch embedding is a 4x4 stride-4 conv with flax's 'SAME' padding.

``train=True`` (stage 1) runs the window-attention core as
``window_attention_plain``, in torch operations with autograd, on every
device; inference runs ``window_attention``: kernel B3 on the card, the
plain form for CPU tensors (``kernels/window_attention.py``).

Module names follow the flax tree (``patch_embed``, ``patch_norm``,
``stage{s}_block{b}.{norm1,attn.{qkv,proj,rel_bias_table},norm2,mlp_fc1,
mlp_fc2}``, ``downsample{s}.{norm,reduction}``, ``out_norm{s}``), so the
weights convert by the mechanical walk of ``openpvsg_torch/weights.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from openpvsg_torch.kernels.window_attention import (window_attention,
                                                     window_attention_plain)
from openpvsg_torch.models.layers import Conv, Dense, LayerNorm

LN_EPS = 1e-6
MASK_VALUE = -100.0

SWIN_CONFIGS = {
    # name: (embed_dim, depths, num_heads)
    "tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "small": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "base": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
    # Mask2Former's Swin-L (maskformer2_swin_large_IN21k_384_bs16_100ep.yaml)
    "large": (192, (2, 2, 18, 2), (6, 12, 24, 48)),
}
# the attention window of a variant: 12 for Swin-L (its 384-pixel
# pretraining), 7 for every other
SWIN_WINDOWS = {"large": 12}


def swin_window(variant: str) -> int:
    return SWIN_WINDOWS.get(variant, 7)


def _rel_pos_index(ws: int) -> np.ndarray:
    """(ws², ws²) index into the (2ws-1)² relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # (2, n, n)
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def shift_window_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """The additive (nW, ws², ws²) float32 mask of the shifted windows of an
    (H, W) grid (both multiples of ``ws``): -100 between tokens that came
    from different regions before the roll, 0 within one."""
    img_mask = np.zeros((H, W), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    nh, nw = H // ws, W // ws
    m = (img_mask.reshape(nh, ws, nw, ws).transpose(0, 2, 1, 3)
         .reshape(nh * nw, ws * ws))
    return np.where(m[:, :, None] != m[:, None, :], MASK_VALUE,
                    0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, train: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.train_mode = train
        self.qkv = Dense(dim, 3 * dim)
        self.rel_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.proj = Dense(dim, dim)
        self.register_buffer(
            "rel_index",
            torch.from_numpy(_rel_pos_index(window).reshape(-1).astype(np.int64)),
            persistent=False)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        """x (nW, L, C) window tokens; attn_mask (nM, L, L) additive float32
        or None, where nW is a multiple of nM and window w takes mask row
        w % nM (the windows of each image in turn). The core between the
        two projections is ``kernels/window_attention.py``'s: the plain form
        with ``train``, else kernel B3 on the card."""
        nW, L, C = x.shape
        H = self.num_heads
        bias = self.rel_bias_table[self.rel_index].reshape(L, L, H).permute(2, 0, 1)
        core = window_attention_plain if self.train_mode else window_attention
        return self.proj(core(self.qkv(x), bias, attn_mask, H))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0, train: bool = False):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window, train)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim)
        # shifted-window masks by (H, W, device), built once per grid
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _mask(self, H: int, W: int, device: torch.device) -> torch.Tensor:
        key = (H, W, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                shift_window_mask(H, W, self.window, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) with H, W multiples of the window (the stage
        pads)."""
        B, H, W, C = x.shape
        ws, s = self.window, self.shift
        shortcut = x
        x = self.norm1(x)
        if s:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
        nh, nw = H // ws, W // ws
        windows = (x.reshape(B, nh, ws, nw, ws, C).permute(0, 1, 3, 2, 4, 5)
                   .reshape(B * nh * nw, ws * ws, C))
        out = self.attn(windows, self._mask(H, W, x.device) if s else None)
        x = (out.reshape(B, nh, nw, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
             .reshape(B, H, W, C))
        if s:
            x = torch.roll(x, (s, s), dims=(1, 2))
        x = shortcut + x
        y = F.gelu(self.mlp_fc1(self.norm2(x)), approximate="tanh")
        return x + self.mlp_fc2(y)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) with H, W even -> (B, H/2, W/2, 2C); each 2x2 patch
        concatenated in (dy, dx, c) order."""
        B, H, W, C = x.shape
        x = (x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
             .reshape(B, H // 2, W // 2, 4 * C))
        return self.reduction(self.norm(x))


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA 'SAME' padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SwinTransformer(nn.Module):
    """Returns the outputs of the stages in ``out_indices`` (strides
    4/8/16/32), each LayerNormed, channels last. ``window`` None takes the
    variant's (``swin_window``); ``train`` picks the attention core."""

    def __init__(self, variant: str = "tiny", window: Optional[int] = None,
                 out_indices: Sequence[int] = (0, 1, 2, 3), train: bool = False):
        super().__init__()
        if variant not in SWIN_CONFIGS:
            raise ValueError(f"swin variant '{variant}': one of "
                             f"{sorted(SWIN_CONFIGS)}")
        embed_dim, depths, heads = SWIN_CONFIGS[variant]
        window = swin_window(variant) if window is None else window
        self.window = window
        self.depths = depths
        self.out_indices = tuple(out_indices)
        self.patch_embed = Conv(3, embed_dim, 4, stride=4)
        self.patch_norm = LayerNorm(embed_dim, eps=LN_EPS)
        dim = embed_dim
        for stage, depth in enumerate(depths):
            for blk in range(depth):
                self.add_module(f"stage{stage}_block{blk}", SwinBlock(
                    dim, heads[stage], window,
                    shift=0 if blk % 2 == 0 else window // 2, train=train))
            if stage in self.out_indices:
                self.add_module(f"out_norm{stage}", LayerNorm(dim, eps=LN_EPS))
            if stage < len(depths) - 1:
                self.add_module(f"downsample{stage}", PatchMerging(dim))
                dim *= 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) -> the stage outputs, (B, h_s, w_s, C_s)."""
        ws = self.window
        (ht, hb), (wl, wr) = (_same_pads(n, 4, 4) for n in x.shape[1:3])
        x = F.pad(x.permute(0, 3, 1, 2), (wl, wr, ht, hb))
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))
        outs = []
        for stage, depth in enumerate(self.depths):
            h, w = x.shape[1:3]
            xp = F.pad(x, (0, 0, 0, (-w) % ws, 0, (-h) % ws))
            for blk in range(depth):
                xp = getattr(self, f"stage{stage}_block{blk}")(xp)
            x = xp[:, :h, :w]
            if stage in self.out_indices:
                outs.append(getattr(self, f"out_norm{stage}")(x))
            if stage < len(self.depths) - 1:
                x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
                x = getattr(self, f"downsample{stage}")(x)
        return outs
