"""The plain Mask2Former Swin of the benchmark's comparison: a Swin
Transformer (Liu et al., "Swin Transformer: Hierarchical Vision Transformer
using Shifted Windows", 2021) as Mask2Former's Swin-L configures it, in
front of ``reference/model.py``'s pixel decoder and masked-attention head,
which are reused as they are.

Plain ``torch`` in float32: no kernel, no graph, no cast, channels last
(B, H, W, C). Every product goes through ``model.Rounding``, so the
comparison's control rounds them here as it does there. Module names
follow the state dict of the segmenter that ``openpvsg_torch`` serves
(``backbone.patch_embed``, ``backbone.stage{s}_block{b}.attn.qkv`` ...),
so one state dict feeds both.

What this computes is the JAX package's Swin, which the port keeps; it
departs from the published Swin in these points:

- GELU is the tanh approximation (published: the erf form);
- LayerNorm eps is 1e-6 (published: 1e-5);
- each stage is zero-padded once, to multiples of the window, before its
  first block; the pad goes through ``norm1`` and stays in the residual
  stream of every block of the stage, and the stage output is cropped
  after its last block (published: each block pads after ``norm1`` and
  crops after its attention);
- unshifted windows do not mask the pad, and the shifted windows' mask
  (-100 between tokens of different regions before the roll) is built on
  the padded grid;
- the patch embedding (4x4, stride 4) pads as 'SAME' does, split over both
  sides (published: right and bottom only);
- patch merging concatenates each 2x2 patch in (dy, dx, channel) order
  after padding an odd size at the bottom and right (published: (dx, dy)
  order), then LayerNorm and a reduction without bias.

The attention logits are q.k over the square root of the head size, plus
the relative-position bias and the shift mask, as published. No dropout
and no drop path: inference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pvsgbench.reference import model as ref_model
from pvsgbench.reference.model import Dense, Rounding

LN_EPS = 1e-6
MASK_VALUE = -100.0

# variant: (embed dim, blocks per stage, heads per stage, window)
VARIANTS = {"large": (192, (2, 2, 18, 2), (6, 12, 24, 48), 12)}


def relative_index(window: int) -> torch.Tensor:
    """(window², window²) rows of the (2 window - 1)² bias table: the
    offset (dy, dx) of token m from token l, each shifted to >= 0."""
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
    coords = torch.stack([ys.reshape(-1), xs.reshape(-1)])             # (2, L)
    rel = coords[:, :, None] - coords[:, None, :] + (window - 1)       # (2, L, L)
    return rel[0] * (2 * window - 1) + rel[1]


def shift_mask(H: int, W: int, window: int, shift: int) -> torch.Tensor:
    """(windows, L, L) additive mask of the shifted windows of an (H, W)
    grid (multiples of the window): -100 between tokens whose regions
    before the roll differ, 0 within one."""
    region = torch.zeros(H, W, dtype=torch.long)
    bands_h = [(0, H - window), (H - window, H - shift), (H - shift, H)]
    bands_w = [(0, W - window), (W - window, W - shift), (W - shift, W)]
    for i, (h0, h1) in enumerate(bands_h):
        for j, (w0, w1) in enumerate(bands_w):
            region[h0:h1, w0:w1] = 3 * i + j
    ids = windows_of(region[None, :, :, None], window)[..., 0]         # (nW, L)
    return torch.where(ids[:, :, None] != ids[:, None, :], MASK_VALUE, 0.0)


def windows_of(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/w * W/w, w², C), windows in row order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def from_windows(x: torch.Tensor, B: int, H: int, W: int, window: int) -> torch.Tensor:
    C = x.shape[-1]
    x = x.reshape(B, H // window, W // window, window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.rel_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("rel_index", relative_index(window).reshape(-1), persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x (nW, L, C) window tokens; ``mask`` (m, L, L), window w taking
        row w % m (the windows of each image in turn), or None."""
        nW, L, C = x.shape
        H, d = self.heads, C // self.heads
        q, k, v = self.qkv(x).reshape(nW, L, 3, H, d).unbind(2)       # (nW, L, H, d)
        logits = Rounding.einsum("wlhd,wmhd->whlm", q, k) / math.sqrt(d)
        logits = logits + self.rel_bias_table[self.rel_index].reshape(L, L, H).permute(2, 0, 1)
        if mask is not None:
            m = mask.shape[0]
            logits = (logits.reshape(nW // m, m, H, L, L) + mask[None, :, None]).reshape(nW, H, L, L)
        out = Rounding.einsum("whlm,wmhd->wlhd", logits.softmax(-1), v)
        return self.proj(out.reshape(nW, L, C))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1, self.mlp_fc2 = Dense(dim, 4 * dim), Dense(4 * dim, dim)
        self.masks: Dict[tuple, torch.Tensor] = {}     # by (H, W, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C), H and W multiples of the window."""
        B, H, W, _ = x.shape
        w, s = self.window, self.shift
        y = self.norm1(x)
        mask = None
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
            key = (H, W, x.device)
            if key not in self.masks:
                self.masks[key] = shift_mask(H, W, w, s).to(x.device)
            mask = self.masks[key]
        y = from_windows(self.attn(windows_of(y, w), mask), B, H, W, w)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="tanh"))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        H, W = H + H % 2, W + W % 2
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        return self.reduction(self.norm(x.reshape(B, H // 2, W // 2, 4 * C)))


def same_pads(n: int, k: int = 4, stride: int = 4):
    """'SAME' padding of one axis: (before, after)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class Swin(nn.Module):
    """The four stages' outputs (strides 4, 8, 16, 32), each LayerNormed."""

    def __init__(self, variant: str):
        super().__init__()
        dim, depths, heads, window = VARIANTS[variant]
        self.window, self.depths = window, depths
        self.patch_embed = ref_model.Conv(3, dim, 4, stride=4)
        self.patch_norm = nn.LayerNorm(dim, eps=LN_EPS)
        for s, n in enumerate(depths):
            for b in range(n):
                self.add_module(f"stage{s}_block{b}",
                                Block(dim, heads[s], window, 0 if b % 2 == 0 else window // 2))
            self.add_module(f"out_norm{s}", nn.LayerNorm(dim, eps=LN_EPS))
            if s < len(depths) - 1:
                self.add_module(f"downsample{s}", PatchMerging(dim))
                dim *= 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) -> [(B, h_s, w_s, C_s)]."""
        w = self.window
        (top, bottom), (left, right) = same_pads(x.shape[1]), same_pads(x.shape[2])
        x = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))
        outs = []
        for s, n in enumerate(self.depths):
            h, ww = x.shape[1:3]
            x = F.pad(x, (0, 0, 0, (-ww) % w, 0, (-h) % w))
            for b in range(n):
                x = getattr(self, f"stage{s}_block{b}")(x)
            x = x[:, :h, :ww]
            outs.append(getattr(self, f"out_norm{s}")(x))
            if s < len(self.depths) - 1:
                x = getattr(self, f"downsample{s}")(x)
        return outs


class Mask2Former(ref_model.Mask2Former):
    """``reference/model.py``'s Mask2Former with the Swin backbone of
    ``m["backbone"]["swin_variant"]``."""

    def __init__(self, m: dict):
        nn.Module.__init__(self)
        self.backbone = Swin(m["backbone"]["swin_variant"])
        self.pixel_decoder = ref_model.PixelDecoder(m["pixel_decoder"])
        self.head = ref_model.Head(m)


def state_shapes(m: dict) -> Dict[str, tuple]:
    """{state-dict key: shape} of the model of config ``m``."""
    with torch.device("meta"):
        model = Mask2Former(m)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def build(m: dict, state: dict, device) -> Mask2Former:
    with torch.device("meta"):
        model = Mask2Former(m)
    model = model.to_empty(device=device)
    for name, buf in model.named_buffers():     # not in the state dict: made again
        if name.endswith("rel_index"):
            buf.copy_(relative_index(model.backbone.window).reshape(-1))
    missing, extra = model.load_state_dict(state, strict=False)
    if missing or extra:
        raise KeyError(f"reference state dict: missing {missing[:5]}, extra {extra[:5]}")
    return model.eval().requires_grad_(False)
