"""The plain Mask2Former of the benchmark's comparison: R-50 (inference-mode
BatchNorm), the axial or the MSDA pixel encoder, the unfused stride-4 FPN
chain, the 9-layer masked-attention decoder.

A frozen, condensed copy of the segmenter that ``openpvsg_torch`` serves,
written as plain ``torch`` operations in float32: no kernel, no folded
weights, no cast. Module names follow the port's state dict, so one state
dict made by ``pvsgbench.gen`` feeds both. Tensors are channels last
(B, H, W, C). Every product goes through ``Rounding``, which
round their operands to the precision the comparison's control asks for
and leave them unchanged otherwise.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
GN_EPS = 1e-6
LN_EPS = 1e-6
STAGE_BLOCKS = {26: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class Rounding:
    """Operand rounding of every product: None keeps float32; 'fp8' rounds
    each operand to float8 e4m3 with a per-tensor scale (its largest
    magnitude at 448, e4m3's largest finite value), the precision below
    bfloat16 that the control computes in."""

    mode: Optional[str] = None

    @classmethod
    def q(cls, t: torch.Tensor) -> torch.Tensor:
        if cls.mode is None:
            return t
        scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    @classmethod
    def linear(cls, x, w, b=None):
        return F.linear(cls.q(x), cls.q(w), b)

    @classmethod
    def conv(cls, x, w, b=None, stride=1, padding=0):
        return F.conv2d(cls.q(x), cls.q(w), b, stride=stride, padding=padding)

    @classmethod
    def einsum(cls, eq, a, b):
        return torch.einsum(eq, cls.q(a), cls.q(b))


class Dense(nn.Linear):
    def forward(self, x):
        return Rounding.linear(x, self.weight, self.bias)


class Conv(nn.Conv2d):
    def forward(self, x):
        return Rounding.conv(x, self.weight, self.bias, self.stride, self.padding)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """(..., H, W, C) -> (..., h, w, C), half-pixel centres, no antialias."""
    lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
    y = F.interpolate(x.reshape(-1, H, W, C).permute(0, 3, 1, 2),
                      size=(int(size[0]), int(size[1])), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, int(size[0]), int(size[1]), C)


def _sincos(embed: torch.Tensor, num_feats: int) -> torch.Tensor:
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=embed.device)
    dim_t = 10000.0 ** (2.0 * torch.floor(dim_t / 2.0) / num_feats)
    pos = embed[..., None] / dim_t
    return torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()],
                       -1).reshape(*embed.shape, num_feats)


def sine_pos(h: int, w: int, C: int, device) -> torch.Tensor:
    """mmdet's normalized 2-D sine encoding -> (h, w, C), [pos_y, pos_x]."""
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    y = y / (h + 1e-6) * 2 * math.pi
    x = x / (w + 1e-6) * 2 * math.pi
    return torch.cat([_sincos(y, C // 2), _sincos(x, C // 2)], -1)


# --------------------------------------------------------------------- R-50

class BN(nn.Module):
    """Inference BatchNorm under the port's key names (``bnX.bn.*``)."""

    def __init__(self, c: int):
        super().__init__()
        self.bn = nn.BatchNorm2d(c, eps=BN_EPS)

    def forward(self, x):
        m = self.bn
        return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias,
                            False, 0.0, BN_EPS)


def _conv(cin, cout, k, stride=1):
    return Conv(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, down):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, planes, 1), BN(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride), BN(planes)
        self.conv3, self.bn3 = _conv(planes, planes * 4, 1), BN(planes * 4)
        self.down = down
        if down:
            self.downsample_conv = _conv(cin, planes * 4, 1, stride)
            self.downsample_bn = BN(planes * 4)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idt = self.downsample_bn(self.downsample_conv(x)) if self.down else x
        return F.relu(out + idt)


class ResNet(nn.Module):
    def __init__(self, depth: int):
        super().__init__()
        self.conv1, self.bn1 = _conv(3, 64, 7, 2), BN(64)
        self.stages: List[List[str]] = []
        cin, planes = 64, 64
        for s, n in enumerate(STAGE_BLOCKS[depth]):
            names = []
            for b in range(n):
                name = f"layer{s + 1}_{b}"
                self.add_module(name, Bottleneck(cin, planes, (1, 2, 2, 2)[s] if b == 0 else 1,
                                                 b == 0))
                cin = planes * 4
                names.append(name)
            self.stages.append(names)
            planes *= 2

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x.permute(0, 2, 3, 1))
        return outs


# ------------------------------------------------------------ pixel decoder

class ConvGN(nn.Module):
    def __init__(self, cin, cout, k=1, act=False):
        super().__init__()
        self.conv = Conv(cin, cout, k, padding=k // 2)
        self.gn = nn.GroupNorm(32, cout, eps=GN_EPS)
        self.act = act

    def forward(self, x):
        y = self.gn(self.conv(x.permute(0, 3, 1, 2)))
        return (F.relu(y) if self.act else y).permute(0, 2, 3, 1)


def attention(q, k, v, mask=None):
    """q (B, Lq, H, d), k, v (B, Lk, H, d); mask (B, Lq, Lk) True = attend."""
    logits = Rounding.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None], torch.finfo(torch.float32).min)
    return Rounding.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v)


class MHA(nn.Module):
    def __init__(self, heads, dim):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Dense(dim, dim), Dense(dim, dim)
        self.v_proj, self.out_proj = Dense(dim, dim), Dense(dim, dim)

    def forward(self, q, k, v, mask=None):
        H = self.heads

        def split(t):
            return t.reshape(*t.shape[:-1], H, t.shape[-1] // H)

        out = attention(split(self.q_proj(q)), split(self.k_proj(k)),
                        split(self.v_proj(v)), mask)
        return self.out_proj(out.reshape(*out.shape[:-2], -1))


class AxisMHA(MHA):
    """Attention along W (axis 2) or H (axis 1) of (B, H, W, C)."""

    def __init__(self, heads, dim, axis):
        super().__init__(heads, dim)
        self.axis = axis

    def forward(self, qk, v):
        if self.axis == 1:
            qk, v = qk.transpose(1, 2), v.transpose(1, 2)
        B, A, L, C = qk.shape
        qk, v = qk.reshape(B * A, L, C), v.reshape(B * A, L, C)
        out = super().forward(qk, qk, v).reshape(B, A, L, C)
        return out.transpose(1, 2) if self.axis == 1 else out


class AxialBlock(nn.Module):
    def __init__(self, heads, dim, ffn):
        super().__init__()
        self.row_attn, self.norm_row = AxisMHA(heads, dim, 2), nn.LayerNorm(dim, eps=LN_EPS)
        self.col_attn, self.norm_col = AxisMHA(heads, dim, 1), nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn_fc1, self.ffn_fc2 = Dense(dim, ffn), Dense(ffn, dim)
        self.norm_ffn = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, pos):
        x = self.norm_row(x + self.row_attn(x + pos, x))
        x = self.norm_col(x + self.col_attn(x + pos, x))
        return self.norm_ffn(x + self.ffn_fc2(F.relu(self.ffn_fc1(x))))


class AxialEncoder(nn.Module):
    def __init__(self, pd):
        super().__init__()
        C, n = pd["feat_channels"], pd["num_levels"]
        self.layers = pd["encoder_layers"]
        self.level_embed = nn.Parameter(torch.zeros(n, C))
        for i in range(self.layers):
            self.add_module(f"layer_{i}", AxialBlock(pd["num_heads"], C, pd["ffn_channels"]))
            for j in range(1, n):
                self.add_module(f"mix_{i}_{j}", Dense(C, C))

    def forward(self, levels):
        C = self.level_embed.shape[1]
        poss = [sine_pos(f.shape[1], f.shape[2], C, f.device)[None] for f in levels]
        xs = [f + self.level_embed[i] for i, f in enumerate(levels)]
        for i in range(self.layers):
            block = getattr(self, f"layer_{i}")
            xs = [block(x, p) for x, p in zip(xs, poss)]
            mixed = [xs[0]]
            for j in range(1, len(xs)):
                up = resize_bilinear(mixed[j - 1], xs[j].shape[1:3])
                mixed.append(xs[j] + getattr(self, f"mix_{i}_{j}")(up))
            xs = mixed
        return xs


class FFN(nn.Module):
    def __init__(self, hidden, dim):
        super().__init__()
        self.fc1, self.fc2 = Dense(dim, hidden), Dense(hidden, dim)

    def forward(self, x):
        return x + self.fc2(F.relu(self.fc1(x)))


def msda_offset_bias(heads: int, levels: int, points: int) -> np.ndarray:
    """mmcv's directional-grid init of the sampling offsets' bias."""
    th = np.arange(heads) * (2.0 * math.pi / heads)
    grid = np.stack([np.cos(th), np.sin(th)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, levels, points, 1))
    for p in range(points):
        grid[:, :, p, :] *= p + 1
    return grid.reshape(-1)


class MSDeformAttn(nn.Module):
    """mmcv's multi-scale deformable attention, sampling by grid_sample
    (bilinear, zero padding, half-pixel centres)."""

    def __init__(self, dim, heads, levels, points):
        super().__init__()
        self.h, self.l, self.p = heads, levels, points
        self.value_proj = Dense(dim, dim)
        self.sampling_offsets = Dense(dim, heads * levels * points * 2)
        self.attention_weights = Dense(dim, heads * levels * points)
        self.output_proj = Dense(dim, dim)

    def forward(self, query, value, ref, shapes):
        B, S, C = query.shape
        H, L, P = self.h, self.l, self.p
        v = self.value_proj(value).reshape(B, S, H, C // H)
        off = self.sampling_offsets(query).reshape(B, S, H, L, P, 2)
        w = self.attention_weights(query).reshape(B, S, H, L * P).softmax(-1)
        w = w.reshape(B, S, H, L, P)
        norm = torch.tensor([[ww, hh] for hh, ww in shapes], dtype=torch.float32,
                            device=query.device)
        locs = ref[:, :, None, None, None, :] + off / norm[None, None, None, :, None, :]
        out, start = 0.0, 0
        for lvl, (h, ww) in enumerate(shapes):
            val = v[:, start:start + h * ww].permute(0, 2, 3, 1).reshape(B * H, C // H, h, ww)
            start += h * ww
            grid = (2.0 * locs[:, :, :, lvl] - 1.0).transpose(1, 2).reshape(B * H, S * P, 2)
            smp = F.grid_sample(val, grid[:, None], mode="bilinear", padding_mode="zeros",
                                align_corners=False)[:, :, 0].reshape(B * H, C // H, S, P)
            wl = w[:, :, :, lvl].transpose(1, 2).reshape(B * H, 1, S, P)
            out = out + (smp * wl).sum(-1)
        return self.output_proj(out.reshape(B, C, S).transpose(1, 2))


class PixelDecoder(nn.Module):
    def __init__(self, pd):
        super().__init__()
        self.pd = pd
        C, n_in = pd["feat_channels"], len(pd["in_channels"])
        for i in range(pd["num_levels"]):
            self.add_module(f"input_conv_{i}", ConvGN(pd["in_channels"][n_in - i - 1], C))
        if pd["encoder"] == "axial":
            self.axial_encoder = AxialEncoder(pd)
        else:
            self.level_embed = nn.Parameter(torch.zeros(pd["num_levels"], C))
            for i in range(pd["encoder_layers"]):
                self.add_module(f"encoder_layer_{i}_attn", MSDeformAttn(
                    C, pd["num_heads"], pd["num_levels"], pd["num_points"]))
                self.add_module(f"encoder_layer_{i}_norm1", nn.LayerNorm(C, eps=LN_EPS))
                self.add_module(f"encoder_layer_{i}_ffn", FFN(pd["ffn_channels"], C))
                self.add_module(f"encoder_layer_{i}_norm2", nn.LayerNorm(C, eps=LN_EPS))
        self.lateral_conv_0 = ConvGN(pd["in_channels"][0], C)
        self.output_conv_0 = ConvGN(C, C, 3, act=True)
        self.mask_feature = Conv(C, pd["out_channels"], 1)

    def _msda(self, projs):
        B, C, dev = projs[0].shape[0], projs[0].shape[3], projs[0].device
        shapes = [tuple(p.shape[1:3]) for p in projs]
        x = torch.cat([p.reshape(B, -1, C) for p in projs], 1)
        pos = torch.cat([sine_pos(h, w, C, dev).reshape(h * w, C) + self.level_embed[i]
                         for i, (h, w) in enumerate(shapes)])[None]
        refs = []
        for h, w in shapes:
            ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
            xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            refs.append(torch.stack([gx, gy], -1).reshape(h * w, 2))
        ref = torch.cat(refs)[None].expand(B, -1, 2)
        for i in range(self.pd["encoder_layers"]):
            a = getattr(self, f"encoder_layer_{i}_attn")(x + pos, x, ref, shapes)
            x = getattr(self, f"encoder_layer_{i}_norm1")(x + a)
            x = getattr(self, f"encoder_layer_{i}_norm2")(getattr(self, f"encoder_layer_{i}_ffn")(x))
        parts = x.split([h * w for h, w in shapes], 1)
        return [t.reshape(B, h, w, C) for t, (h, w) in zip(parts, shapes)]

    def forward(self, feats):
        n_in = len(self.pd["in_channels"])
        projs = [getattr(self, f"input_conv_{i}")(feats[n_in - i - 1])
                 for i in range(self.pd["num_levels"])]
        outs = self.axial_encoder(projs) if self.pd["encoder"] == "axial" else self._msda(projs)
        lat = self.lateral_conv_0(feats[0])
        x = self.output_conv_0(lat + resize_bilinear(outs[-1], lat.shape[1:3]))
        mf = self.mask_feature(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return mf, outs


# ------------------------------------------------------------------ decoder

class DecoderLayer(nn.Module):
    def __init__(self, d):
        super().__init__()
        C = d["feat_channels"]
        self.cross_attn, self.norm1 = MHA(d["num_heads"], C), nn.LayerNorm(C, eps=LN_EPS)
        self.self_attn, self.norm2 = MHA(d["num_heads"], C), nn.LayerNorm(C, eps=LN_EPS)
        self.ffn, self.norm3 = FFN(d["ffn_channels"], C), nn.LayerNorm(C, eps=LN_EPS)

    def forward(self, q, qpos, feat, fpos, mask):
        q = self.norm1(q + self.cross_attn(q + qpos, feat + fpos, feat, mask))
        qp = q + qpos
        q = self.norm2(q + self.self_attn(qp, qp, q))
        return self.norm3(self.ffn(q))


class MaskEmbed(nn.Module):
    def __init__(self, C):
        super().__init__()
        self.fc0, self.fc1, self.fc2 = Dense(C, C), Dense(C, C), Dense(C, C)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(F.relu(self.fc0(x)))))


class Head(nn.Module):
    def __init__(self, m):
        super().__init__()
        d, C = m["decoder"], m["decoder"]["feat_channels"]
        self.layers, self.levels = d["num_layers"], m["num_transformer_feat_level"]
        self.query_feat = nn.Parameter(torch.zeros(m["num_queries"], C))
        self.query_embed = nn.Parameter(torch.zeros(m["num_queries"], C))
        self.level_embed = nn.Parameter(torch.zeros(self.levels, C))
        self.decoder_norm = nn.LayerNorm(C, eps=LN_EPS)
        self.cls_embed = Dense(C, m["num_things_classes"] + m["num_stuff_classes"] + 1)
        self.mask_embed = MaskEmbed(C)
        for i in range(self.layers):
            self.add_module(f"layer_{i}", DecoderLayer(d))

    def forward(self, mf, levels):
        """mf (N, h4, w4, C); levels [(N, h, w, C)] strides 32, 16, 8 ->
        (cls (N, Q, K+1), mask logits (N, Q, h4, w4), normed queries)."""
        N, C = mf.shape[0], mf.shape[3]
        feats, poss, lmf = [], [], []
        for lvl, f in enumerate(levels):
            h, w = f.shape[1:3]
            poss.append(sine_pos(h, w, C, f.device).reshape(1, h * w, C))
            feats.append(f.reshape(N, h * w, C) + self.level_embed[lvl])
            lmf.append(resize_bilinear(mf, (h, w)).reshape(N, h * w, C))
        Q = self.query_feat.shape[0]
        q = self.query_feat[None].expand(N, Q, C)
        qpos = self.query_embed[None].expand(N, Q, C)

        def head(q):
            out = self.decoder_norm(q)
            return self.cls_embed(out), self.mask_embed(out), out

        cls, membed, normed = head(q)
        for i in range(self.layers):
            lvl = i % self.levels
            attend = Rounding.einsum("nqc,nsc->nqs", membed, lmf[lvl]) >= 0.0
            attend = attend | ~attend.any(-1, keepdim=True)
            q = getattr(self, f"layer_{i}")(q, qpos, feats[lvl], poss[lvl], attend)
            cls, membed, normed = head(q)
        masks = Rounding.einsum("nqc,nhwc->nqhw", membed, mf)
        return cls, masks, normed


class Mask2Former(nn.Module):
    """``m``: the configuration file's ``model`` dict."""

    MEAN = (123.675, 116.28, 103.53)
    STD = (58.395, 57.12, 57.375)

    def __init__(self, m: dict):
        super().__init__()
        self.backbone = ResNet(m["backbone"]["depth"])
        self.pixel_decoder = PixelDecoder(m["pixel_decoder"])
        self.head = Head(m)

    def normalize(self, frames: torch.Tensor, pad_divisor: int = 32) -> torch.Tensor:
        """(N, H, W, 3) uint8 -> normalized float32, zero-padded to the
        divisor."""
        mean = torch.tensor(self.MEAN, device=frames.device)
        std = torch.tensor(self.STD, device=frames.device)
        x = (frames.float() - mean) / std
        H, W = x.shape[1:3]
        ph, pw = -(-H // pad_divisor) * pad_divisor, -(-W // pad_divisor) * pad_divisor
        return F.pad(x, (0, 0, 0, pw - W, 0, ph - H))

    def forward(self, frames: torch.Tensor):
        """frames (N, H, W, 3) uint8 -> (cls, mask logits of the padded
        frame at stride 4, queries)."""
        mf, levels = self.pixel_decoder(self.backbone(self.normalize(frames)))
        return self.head(mf, levels)


def state_shapes(m: dict) -> dict:
    """{state-dict key: shape} of the model of config ``m``."""
    with torch.device("meta"):
        model = Mask2Former(m)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def build(m: dict, state: dict, device) -> Mask2Former:
    with torch.device("meta"):
        model = Mask2Former(m)
    model = model.to_empty(device=device)
    missing, extra = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or extra:
        raise KeyError(f"reference state dict: missing {missing[:5]}, extra {extra[:5]}")
    return model.eval().requires_grad_(False)


def mask_features(model: Mask2Former, frames: torch.Tensor) -> torch.Tensor:
    """The pixel decoder's mask features (N, h4, w4, C) of uint8 frames, in
    float32 with TF32 off."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return model.pixel_decoder(model.backbone(model.normalize(frames)))[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def forward_frames(model: Mask2Former, frames: torch.Tensor, rounding: Optional[str] = None):
    """The float32 forward (TF32 off) of (N, H, W, 3) uint8 frames, one at
    a time so that it fits beside nothing else."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    Rounding.mode = rounding
    try:
        with torch.no_grad():
            outs = [model(frames[i:i + 1]) for i in range(len(frames))]
    finally:
        Rounding.mode = None
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return tuple(torch.cat(parts) for parts in zip(*outs))
