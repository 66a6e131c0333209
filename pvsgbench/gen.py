"""Inputs made from ``--seed``: the segmenter's weights, made on the device in
a few large draws, and synthetic videos.

Weights follow the port's ``random_state_dict`` scheme: weights ~ N(0,
1/fan_in), biases 0, norm scales 1, embeddings ~ N(0, 1), BatchNorm running
mean 0 and variance 1 + U(0, 0.1), and the MSDA layers as mmcv starts them
(zero ``sampling_offsets`` weight with the directional grid as its bias,
zero ``attention_weights``), so that random weights sample around each
reference point.

Videos are uniform noise with a static floor strip and moving rectangles
of flat colour (the port's ``chip_smoke.synthetic_frames``, drawn from a
seed): noise keeps the backbone busy on every pixel, the rectangles give the
segmenter objects that persist across frames.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from pvsgbench.reference.model import msda_offset_bias, state_shapes


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one named stream of the seed, so that
    weights and frames draw independently of each other."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def rng(seed: int, *streams: int) -> np.random.Generator:
    """A host generator for the seed (any whole number) and named streams."""
    return np.random.default_rng([int(seed) % (2 ** 63), *streams])


def _init_kind(key: str, shape) -> str:
    scope, leaf = key.rsplit(".", 1)
    if scope.endswith(("_attn.sampling_offsets", "_attn.attention_weights")):
        return "offset_bias" if key.endswith("sampling_offsets.bias") else "zero"
    if leaf == "weight":
        return "fan_in" if len(shape) >= 2 else "one"
    if leaf == "running_var":
        return "running_var"
    if leaf in ("bias", "running_mean"):
        return "zero"
    return "normal"  # query_feat, query_embed, level_embed


def segmenter_weights(m: dict, seed: int, device, frame_hw=None) -> Dict[str, torch.Tensor]:
    """float32 state dict of the configuration's segmenter on ``device``.

    With ``frame_hw`` the mask features' bias is then set to centre them on
    one frame of that size drawn from the seed (the plain reference's
    forward, float32): random weights otherwise shift every query's mask
    logits by one offset whose sign the seed draws, so that one seed's
    frames hold no segment and another's are all segment, and the work
    changes with the seed."""
    shapes = state_shapes(m)
    pd = m["pixel_decoder"]
    kinds = {key: _init_kind(key, shape) for key, shape in shapes.items()}
    gen = generator(seed, device, stream=1)
    flat = torch.randn(sum(math.prod(shapes[k]) for k, v in kinds.items()
                           if v in ("fan_in", "normal")), generator=gen, device=device)
    flat_var = torch.rand(sum(math.prod(shapes[k]) for k, v in kinds.items()
                              if v == "running_var"), generator=gen, device=device)
    offset_bias = torch.from_numpy(msda_offset_bias(
        pd["num_heads"], pd["num_levels"], pd["num_points"]).astype(np.float32)).to(device)
    out, i, j = {}, 0, 0
    for key, shape in shapes.items():
        kind, n = kinds[key], math.prod(shape)
        if kind == "offset_bias":
            t = offset_bias.clone()
        elif kind == "running_var":
            t = 1.0 + 0.1 * flat_var[j:j + n].view(shape)
            j += n
        elif kind in ("fan_in", "normal"):
            t = flat[i:i + n].view(shape).clone()
            if kind == "fan_in":
                t /= math.sqrt(math.prod(shape[1:]))
            i += n
        else:
            t = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device)
        out[key] = t
    if frame_hw is not None:
        from pvsgbench.reference.model import build, mask_features

        frame = video(seed, 10 ** 6, 1, frame_hw, device, 4)
        mf = mask_features(build(m, out, device), frame)
        out["pixel_decoder.mask_feature.bias"] = -mf.mean((0, 1, 2))
    return out


def video(seed: int, index: int, n_frames: int, hw: Sequence[int], device,
          n_blobs: int) -> torch.Tensor:
    """(T, H, W, 3) uint8 frames on ``device``: noise, a floor strip of one
    colour over the bottom sixth, and ``n_blobs`` rectangles moving in
    straight lines, bouncing off the borders."""
    H, W = int(hw[0]), int(hw[1])
    gen = generator(seed, device, stream=100 + index)
    frames = torch.randint(0, 256, (n_frames, H, W, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    frames[:, H - H // 6:] = torch.randint(0, 256, (3,), generator=gen, device=device,
                                           dtype=torch.uint8)
    draw = rng(seed, 1, index)
    t = torch.arange(n_frames, device=device, dtype=torch.float32)[:, None, None]
    ys = torch.arange(H, device=device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(W, device=device, dtype=torch.float32)[None, None, :]
    for _ in range(n_blobs):
        bh, bw = int(draw.integers(H // 8, H // 3)), int(draw.integers(W // 8, W // 3))
        y0, x0 = draw.uniform(0, H - bh), draw.uniform(0, W - bw)
        vy, vx = draw.uniform(-4, 4), draw.uniform(-6, 6)

        def bounce(p0, v, span):
            p = (p0 + v * t) % (2 * span)
            return torch.where(p > span, 2 * span - p, p)

        top, left = bounce(y0, vy, H - bh), bounce(x0, vx, W - bw)
        inside = (ys >= top) & (ys < top + bh) & (xs >= left) & (xs < left + bw)
        colour = torch.as_tensor(draw.integers(0, 256, 3), dtype=torch.uint8, device=device)
        frames[inside] = colour
    return frames
