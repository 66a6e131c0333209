"""Work counted from shapes: the segmenter's FLOPs per frame, kernel B1's and
B2's operations and bytes, the H100's peaks and the roofline bound.

The counts never read the port: each roofline and MFU reads the same work
whatever implements it. FLOPs are those of the products (convolutions,
matrix products, attention einsums), two per multiply-add, as
``torch.utils.flop_counter`` counts them; the MSDA taps (``grid_sample``),
norms, softmaxes and resizes are not counted. A dtype is counted as the
configuration states it.
"""
from __future__ import annotations

from typing import Dict, Tuple

# one NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float, peak: str) -> Tuple[float, str]:
    """The least time the chip could take: the larger of the operations over
    the peak rate and the bytes over the memory bandwidth, and which."""
    t_ops, t_bytes = flops / PEAK_FLOPS[peak], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def padded_hw(hw, divisor: int = 32) -> Tuple[int, int]:
    return tuple(-(-int(x) // divisor) * divisor for x in hw)


def _conv(cin, cout, k, h, w) -> float:
    return 2.0 * cin * cout * k * k * h * w


def backbone_flops(depth_blocks, H: int, W: int) -> float:
    """R-50 style bottlenecks on an (H, W) input (multiples of 32)."""
    h, w = H // 2, W // 2
    total = _conv(3, 64, 7, h, w)
    h, w = h // 2, w // 2
    cin, planes = 64, 64
    for s, n in enumerate(depth_blocks):
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            ho, wo = h // stride, w // stride
            total += _conv(cin, planes, 1, h, w) + _conv(planes, planes, 3, ho, wo)
            total += _conv(planes, 4 * planes, 1, ho, wo)
            if b == 0:
                total += _conv(cin, 4 * planes, 1, ho, wo)
            cin, h, w = 4 * planes, ho, wo
        planes *= 2
    return total


def level_shapes(H: int, W: int):
    """Encoder levels of an (H, W) padded frame: strides 32, 16, 8."""
    return [(H // s, W // s) for s in (32, 16, 8)]


def encoder_flops(pd: dict, H: int, W: int) -> float:
    C, F, L = pd["feat_channels"], pd["ffn_channels"], pd["encoder_layers"]
    levels = level_shapes(H, W)
    n_in = len(pd["in_channels"])
    total = sum(2.0 * h * w * pd["in_channels"][n_in - i - 1] * C
                for i, (h, w) in enumerate(levels))
    if pd["encoder"] == "axial":
        per_layer = 0.0
        for j, (h, w) in enumerate(levels):
            n = h * w
            per_layer += 2 * (4 * 2.0 * n * C * C)          # row and column projections
            per_layer += 2 * 2.0 * n * w * C + 2 * 2.0 * n * h * C  # logits and values
            per_layer += 2 * 2.0 * n * C * F                 # FFN
            if j:
                per_layer += 2.0 * n * C * C                 # the cross-scale mix
        return total + L * per_layer
    S = sum(h * w for h, w in levels)
    hlp = pd["num_heads"] * pd["num_levels"] * pd["num_points"]
    per_layer = 2.0 * S * C * (2 * C + 3 * hlp) + 2 * 2.0 * S * C * F
    return total + L * per_layer


def fpn_counts(B: int, H4: int, W4: int, cin: int, C: int, cout: int,
               dtype: str = "bfloat16") -> Dict[str, Tuple[float, float]]:
    """{launch: (operations, bytes)} of kernel B1's three launches on B
    frames of (H4, W4) stride-4 pixels: the products and GroupNorm sums,
    each input read once and each output written once (the sums as the
    (B, C) pairs the chain uses)."""
    e = DTYPE_BYTES[dtype]
    M = B * H4 * W4
    sums = 2 * B * C * 4
    return {
        "lateral_stats": (2.0 * M * cin * C, M * cin * e + cin * C * e + C * 4 + M * C * e + sums),
        "conv3x3_stats": (2.0 * M * 9 * C * C,
                          M * C * e + (M // 4) * C * e + 9 * C * C * e + 3 * C * 4
                          + sums + M * C * e + sums),
        "mask_proj": (2.0 * M * C * cout,
                      M * C * e + sums + C * cout * e + cout * 4 + M * cout * e),
    }


# FP32 operations per query-pixel pair of B2: a quarter of a horizontal blend
# (a 4x upsample shares each across four output rows), a vertical blend (3)
# and the threshold
FUSION_PAIR_FLOPS = 0.25 * 3 + 3 + 1


def fusion_counts(N: int, Q: int, h: int, w: int) -> Tuple[float, float]:
    """(operations, bytes) of kernel B2 on N frames of Q stride-4 logit maps
    (h, w): float32 logits and scores read, int32 owner and bool binary
    written at 4x, the two int32 area vectors. The exact sigmoids it needs
    depend on the logits and are left out, so the bound is a lower one."""
    pairs = N * Q * 16 * h * w
    nbytes = N * Q * h * w * 4 + N * Q * 4 + N * 16 * h * w * 5 + 2 * N * Q * 4
    return FUSION_PAIR_FLOPS * pairs, nbytes


def decoder_flops(m: dict, H: int, W: int) -> float:
    d = m["decoder"]
    C, F, Q = d["feat_channels"], d["ffn_channels"], m["num_queries"]
    K1 = m["num_things_classes"] + m["num_stuff_classes"] + 1
    levels = level_shapes(H, W)
    head = 2.0 * Q * C * K1 + 3 * 2.0 * Q * C * C
    total = head
    for i in range(d["num_layers"]):
        S = levels[i % m["num_transformer_feat_level"]]
        S = S[0] * S[1]
        total += 2.0 * Q * S * C                       # the attention mask
        total += 2 * 2.0 * Q * C * C + 2 * 2.0 * S * C * C + 2 * 2.0 * Q * S * C
        total += 4 * 2.0 * Q * C * C + 2 * 2.0 * Q * Q * C
        total += 2 * 2.0 * Q * C * F
        total += head
    return total + 2.0 * Q * (H // 4) * (W // 4) * m["pixel_decoder"]["out_channels"]


def segmenter_flops_per_frame(m: dict, hw) -> float:
    """FLOPs of one frame's serving forward at the padded size of ``hw``."""
    H, W = padded_hw(hw)
    pd = m["pixel_decoder"]
    blocks = {26: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[m["backbone"]["depth"]]
    H4, W4 = H // 4, W // 4
    C = pd["feat_channels"]
    fpn = sum(ops for ops, _ in fpn_counts(1, H4, W4, pd["in_channels"][0], C,
                                           pd["out_channels"]).values())
    return (backbone_flops(blocks, H, W) + encoder_flops(pd, H, W) + fpn
            + decoder_flops(m, H, W))
