"""Work of a Swin configuration counted from shapes, as ``counts.py`` counts
it: the products only (the patch embedding, the linear layers, the two
attention einsums), two FLOPs per multiply-add, as
``torch.utils.flop_counter`` counts them; norms, softmaxes, the bias and
mask adds, rolls and pads are not counted. The blocks of a stage run on its
grid padded to multiples of the window, so the pad's tokens are counted.
The widths are ``reference/swin.py``'s ``VARIANTS``.
"""
from __future__ import annotations

from pvsgbench import counts
from pvsgbench.reference.model import STAGE_BLOCKS
from pvsgbench.reference.swin import VARIANTS


def _up(n: int, k: int) -> int:
    return -(-n // k) * k


def swin_flops(variant: str, H: int, W: int) -> float:
    """The Swin backbone on one (H, W) frame."""
    C, depths, _, window = VARIANTS[variant]
    L = window * window
    h, w = -(-H // 4), -(-W // 4)
    total = 2.0 * 3 * C * 16 * h * w                       # patch embedding
    for s, n in enumerate(depths):
        N = _up(h, window) * _up(w, window)
        # qkv, proj and the 4x MLP: 12 C² per token; q.k and attn.v: 2 L C
        total += n * (2.0 * N * 12 * C * C + 2 * 2.0 * N * L * C)
        if s < len(depths) - 1:
            h, w = -(-h // 2), -(-w // 2)
            total += 2.0 * h * w * 4 * C * 2 * C           # patch merging
            C *= 2
    return total


def backbone_flops_per_frame(m: dict, hw) -> float:
    """The configuration's backbone on one frame of ``hw``, padded as the
    program pads it: a Swin by ``swin_flops``, a ResNet by
    ``counts.backbone_flops``."""
    H, W = counts.padded_hw(hw)
    b = m["backbone"]
    if b["kind"] == "swin":
        return swin_flops(b["swin_variant"], H, W)
    return counts.backbone_flops(STAGE_BLOCKS[b["depth"]], H, W)


def segmenter_flops_per_frame(m: dict, hw) -> float:
    """One frame's serving forward: the backbone, the pixel encoder, kernel
    B1's stride-4 chain and the decoder, at the configuration's queries."""
    H, W = counts.padded_hw(hw)
    pd = m["pixel_decoder"]
    fpn = sum(ops for ops, _ in counts.fpn_counts(1, H // 4, W // 4, pd["in_channels"][0],
                                                  pd["feat_channels"],
                                                  pd["out_channels"]).values())
    return (backbone_flops_per_frame(m, hw) + counts.encoder_flops(pd, H, W) + fpn
            + counts.decoder_flops(m, H, W))
