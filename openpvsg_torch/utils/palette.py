"""Deterministic color palette and panoptic colorization for visualization
(reference: models/unitrack/utils/palette.py + vis.plot_tracking); the
port's copy of ``openpvsg_tpu/utils/palette.py``."""
from __future__ import annotations

import numpy as np


def color_for(idx: int) -> tuple:
    """Stable, well-spread RGB color for an integer id (golden-ratio hue)."""
    h = (idx * 0.61803398875) % 1.0
    i = int(h * 6)
    f = h * 6 - i
    v, p, q, t = 255, 64, int(255 - 191 * f), int(64 + 191 * f)
    rgb = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)][i % 6]
    return rgb


def colorize_panoptic(pan_map: np.ndarray, void_id: int | None = None) -> np.ndarray:
    """Segment-id map (H, W) -> RGB uint8 visualization; void painted black."""
    out = np.zeros((*pan_map.shape, 3), np.uint8)
    for seg_id in np.unique(pan_map):
        if void_id is not None and seg_id == void_id:
            continue
        out[pan_map == seg_id] = color_for(int(seg_id))
    return out
