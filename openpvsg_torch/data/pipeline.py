"""Host half of the test-time frame pipeline: decode frames and GT masks,
and pad geometry.
Normalization and padding themselves run inside the segmenter's forward
(``infer/segmenter.py``), so only uint8 frames cross to the device."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def load_frame(path: str) -> np.ndarray:
    """Decode an image to RGB uint8 (H, W, 3). Pillow is imported here and
    nowhere else: a caller that hands the stage uint8 arrays needs none."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_mask(path: str) -> np.ndarray:
    """Decode a palette mask PNG to its object-id map (H, W) int32. Pillow
    is imported here, as in ``load_frame``."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im).astype(np.int32)


def pad_to_divisor(h: int, w: int, divisor: int = 32) -> Tuple[int, int]:
    return ((h + divisor - 1) // divisor * divisor,
            (w + divisor - 1) // divisor * divisor)
