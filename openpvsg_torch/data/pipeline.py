"""Frame pipeline: decode frames and GT masks on the host, the train clip's
resize -> flip -> crop -> normalize -> pad, the test frame's normalize ->
pad, and the clip-consistent augmentation draws (the port of
``openpvsg_tpu/data/pipeline.py``; reference:
datasets/pipelines/{loading,transforms,formatting}.py,
configs/_base_/datasets/pvsg_vps.py:4-22).

Normalization uses mean (123.675, 116.28, 103.53) / std (58.395, 57.12,
57.375) on RGB-loaded frames (to_rgb=False). Stage 2 and the test CLI
normalize and pad inside the segmenter's forward instead
(``infer/segmenter.py``), so only uint8 crosses to the device there.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from openpvsg_torch.config import DataConfig

MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


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


def preprocess_clip(frames, out_h: int, out_w: int, flip: bool,
                    crop_y: int, crop_x: int, crop_h: int, crop_w: int,
                    pad_h: int, pad_w: int,
                    mean: Tuple[float, float, float] = MEAN,
                    std: Tuple[float, float, float] = STD,
                    device="cpu") -> torch.Tensor:
    """(T, H, W, 3) uint8 -> (T, pad_h, pad_w, 3) float32 on ``device``:
    bilinear resize to (out_h, out_w) (half-pixel centers, no antialias, as
    ``jax.image.resize(..., antialias=False)``), horizontal flip, crop,
    normalize and zero pad, in float32 throughout."""
    x = torch.as_tensor(np.asarray(frames), device=device).float()
    x = x.permute(0, 3, 1, 2)
    if tuple(x.shape[2:]) != (out_h, out_w):
        x = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                          align_corners=False, antialias=False)
    if flip:
        x = x.flip(-1)
    x = x[:, :, crop_y:crop_y + crop_h, crop_x:crop_x + crop_w]
    x = x.permute(0, 2, 3, 1)
    x = ((x - torch.tensor(mean, device=x.device))
         / torch.tensor(std, device=x.device))
    return F.pad(x, (0, 0, 0, pad_w - crop_w, 0, pad_h - crop_h))


def preprocess_test_frame(frame, pad_h: int, pad_w: int,
                          mean: Tuple[float, float, float] = MEAN,
                          std: Tuple[float, float, float] = STD,
                          device="cpu") -> torch.Tensor:
    """Test pipeline: (H, W, 3) uint8 -> normalized float32, zero padded
    at the bottom and right to (pad_h, pad_w) (reference:
    configs/_base_/datasets/pvsg_vps_single_video_test.py:10-17)."""
    x = torch.as_tensor(np.asarray(frame), device=device).float()
    x = ((x - torch.tensor(mean, device=x.device))
         / torch.tensor(std, device=x.device))
    h, w = x.shape[:2]
    return F.pad(x, (0, 0, 0, pad_w - w, 0, pad_h - h))


def resize_mask_nearest(mask: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Host nearest resize of an id map (mmcv uses nearest for seg maps)."""
    from PIL import Image

    img = Image.fromarray(mask.astype(np.int32))  # mode "I"
    img = img.resize((out_hw[1], out_hw[0]), Image.NEAREST)
    return np.asarray(img).astype(np.int32)


class TrainAugmentor:
    """Clip-consistent augmentation draws and the GT's transformation (the
    host half of the Seq* transforms): the same ``np.random.default_rng``
    draws, in the same order, as the JAX package's."""

    def __init__(self, cfg: DataConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)

    def sample(self, img_hw: Tuple[int, int]):
        ch, cw = self.cfg.crop_size
        oh, ow = self.cfg.train_scale
        flip = bool(self.rng.random() < self.cfg.flip_prob)
        crop_y = int(self.rng.integers(0, max(oh - ch, 0) + 1))
        crop_x = int(self.rng.integers(0, max(ow - cw, 0) + 1))
        return {"flip": flip, "crop_y": crop_y, "crop_x": crop_x}

    def apply_to_masks(self, masks: np.ndarray, params: Dict) -> np.ndarray:
        """masks: (T, H, W) id maps -> resized/flipped/cropped id maps."""
        oh, ow = self.cfg.train_scale
        ch, cw = self.cfg.crop_size
        out = np.stack([resize_mask_nearest(m, (oh, ow)) for m in masks])
        if params["flip"]:
            out = out[:, :, ::-1]
        y, x = params["crop_y"], params["crop_x"]
        return out[:, y:y + ch, x:x + cw]

    def check_match(self, masks: np.ndarray) -> bool:
        """True if at least one instance id persists in EVERY cropped frame
        (reference: transforms.py:262-267 rejects clips otherwise)."""
        ids = None
        for m in masks:
            present = set(np.unique(m)) - {0}
            ids = present if ids is None else (ids & present)
        return bool(ids)
