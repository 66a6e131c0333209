"""Appearance embedding model and per-object masked feature extraction, the
port of ``openpvsg_tpu/tracker/appearance.py``.

Rebuild of the UniTrack appearance path (reference:
models/unitrack/model/model.py:89-147: ImageNet ResNet-50 cut after layer3
with down-factor 8, and models/unitrack/mask.py:21-45 extract_emb).

As in the JAX package, the frame's feature map is computed once per frame
on the device and each object's masked pixel-feature set is gathered with a
fixed budget of ``max_pixels`` (deterministic strided subsampling) instead
of the reference's dynamic-shape bilinear rescale to <= 300 px. The same
picks need the same nearest resize (``nearest-exact``: the half-pixel rule
of ``jax.image.resize``), a stable sort and the same float32 stride
arithmetic.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from openpvsg_torch.models.resnet import ResNet

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def make_appearance_model(norm: str = "frozen_bn", depth: int = 50,
                          model_type: str | None = None,
                          remove_layers=("layer4",)) -> ResNet:
    """Appearance encoder from the zoo (tracker/zoo.py). The default,
    ``imagenet50`` with layer4 removed, is the ``imagenet50 s3`` UniTrack
    entry the PVSG config uses (ResNet cut at layer3, stride 8). A depth
    that is no zoo entry (26 in the tests) builds the same cut ResNet."""
    if model_type is None and depth not in (18, 34, 50, 101):
        return ResNet(depth=depth, norm=norm, out_indices=(2,), num_stages=3,
                      stage_strides=(1, 2, 1))
    from openpvsg_torch.tracker.zoo import make_encoder

    if model_type is None:
        model_type = {18: "imagenet18", 34: "imagenet34", 50: "imagenet50",
                      101: "imagenet101"}[depth]
    model, _ = make_encoder(model_type, remove_layers, norm=norm)
    return model


def resolve_appearance_spec(tracker_cfg):
    """The one rule mapping tracker_cfg -> (depth, model_type,
    remove_layers) of the appearance encoder; every consumer (the stage-2
    CLI building weights, the tracker building its model, the weight
    converters) uses it, so their parameter sets agree.

    A non-default model_type selects the zoo entry (which fixes its own
    depth); otherwise appearance_depth decides (standard depths map to the
    imagenet zoo entries, other depths are the test-scale path)."""
    model_type = getattr(tracker_cfg, "model_type", "imagenet50")
    remove_layers = tuple(getattr(tracker_cfg, "remove_layers", ("layer4",)))
    depth = getattr(tracker_cfg, "appearance_depth", 50)
    if model_type != "imagenet50":
        return depth, model_type, remove_layers
    return depth, None, remove_layers


def _tensor(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))  # a copy: the array may be read-only
    return x.to(device)


@torch.no_grad()
def extract_object_embeddings(model: torch.nn.Module, frame, masks,
                              max_pixels: int = 256, max_mask_area: int = 300
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """frame: (H, W, 3) RGB in [0, 255] (uint8 or float, numpy or torch);
    masks: (N, H, W) binary. One device pass on the model's device, in IEEE
    float32 whatever the caller's TF32 settings.

    Returns (feats (N, max_pixels, D) channel-L2-normalized zero-padded
    pixel features, valid (N, max_pixels) bool), on the model's device."""
    from openpvsg_torch.train.segmenter import ieee_float32

    dev = next(model.parameters()).device
    with ieee_float32():
        x = _tensor(frame, dev).float() / 255.0
        x = ((x - torch.tensor(IMAGENET_MEAN, device=dev))
             / torch.tensor(IMAGENET_STD, device=dev))
        feat = model(x[None])[0][0]  # (h, w, D)
    h, w, d = feat.shape

    # nearest resize of the masks to the feature grid
    m = _tensor(masks, dev).float()
    m = F.interpolate(m[None], size=(h, w), mode="nearest-exact")[0] >= 0.5
    flat = m.reshape(m.shape[0], -1)
    area = flat.sum(1).to(torch.int32)                      # (N,)
    # active pixels first, in raster order (a stable sort, as jnp.argsort)
    order = torch.argsort((~flat).to(torch.uint8), dim=1, stable=True)
    # budget ~= max_mask_area active pixels: a deterministic strided
    # subsample when the object is larger (replaces the reference's
    # sqrt(max_area / area) rescale)
    take = torch.clamp(torch.clamp(area, max=max_mask_area), max=max_pixels)
    idx = torch.arange(max_pixels, device=dev)
    stride = torch.clamp(area.float() / torch.clamp(take, min=1).float(), min=1.0)
    pick = torch.minimum((idx[None, :].float() * stride[:, None]).to(torch.int32),
                         torch.clamp(area - 1, min=0)[:, None])
    sel = order.gather(1, pick.long())                      # (N, max_pixels)
    valid = idx[None, :] < take[:, None]
    f = feat.reshape(-1, d)[sel]                            # (N, max_pixels, D)
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=1e-12)
    return f * valid[..., None], valid


def mask_to_box(mask: np.ndarray, extend: int = 0) -> np.ndarray:
    """Binary mask -> tlbr box (reference: unitrack/utils/mask.py mask2box)."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return np.zeros(4)
    h, w = mask.shape
    return np.array([max(xs.min() - extend, 0), max(ys.min() - extend, 0),
                     min(xs.max() + extend, w - 1), min(ys.max() + extend, h - 1)],
                    dtype=np.float64)


def remove_duplicated_boxes(boxes: np.ndarray, iou_th: float = 0.7) -> np.ndarray:
    """Indices of boxes to keep, dropping later boxes that overlap an earlier
    one above iou_th (reference: unitrack/utils/box.py remove_duplicated_box)."""
    from openpvsg_torch.tracker.matching import box_ious

    n = len(boxes)
    if n == 0:
        return np.empty(0, dtype=int)
    ious = box_ious(boxes, boxes)
    keep = []
    for i in range(n):
        if all(ious[i, j] <= iou_th for j in keep):
            keep.append(i)
    return np.asarray(keep, dtype=int)
