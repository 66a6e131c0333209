"""Appearance-encoder zoo of the tracker, the port of
``openpvsg_tpu/tracker/zoo.py``.

Rebuild of the UniTrack pluggable encoder registry (reference:
models/unitrack/model/model.py:89-147 make_encoder): every ResNet-family
entry maps onto the port's ResNet with the ``modify(remove_layers)``
semantics (reference resnet.py:30-51: trailing stages dropped, stride 1 on
layer3/4); the checkpoint surgery lives in
``openpvsg_torch/weights.py:convert_unitrack_checkpoint``.

Entries:
  imagenet18/34/50/101, random18/random50 — torchvision ResNets
  crw, uvc                                — resnet18-based self-supervised
  timecycle, mocov2, byol, + the SSL list — resnet50-based self-supervised
  random                                  — not ported (ROADMAP.md A11b)
hrnet variants are not rebuilt (the reference only exercises them for pose
experiments outside the PVSG pipeline); requesting one raises.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from openpvsg_torch.models.resnet import ResNet

SSL_MODELS = ("byol", "deepcluster-v2", "infomin", "insdis", "moco-v1",
              "moco-v2", "pcl-v1", "pcl-v2", "pirl", "sela-v2", "swav",
              "simclr-v1", "simclr-v2", "pixpro", "detco", "barlowtwins")

_R18 = ("crw", "uvc", "imagenet18", "random18")
_R34 = ("imagenet34",)
_R50 = ("imagenet50", "random50", "mocov2", "timecycle") + SSL_MODELS
_R101 = ("imagenet101",)


def make_encoder(model_type: str = "imagenet50",
                 remove_layers: Sequence[str] = ("layer4",),
                 norm: str = "frozen_bn") -> Tuple[ResNet, int]:
    """(module producing [feature_map], down_factor). The module maps
    (B, H, W, 3) ImageNet-normalized frames, channels last, to a single
    stride-``down_factor`` feature map: the ``modify(remove_layers)``-applied
    encoder."""
    if "hrnet" in model_type:
        raise NotImplementedError(
            "hrnet appearance encoders are not rebuilt (unused by the PVSG "
            "pipeline); see openpvsg_torch/tracker/zoo.py")
    if model_type == "random":
        # the JAX entry draws its features from JAX's threefry stream, which
        # no torch generator reproduces
        raise NotImplementedError(
            "the 'random' appearance encoder is not ported to openpvsg_torch "
            "(ROADMAP.md A11b)")

    if model_type in _R18:
        depth = 18
    elif model_type in _R34:
        depth = 34
    elif model_type in _R101:
        depth = 101
    elif model_type in _R50:
        depth = 50
    else:
        raise ValueError(f"unknown appearance model_type: {model_type!r}")

    removed = set(remove_layers or ())
    num_stages = 4
    for layer in ("layer4", "layer3", "layer2"):
        if layer in removed and num_stages == int(layer[-1]):
            num_stages -= 1
    # reference modify(): layer3/layer4 convs forced to stride 1
    strides = [1, 2, 2, 2][:num_stages]
    for i in (2, 3):
        if i < num_stages:
            strides[i] = 1
    down = 4 * (2 ** max(0, min(num_stages, 2) - 1))  # stem /4, stage2 /2
    model = ResNet(depth=depth, norm=norm, out_indices=(num_stages - 1,),
                   num_stages=num_stages, stage_strides=tuple(strides))
    return model, down
