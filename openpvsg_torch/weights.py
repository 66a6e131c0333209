"""Weights for the port: conversion from and to the JAX package's flax
variables, and random weights from a seed.

``from_jax_params`` inverts the layout changes of
``openpvsg_tpu/train/checkpoint.py:101-155``: the torch module names are the
flax scope paths joined by '.', and leaves map as

  conv ``kernel`` (kh, kw, in, out)  -> ``weight`` (out, in, kh, kw)
  Dense ``kernel`` (in, out)         -> ``weight`` (out, in)
  LayerNorm/GroupNorm/BN ``scale``   -> ``weight``
  BN batch stats ``mean`` / ``var``  -> ``running_mean`` / ``running_var``

Other leaves (``bias``, ``query_feat``, ``level_embed``, Swin's
``rel_bias_table`` (a bare (table, heads) parameter), ...) keep their name;
a bias-free Dense (Swin's ``downsample{s}.reduction``) has no ``bias`` on
either side. A key the port's model does not have, or a model key the tree does not
provide, raises, as ``check_no_extra_params`` does for flax.
``to_jax_params`` is the inverse walk; ``flax_path`` names one key's flax
leaf (the trainer's parameter groups are defined on those paths).

``relation_from_jax_params`` / ``relation_to_jax_params`` make the same walk
for the relation head (``openpvsg_tpu.models.relation.heads.RelationModel``),
whose 1-D convs also map ``kernel`` (k, in, out) -> ``weight`` (out, in, k),
and whose pair proposal keeps its raw ``fc1_kernel`` (2D, H) and
``fc1_bias`` in the flax layout (their names are not ``kernel``).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from openpvsg_torch.config import Mask2FormerConfig, RelationHeadConfig

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _convert_leaf(path, value) -> tuple:
    arr = np.asarray(value, dtype=np.float32)
    *scope, leaf = path
    if leaf == "kernel":
        leaf = "weight"
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
    else:
        leaf = _RENAME.get(leaf, leaf)
    return ".".join((*scope, leaf)), torch.from_numpy(np.array(arr, copy=True))


def _to_flax_leaf(key: str, t: torch.Tensor):
    """The inverse of ``_convert_leaf``: (flax collection, path, array)."""
    arr = t.detach().cpu().float().numpy()
    coll, path = flax_path(key, arr.ndim)
    if path[-1] == "kernel":
        arr = arr.transpose({4: (2, 3, 1, 0), 3: (2, 1, 0), 2: (1, 0)}[arr.ndim])
    return coll, path, np.ascontiguousarray(arr)


def _nest(leaves) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for coll, path, arr in leaves:
        node = out.setdefault(coll, {})
        for s_ in path[:-1]:
            node = node.setdefault(s_, {})
        node[path[-1]] = arr
    return out


def expected_shapes(cfg: Mask2FormerConfig) -> Dict[str, tuple]:
    """{state-dict key: shape} of the port's model for ``cfg``, built on the
    meta device (no memory, no arithmetic)."""
    from openpvsg_torch.models.mask2former import Mask2Former

    with torch.device("meta"):
        model = Mask2Former(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _check_keys(keys, want: Dict[str, tuple], what: str) -> Dict[str, tuple]:
    extra = sorted(set(keys) - set(want))
    missing = sorted(set(want) - set(keys))
    problems = []
    if extra:
        problems.append(f"{len(extra)} keys the configured model does not "
                        f"use {extra[:8]}")
    if missing:
        problems.append(f"{len(missing)} keys the {what} lacks {missing[:8]}")
    if problems:
        raise ValueError("; ".join(problems))
    return want


def flax_path(key: str, ndim: int) -> Tuple[str, Tuple[str, ...]]:
    """A state-dict key of the port's model -> (flax collection, path of
    the flax leaf), e.g. ``backbone.bn1.bn.weight`` -> ('params',
    ('backbone', 'bn1', 'bn', 'scale'))."""
    *scope, leaf = key.split(".")
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", (*scope, leaf[len("running_"):])
    if leaf == "weight":
        leaf = "kernel" if ndim >= 2 else "scale"
    return "params", (*scope, leaf)


def to_jax_params(state_dict: Mapping[str, torch.Tensor],
                  cfg: Mask2FormerConfig) -> Dict[str, dict]:
    """A state dict of ``Mask2Former(cfg)`` -> ``{"params",
    "batch_stats"}`` nested dicts of float32 numpy arrays in the flax
    layout (the inverse of ``from_jax_params``); raises on a key the model
    does not have or lacks."""
    try:
        _check_keys(state_dict, expected_shapes(cfg), "state dict")
    except ValueError as e:
        raise ValueError(f"to_jax_params: {e}") from None
    return {"params": {}, "batch_stats": {},
            **_nest(_to_flax_leaf(k, t) for k, t in state_dict.items())}


def _from_flax(leaves, want: Dict[str, tuple], fn: str) -> Dict[str, torch.Tensor]:
    state: Dict[str, torch.Tensor] = {}
    for path, value in leaves:
        key, t = _convert_leaf(path, value)
        if key in state:
            raise ValueError(f"two flax leaves map to '{key}'")
        state[key] = t
    try:
        _check_keys(state, want, "tree")
    except ValueError as e:
        raise ValueError(f"{fn}: {e}") from None
    bad = [(k, tuple(state[k].shape), s) for k, s in want.items()
           if tuple(state[k].shape) != s]
    if bad:
        raise ValueError(f"{fn}: shape mismatches {bad[:8]}")
    return state


def from_jax_params(variables: Mapping, cfg: Mask2FormerConfig
                    ) -> Dict[str, torch.Tensor]:
    """Flax variables of ``openpvsg_tpu.models.mask2former.Mask2Former``
    (``params``, plus ``batch_stats`` when present; leaves are anything
    numpy can read) -> a float32 state dict for
    ``openpvsg_torch.models.mask2former.Mask2Former(cfg)``."""
    leaves = [leaf for coll in ("params", "batch_stats")
              for leaf in _flatten(variables.get(coll, {}))]
    return _from_flax(leaves, expected_shapes(cfg), "from_jax_params")


def random_state_dict(cfg: Mask2FormerConfig, seed: int
                      ) -> Dict[str, torch.Tensor]:
    """Random float32 weights for ``Mask2Former(cfg)`` from an explicit
    ``torch.Generator``: weights ~ N(0, 1/fan_in), biases 0, norm scales 1,
    embeddings ~ N(0, 1), Swin's relative position bias tables ~ N(0,
    0.02²) (flax's init), BN running mean 0 and variance 1 plus noise. The
    MSDA layers start as flax starts them: ``sampling_offsets`` with a zero
    weight and the directional grid as bias, ``attention_weights`` zero,
    so that random weights sample around each reference point."""
    from openpvsg_torch.models.pixel_decoder import msda_offset_bias

    pd = cfg.pixel_decoder
    offset_bias = torch.from_numpy(msda_offset_bias(
        pd.num_heads, pd.num_levels, pd.num_points).astype(np.float32))
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, shape in expected_shapes(cfg).items():
        scope, leaf = key.rsplit(".", 1)
        if scope.endswith(("_attn.sampling_offsets", "_attn.attention_weights")):
            t = (offset_bias.clone() if key.endswith("sampling_offsets.bias")
                 else torch.zeros(shape))
        elif leaf == "weight" and len(shape) >= 2:
            fan_in = math.prod(shape[1:])
            t = torch.randn(shape, generator=gen) / math.sqrt(fan_in)
        elif leaf == "weight":
            t = torch.ones(shape)
        elif leaf == "running_var":
            t = 1.0 + 0.1 * torch.rand(shape, generator=gen)
        elif leaf in ("bias", "running_mean"):
            t = torch.zeros(shape)
        elif leaf == "rel_bias_table":
            t = 0.02 * torch.randn(shape, generator=gen)
        else:  # query_feat, query_embed, level_embed
            t = torch.randn(shape, generator=gen)
        out[key] = t
    return out


def relation_expected_shapes(cfg: RelationHeadConfig) -> Dict[str, tuple]:
    """{state-dict key: shape} of ``RelationModel.from_config(cfg)``, built
    on the meta device."""
    from openpvsg_torch.models.relation.heads import RelationModel

    with torch.device("meta"):
        model = RelationModel.from_config(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def relation_from_jax_params(params: Mapping, cfg: RelationHeadConfig
                             ) -> Dict[str, torch.Tensor]:
    """The flax ``params`` of ``openpvsg_tpu``'s ``RelationModel`` (leaves
    anything numpy can read) -> a float32 state dict of the port's
    ``RelationModel.from_config(cfg)``; raises on a key missing or left
    over and on a shape that does not fit."""
    return _from_flax(_flatten(params), relation_expected_shapes(cfg),
                      "relation_from_jax_params")


def relation_to_jax_params(state_dict: Mapping[str, torch.Tensor],
                           cfg: RelationHeadConfig) -> Dict[str, dict]:
    """The inverse of ``relation_from_jax_params``: a state dict of the
    port's ``RelationModel`` -> nested flax ``params`` of float32 numpy
    arrays."""
    try:
        _check_keys(state_dict, relation_expected_shapes(cfg), "state dict")
    except ValueError as e:
        raise ValueError(f"relation_to_jax_params: {e}") from None
    return _nest(_to_flax_leaf(k, t) for k, t in state_dict.items())["params"]


def random_relation_state_dict(cfg: RelationHeadConfig, seed: int
                               ) -> Dict[str, torch.Tensor]:
    """Random float32 weights for ``RelationModel.from_config(cfg)`` from an
    explicit ``torch.Generator``, as flax initializes them in scale:
    weights ~ N(0, 1/fan_in), biases 0, LayerNorm scales 1."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, shape in relation_expected_shapes(cfg).items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "fc1_kernel":  # flax layout (in, out)
            t = torch.randn(shape, generator=gen) / math.sqrt(shape[0])
        elif leaf == "weight" and len(shape) >= 2:
            t = torch.randn(shape, generator=gen) / math.sqrt(math.prod(shape[1:]))
        elif leaf == "weight":
            t = torch.ones(shape)
        else:
            t = torch.zeros(shape)
        out[key] = t
    return out


def appearance_expected_shapes(tracker_cfg) -> Dict[str, tuple]:
    """{state-dict key: shape} of the appearance encoder that
    ``resolve_appearance_spec(tracker_cfg)`` names, built on the meta
    device."""
    from openpvsg_torch.tracker.appearance import (make_appearance_model,
                                                   resolve_appearance_spec)

    depth, model_type, remove_layers = resolve_appearance_spec(tracker_cfg)
    with torch.device("meta"):
        model = make_appearance_model(depth=depth, model_type=model_type,
                                      remove_layers=remove_layers)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def appearance_state(state: Mapping[str, torch.Tensor], tracker_cfg
                     ) -> Dict[str, torch.Tensor]:
    """A ResNet state dict in the port's names (all four stages, as a
    torchvision checkpoint has them) -> the appearance encoder's: the stages
    the encoder removed are dropped (the reference's ``modify
    (remove_layers)``); any other key missing or left over, or a shape that
    does not fit, raises."""
    want = appearance_expected_shapes(tracker_cfg)
    kept_stages = {k.split("_", 1)[0] for k in want if k.startswith("layer")}
    state = {k: v for k, v in state.items()
             if not k.startswith("layer") or k.split("_", 1)[0] in kept_stages}
    _check_keys(state, want, "state dict")
    bad = [(k, tuple(state[k].shape), s) for k, s in want.items()
           if tuple(state[k].shape) != s]
    if bad:
        raise ValueError(f"shape mismatches {bad[:8]}")
    return dict(state)


def appearance_from_jax_params(variables: Mapping, tracker_cfg
                               ) -> Dict[str, torch.Tensor]:
    """Flax variables (``params`` and ``batch_stats``) of the JAX package's
    appearance encoder (``openpvsg_tpu.tracker.appearance
    .make_appearance_model``, or ``train.checkpoint
    .convert_torchvision_resnet``'s whole-ResNet tree) -> a float32 state
    dict of the port's encoder for ``tracker_cfg``."""
    state: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(coll, {})):
            key, t = _convert_leaf(path, value)
            state[key] = t
    try:
        return appearance_state(state, tracker_cfg)
    except ValueError as e:
        raise ValueError(f"appearance_from_jax_params: {e}") from None


def random_appearance_state_dict(tracker_cfg, seed: int
                                 ) -> Dict[str, torch.Tensor]:
    """Random float32 weights of the appearance encoder from an explicit
    ``torch.Generator``: conv weights ~ N(0, 2/fan_in) (He, so the features
    keep their scale through the cut ResNet), BN scales 1 and biases 0,
    running mean 0 and variance 1 plus noise."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, shape in appearance_expected_shapes(tracker_cfg).items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shape) >= 2:
            t = torch.randn(shape, generator=gen) * math.sqrt(2.0 / math.prod(shape[1:]))
        elif leaf == "weight":
            t = torch.ones(shape)
        elif leaf == "running_var":
            t = 1.0 + 0.1 * torch.rand(shape, generator=gen)
        else:
            t = torch.zeros(shape)
        out[key] = t
    return out


def convert_torchvision_resnet(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet state dict (no prefix; tensors or arrays) -> the
    same weights in the port's ResNet names (``layer1.0.conv1`` ->
    ``layer1_0.conv1``, ``bn1`` -> ``bn1.bn``, ``downsample.0/1`` ->
    ``downsample_conv`` / ``downsample_bn.bn``), float32; ``fc`` and
    ``num_batches_tracked`` are dropped. The port's copy of
    ``openpvsg_tpu/train/checkpoint.py:294``, without the flax layout."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        parts = key.split(".")
        if parts[0] == "fc" or parts[-1] == "num_batches_tracked":
            continue
        scope, rest = [], parts
        if parts[0].startswith("layer"):
            scope, rest = [f"{parts[0]}_{parts[1]}"], parts[2:]
            if rest[0] == "downsample":
                rest = ["downsample_conv" if rest[1] == "0" else "downsample_bn"] + rest[2:]
        if rest[0].startswith(("bn", "downsample_bn")):
            rest = [rest[0], "bn"] + rest[1:]
        out[".".join(scope + rest)] = torch.from_numpy(
            np.array(value, dtype=np.float32, copy=True))
    return out


def convert_unitrack_checkpoint(raw: Mapping, model_type: str
                                ) -> Dict[str, torch.Tensor]:
    """Checkpoint surgery for the UniTrack appearance zoo (reference:
    models/unitrack/model/model.py:40-147): per-entry key renames onto a
    plain torchvision ResNet state dict, then ``convert_torchvision_resnet``.
    Keys that do not map (projection heads etc.) are dropped: the
    reference's partial_load semantics. The port's copy of
    ``openpvsg_tpu/train/checkpoint.py:305``."""
    sd = {}
    for k, v in raw.items():
        nk = None
        if model_type == "crw":
            k2 = k
            if "conv1.1.weight" in k2 or "conv2.1.weight" in k2:
                k2 = k2.replace(".1.weight", ".weight")
            nk = k2.replace("encoder.model.", "") if "encoder.model" in k2 else k2
            if "head" in nk:
                nk = None
        elif model_type == "uvc":
            if "gray_encoder" in k:
                nk = k.replace("module.gray_encoder.", "")
        elif model_type == "timecycle":
            if "encoderVideo" in k:
                nk = k.replace("module.encoderVideo.", "")
                v = np.asarray(v)
                if v.ndim == 5:  # inflated 3-D conv -> squeeze the T tap
                    v = v.squeeze(2)
        elif model_type in ("mocov2", "moco-v1", "moco-v2"):
            if "module.encoder_q" in k:
                nk = k.replace("module.encoder_q.", "")
        elif model_type in ("byol", "vince"):
            if "feature_extractor" in k:
                nk = k.replace("feature_extractor.module.model.", "")
        else:  # ssl bundles / plain torchvision: keys already bare
            nk = k
        if nk is not None and not nk.startswith(("fc.", "head")):
            sd[nk] = v
    return convert_torchvision_resnet(sd)
