"""Weights for the port: conversion from and to the JAX package's flax
variables, and random weights from a seed.

``from_jax_params`` inverts the layout changes of
``openpvsg_tpu/train/checkpoint.py:101-155``: the torch module names are the
flax scope paths joined by '.', and leaves map as

  conv ``kernel`` (kh, kw, in, out)  -> ``weight`` (out, in, kh, kw)
  Dense ``kernel`` (in, out)         -> ``weight`` (out, in)
  LayerNorm/GroupNorm/BN ``scale``   -> ``weight``
  BN batch stats ``mean`` / ``var``  -> ``running_mean`` / ``running_var``

Other leaves (``bias``, ``query_feat``, ``level_embed``, ...) keep their
name. A key the port's model does not have, or a model key the tree does not
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
    embeddings ~ N(0, 1), BN running mean 0 and variance 1 plus noise."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, shape in expected_shapes(cfg).items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shape) >= 2:
            fan_in = math.prod(shape[1:])
            t = torch.randn(shape, generator=gen) / math.sqrt(fan_in)
        elif leaf == "weight":
            t = torch.ones(shape)
        elif leaf == "running_var":
            t = 1.0 + 0.1 * torch.rand(shape, generator=gen)
        elif leaf in ("bias", "running_mean"):
            t = torch.zeros(shape)
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
