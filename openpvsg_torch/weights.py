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
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from openpvsg_torch.config import Mask2FormerConfig

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
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
    else:
        leaf = _RENAME.get(leaf, leaf)
    return ".".join((*scope, leaf)), torch.from_numpy(np.array(arr, copy=True))


def expected_shapes(cfg: Mask2FormerConfig) -> Dict[str, tuple]:
    """{state-dict key: shape} of the port's model for ``cfg``, built on the
    meta device (no memory, no arithmetic)."""
    from openpvsg_torch.models.mask2former import Mask2Former

    with torch.device("meta"):
        model = Mask2Former(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _check_keys(keys, cfg: Mask2FormerConfig, what: str) -> Dict[str, tuple]:
    want = expected_shapes(cfg)
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
        _check_keys(state_dict, cfg, "state dict")
    except ValueError as e:
        raise ValueError(f"to_jax_params: {e}") from None
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        arr = t.detach().cpu().float().numpy()
        coll, path = flax_path(key, arr.ndim)
        if path[-1] == "kernel":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = out[coll]
        for s in path[:-1]:
            node = node.setdefault(s, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return out


def from_jax_params(variables: Mapping, cfg: Mask2FormerConfig
                    ) -> Dict[str, torch.Tensor]:
    """Flax variables of ``openpvsg_tpu.models.mask2former.Mask2Former``
    (``params``, plus ``batch_stats`` when present; leaves are anything
    numpy can read) -> a float32 state dict for
    ``openpvsg_torch.models.mask2former.Mask2Former(cfg)``."""
    state: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(coll, {})):
            key, t = _convert_leaf(path, value)
            if key in state:
                raise ValueError(f"two flax leaves map to '{key}'")
            state[key] = t
    try:
        want = _check_keys(state, cfg, "tree")
    except ValueError as e:
        raise ValueError(f"from_jax_params: {e}") from None
    bad = [(k, tuple(state[k].shape), s) for k, s in want.items()
           if tuple(state[k].shape) != s]
    if bad:
        raise ValueError(f"from_jax_params: shape mismatches {bad[:8]}")
    return state


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
