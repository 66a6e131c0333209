"""Layers with a compute dtype of their own, as flax's ``dtype`` attribute
gives one to ``nn.Dense``, ``nn.Conv``, ``nn.LayerNorm`` and
``nn.GroupNorm``: the segmenter's ``Dense``, ``Conv``, ``LayerNorm`` and
``GroupNorm``, and ``set_compute_dtype`` to set it on a module tree.

``compute_dtype`` None (the default) leaves each the torch module it
extends: it computes in its weights' dtype (float32 for training, the
serving model's cast for inference). With a compute dtype, the bfloat16
trainer's, each follows flax's mixed precision over float32 parameters
(``param_dtype`` float32, ``dtype`` bfloat16):

- ``Dense`` and ``Conv`` round the input, the weight and the bias to the
  compute dtype, accumulate in float32 and return the compute dtype;
- ``LayerNorm`` and ``GroupNorm`` take their statistics of the float32
  input with the float32 scale and bias, and return the compute dtype.

Autograd carries the gradients back through each cast to the float32
parameters, so the optimizer, the clip and the checkpoints see float32
only. Module names and state dicts are those of the torch modules.

``fast_norm`` (False by default; ``Mask2Former.fast_norm`` sets it) makes
``LayerNorm`` and ``GroupNorm`` take their statistics in the compute dtype
(the input's when there is none), as flax computes them with
``force_float32_reductions=False``: ``var = E[x^2] - E[x]^2`` in that dtype,
clipped at 0 (``flax.linen.normalization._compute_stats`` with
``use_fast_variance``), then ``(x - mean) * (rsqrt(var + eps) * scale) +
bias`` with float32 scale and bias (``_normalize``). Neither torch's
two-pass variance nor ``F.layer_norm`` (which accumulates bfloat16 in
float32 on CUDA) computes that.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype):
    return None if t is None else t.to(dtype)


class Dense(nn.Linear):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv(nn.Conv2d):
    compute_dtype: Optional[torch.dtype] = None

    def cast(self, *tensors: Optional[torch.Tensor]):
        """The tensors in the compute dtype (unchanged without one): for a
        caller that applies the kernel itself, as the 1x1 semantic head
        does with ``F.linear``."""
        dt = self.compute_dtype
        return tensors if dt is None else tuple(_cast(t, dt) for t in tensors)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))


def fast_normalize(x: torch.Tensor, dims, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax's normalization with its statistics in ``dtype`` (None: x's):
    the mean and the mean of squares of x in that dtype (each a float32
    sum rounded to it, as ``jnp.mean`` computes), ``var = max(0, E[x^2] -
    E[x]^2)`` in it, then the float32 affine; returns ``dtype``. ``weight``
    and ``bias`` broadcast against x."""
    dt = dtype or x.dtype
    xs = x.to(dt)
    mean = xs.mean(dims, keepdim=True)
    var = torch.clamp((xs * xs).mean(dims, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps).float() * weight.float()
    return ((x - mean) * mul + bias.float()).to(dt)


class LayerNorm(nn.LayerNorm):
    compute_dtype: Optional[torch.dtype] = None
    fast_norm = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.fast_norm:
            return fast_normalize(x, (-1,), self.weight, self.bias, self.eps, dt)
        if dt is None:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(dt)


class GroupNorm(nn.GroupNorm):
    compute_dtype: Optional[torch.dtype] = None
    fast_norm = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.fast_norm:  # x (N, C, ...): the groups' statistics
            N, C = x.shape[:2]
            g = x.reshape(N, self.num_groups, C // self.num_groups, *x.shape[2:])
            view = (1, self.num_groups, C // self.num_groups) + (1,) * (x.ndim - 2)
            return fast_normalize(g, tuple(range(2, g.ndim)), self.weight.view(view),
                                  self.bias.view(view), self.eps, dt).reshape(x.shape)
        if dt is None:
            return super().forward(x)
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(dt)


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Set ``compute_dtype`` on every layer of ``module`` that has one
    (these four and the ResNet's ``BatchNorm``); None restores the torch
    behaviour."""
    for m in module.modules():
        if hasattr(type(m), "compute_dtype"):
            m.compute_dtype = dtype
