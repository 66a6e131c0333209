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


class LayerNorm(nn.LayerNorm):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(dt)


class GroupNorm(nn.GroupNorm):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
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
