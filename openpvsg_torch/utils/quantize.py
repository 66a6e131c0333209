"""Weights-only int8 for serving, the port of
``openpvsg_tpu/utils/quantize.py``: per-output-channel symmetric int8
weights with float32 scales, dequantized to the compute dtype inside every
forward (``infer/segmenter.py``), so the int8 tensors are what stays
resident on the device.

Which weights: the ``.weight`` of each Conv and Dense module whose flax leaf
is a ``kernel`` (``weights.flax_path``), with at least 2 dims and
``min_elems`` elements, inside one of ``scopes``; the same leaves the JAX
package quantizes. The selection goes by that mapping, never by the name
``weight``: a 2-D embedding such as ``pixel_decoder.axial_encoder
.level_embed`` stays as it is, as in JAX.

The output channel is axis 0 here (OIHW convs, (out, in) Linear weights),
the last axis in JAX (HWIO, Dense (in, out)). The arithmetic is JAX's: the
scale is ``max|w| / 127`` over the other axes in float32, floored at
1e-12, and the weights ``rint(w / scale)`` (half to even) clipped to
+-127, so the int8 tensors equal JAX's bit for bit after the layout
change and the scales equal JAX's.

JAX's ``dequantize_tree`` also takes a ``scale_mul``, which exists only to
keep XLA from hoisting the dequantization out of ``bench.py``'s timing
loop; torch hoists nothing, so the port leaves it out.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from openpvsg_torch.weights import flax_path

Quantized = Tuple[torch.Tensor, torch.Tensor]  # (int8 weights, float32 scales)


def is_quantizable(key: str, shape: Sequence[int],
                   scopes: Optional[Sequence[str]] = None,
                   min_elems: int = 4096) -> bool:
    """Whether ``quantize_tree_int8`` quantizes the flax leaf of this
    state-dict key: a ``kernel`` of >= 2 dims and >= ``min_elems``
    elements whose path passes through one of ``scopes`` (None: any)."""
    numel = 1
    for s in shape:
        numel *= int(s)
    _, path = flax_path(key, len(shape))
    return (path[-1] == "kernel" and len(shape) >= 2 and numel >= min_elems
            and (scopes is None or any(s in path for s in scopes)))


def quantize_int8(w: torch.Tensor) -> Quantized:
    """(int8 weights, float32 per-output-channel scales) of ``w`` with its
    output channel on axis 0."""
    w = w.detach().float()
    other = tuple(range(1, w.ndim))
    amax = w.abs().amax(dim=other)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which is off by an ulp for some inputs
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    view = (-1,) + (1,) * (w.ndim - 1)
    q = torch.clamp(torch.round(w / scale.view(view)), -127, 127).to(torch.int8)
    return q, scale


def quantize_state_int8(state: Mapping[str, torch.Tensor],
                        scopes: Optional[Sequence[str]] = None,
                        min_elems: int = 4096
                        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Quantized]]:
    """Split a state dict into (the tensors left as they are, {key: (int8,
    scales)} of the quantized ones)."""
    rest, quantized = {}, {}
    for key, t in state.items():
        if is_quantizable(key, t.shape, scopes, min_elems):
            quantized[key] = quantize_int8(t)
        else:
            rest[key] = t
    return rest, quantized


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``q * scale`` in ``dtype``: both cast to it first and the product
    taken in it, as JAX's ``dequantize_tree`` computes."""
    view = (-1,) + (1,) * (q.ndim - 1)
    return q.to(dtype) * scale.to(dtype).view(view)
