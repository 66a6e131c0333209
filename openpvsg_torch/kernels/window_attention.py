"""Swin's window attention core: kernel B3 (``csrc/window_attention.cu``) and
its plain-PyTorch version.

Replaces no TPU kernel: the JAX package leaves the chain to XLA, which fuses
it (``openpvsg_tpu/models/swin.py:WindowAttention.__call__``). From the qkv
projection's output (nW, L, 3C) it computes, per window and head, q.k with
float32 sums divided by sqrt(hd), plus the relative bias, plus the shift
mask, a float32 softmax cast to the compute dtype, and p.v with float32
sums, returned as (nW, L, C) with the heads concatenated per token: what
``proj`` reads.

``window_attention`` takes its plain version, ``window_attention_plain``
(the chain in torch operations), for CPU tensors and only for them: a CUDA
tensor launches the kernel or raises, also when grad mode is on and an input
requires grad (the kernel has no backward). The model layer makes the
choice for training: ``WindowAttention(train=True)`` calls the plain version
on every device. The kernel runs bfloat16 on the tensor cores and float32 in
full float32 (no TF32); it takes head sizes 16, 32 and 64 and windows of at
most 144 tokens.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from openpvsg_torch.kernels import build, refuse_autograd
from openpvsg_torch.kernels import check_tensor as _check

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (16, 32, 64)
MAX_TOKENS = 144  # window 12
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("window_attention")
    if not getattr(lib, "_bound", False):
        lib.window_attention.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         ctypes.c_float, _P]
        lib.window_attention.restype = _I
        lib._bound = True
    return lib


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           attn_mask: Optional[torch.Tensor], num_heads: int) -> torch.Tensor:
    """The plain version, in torch operations: float32 logits of the
    widened q and k, scaled, plus the bias, plus the mask, the float32
    softmax cast to v's dtype, then p.v. Arguments as ``window_attention``."""
    nW, L, C3 = qkv.shape
    H = num_heads
    C = C3 // 3
    hd = C // H
    qkv = qkv.reshape(nW, L, 3, H, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (nW, H, L, hd)
    logits = torch.einsum("whld,whmd->whlm", q.float(), k.float()) / math.sqrt(hd)
    logits = logits + bias[None].float()
    if attn_mask is not None:
        nM = attn_mask.shape[0]
        logits = (logits.reshape(nW // nM, nM, H, L, L)
                  + attn_mask[None, :, None]).reshape(nW, H, L, L)
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("whlm,whmd->whld", attn, v)
    return out.transpose(1, 2).reshape(nW, L, C)


def _scale(hd: int) -> float:
    """1 / sqrt(hd) as torch's CUDA division by a scalar takes it: the
    float32 reciprocal of the float32 divisor."""
    return float(np.float32(1.0) / np.float32(math.sqrt(hd)))


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     attn_mask: Optional[torch.Tensor], num_heads: int) -> torch.Tensor:
    """qkv (nW, L, 3C) in the compute dtype, the qkv projection's output;
    bias (H, L, L), the gathered relative-position bias (widened to float32
    for the kernel); attn_mask (nM, L, L) additive float32 or None, where nW
    is a multiple of nM and window w takes row w % nM. Returns (nW, L, C)."""
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, bias, attn_mask, num_heads)
    refuse_autograd("window_attention", qkv, bias,
                    *(() if attn_mask is None else (attn_mask,)))
    nW, L, C3 = qkv.shape
    H = num_heads
    C = C3 // 3
    hd = C // H
    dev = qkv.device
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"window_attention: qkv must be float32 or bfloat16, got {qkv.dtype}")
    if C3 != 3 * C or C != H * hd or hd not in HEAD_SIZES:
        raise ValueError(f"window_attention: {C3} = 3 x {H} heads x head size; the kernel "
                         f"takes head sizes {HEAD_SIZES}")
    if not 1 <= L <= MAX_TOKENS:
        raise ValueError(f"window_attention: {L} tokens a window; the kernel takes "
                         f"1 to {MAX_TOKENS}")
    _check("qkv", qkv, (nW, L, C3), qkv.dtype, dev)
    bias = bias.to(torch.float32).contiguous()
    _check("bias", bias, (H, L, L), torch.float32, dev)
    nM = 0
    if attn_mask is not None:
        nM = attn_mask.shape[0]
        if nM == 0 or nW % nM:
            raise ValueError(f"window_attention: {nW} windows are not a multiple of "
                             f"the mask's {nM} rows")
        _check("attn_mask", attn_mask, (nM, L, L), torch.float32, dev)
    out = torch.empty((nW, L, C), dtype=qkv.dtype, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        rc = _lib().window_attention(
            _DTYPE_CODE[qkv.dtype], qkv.data_ptr(), bias.data_ptr(),
            None if attn_mask is None else attn_mask.data_ptr(), out.data_ptr(),
            nW, L, H, hd, nM, _scale(hd), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"window_attention failed with CUDA error {rc}")
    window_attention.launches += 1
    return out


window_attention.launches = 0

KERNEL_WRAPPERS = (window_attention,)
