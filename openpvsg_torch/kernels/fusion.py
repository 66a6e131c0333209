"""Panoptic-fusion ownership pass: kernel B2 (``csrc/fusion.cu``) and its
plain-PyTorch version.

Replaces the Pallas kernel ``fused_fusion_maps``
(``openpvsg_tpu/ops/pallas/fusion_kernel.py:141``); what it computes is the
owner and area step of ``openpvsg_tpu/models/fusion.py:61-69``: a 4x bilinear
upsample of the stride-4 mask logits, a sigmoid, the score-weighted argmax
over queries, the owner's binary bit (``sigmoid >= 0.5`` in float32, the
fusion.py rule) and the per-query areas inside ``ori_hw``.

``fusion_maps`` takes its plain version (upsample then argmax, as
``_fusion_reference`` at ``fusion_kernel.py:211`` computes it) for CPU tensors
and only for them: a CUDA tensor launches the kernel or raises (also when
grad mode is on and an input requires grad: the kernel has no backward).
``exact_sigmoid_count`` measures how many exact sigmoids the kernel evaluates
on given inputs; nothing on the main path calls it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from openpvsg_torch.kernels import build, refuse_autograd

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("fusion")
    if not getattr(lib, "_bound", False):
        lib.fusion_maps.argtypes = [_P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _P]
        lib.fusion_maps.restype = _I
        lib._bound = True
    return lib


def fusion_maps_plain(mask_low, scores, ori_hw):
    N, Q, h, w = mask_low.shape
    up = F.interpolate(mask_low, size=(4 * h, 4 * w), mode="bilinear",
                       align_corners=False)
    sig = torch.sigmoid(up)
    val = torch.where(torch.isneginf(scores)[:, :, None, None],
                      torch.tensor(float("-inf"), device=sig.device),
                      scores[:, :, None, None] * sig)
    owner = val.argmax(dim=1)                                   # (N, H, W)
    binary_all = sig >= 0.5
    binary = binary_all.gather(1, owner[:, None])[:, 0]
    rows = torch.arange(4 * h, device=sig.device)[:, None] < ori_hw[0]
    cols = torch.arange(4 * w, device=sig.device)[None, :] < ori_hw[1]
    inside = (rows & cols)[None, None]
    qs = torch.arange(Q, device=sig.device)[None, :, None, None]
    owned = (owner[:, None] == qs) & binary_all & inside
    mask_area = owned.sum(dim=(2, 3), dtype=torch.int32)
    original_area = (binary_all & inside).sum(dim=(2, 3), dtype=torch.int32)
    return owner.to(torch.int32), binary, mask_area, original_area


def _launch(mask_low, scores, ori_h, ori_w, sigmoid_count=None):
    N, Q, h, w = mask_low.shape
    dev = mask_low.device
    for name, t, shape in (("mask_low", mask_low, (N, Q, h, w)),
                           ("scores", scores, (N, Q))):
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError(f"{name}: must be float32 on {dev}, got "
                            f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    H, W = 4 * h, 4 * w
    owner = torch.empty((N, H, W), dtype=torch.int32, device=dev)
    binary = torch.empty((N, H, W), dtype=torch.bool, device=dev)
    mask_area, original_area = torch.zeros((2, N, Q), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        rc = _lib().fusion_maps(
            mask_low.data_ptr(), scores.data_ptr(), owner.data_ptr(),
            binary.data_ptr(), mask_area.data_ptr(), original_area.data_ptr(),
            None if sigmoid_count is None else sigmoid_count.data_ptr(),
            N, Q, h, w, ori_h, ori_w, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fusion_maps failed with CUDA error {rc}")
    return owner, binary, mask_area, original_area


def _check_padded(mask_low, padded_hw):
    h, w = mask_low.shape[2:]
    if tuple(padded_hw) != (4 * h, 4 * w):
        raise ValueError(f"fusion_maps: padded_hw {tuple(padded_hw)} is not "
                         f"4x the logits' ({h}, {w})")


def fusion_maps(mask_low: torch.Tensor, scores: torch.Tensor,
                padded_hw: Tuple[int, int], ori_hw: Tuple[int, int]):
    """mask_low (N, Q, h, w) float32 stride-4 logits; scores (N, Q) float32
    with -inf for queries not kept; padded_hw must be (4h, 4w).

    Returns owner (N, 4h, 4w) int32, binary (N, 4h, 4w) bool, and
    mask_area, original_area (N, Q) int32 counted inside ori_hw."""
    _check_padded(mask_low, padded_hw)
    ori_h, ori_w = int(ori_hw[0]), int(ori_hw[1])
    if mask_low.device.type == "cpu":
        return fusion_maps_plain(mask_low, scores, (ori_h, ori_w))
    refuse_autograd("fusion_maps", mask_low, scores)
    out = _launch(mask_low, scores, ori_h, ori_w)
    fusion_maps.launches += 1
    return out


fusion_maps.launches = 0


def exact_sigmoid_count(mask_low: torch.Tensor, scores: torch.Tensor,
                        padded_hw: Tuple[int, int], ori_hw: Tuple[int, int]) -> int:
    """How many query-pixel pairs kernel B2 evaluates the exact sigmoid for
    on these CUDA inputs: one launch of its counting build (a measurement;
    it does not add to ``fusion_maps.launches``). There is no plain version."""
    _check_padded(mask_low, padded_hw)
    if mask_low.device.type != "cuda":
        raise ValueError("exact_sigmoid_count: counts the CUDA kernel's work; "
                         "needs CUDA tensors")
    count = torch.zeros((), dtype=torch.int64, device=mask_low.device)
    _launch(mask_low, scores, int(ori_hw[0]), int(ori_hw[1]), count)
    return int(count)


KERNEL_WRAPPERS = (fusion_maps,)
