"""Stride-4 FPN chain of the pixel decoder: kernel B1 (``csrc/fpn.cu``) and
its plain-PyTorch version.

Replaces the Pallas kernel ``fused_fpn_stride4``
(``openpvsg_tpu/ops/pallas/fpn_kernel.py:95``)::

    mask_feature = mask_1x1(relu(GN2(conv3x3(GN1(lateral_1x1(f0)) + up2x(s8)))))

with GroupNorm over ``num_groups`` groups, eps 1e-6, and GN1 on the lateral
alone, before the add. Three launches, one per product (``lateral_stats``,
``conv3x3_stats``, ``mask_proj``); the tiny (B, C) sums -> scale/bias fold
between them (``group_affine``) is torch. The kernels write GroupNorm sums as
per-CTA partials, each summed in a fixed order, and the wrappers add them up
in a fixed order, so the chain gives the same bits on every call.

The route follows the activation dtype: float32 runs a SIMT GEMM (the parity
path), bfloat16 the tensor-core kernels, which take channel counts up to
``TC_MAX_CHANNELS``. Every channel count is a multiple of 8 and every tensor
16-byte aligned.

Every wrapper takes its plain version for CPU tensors and only for them: a
CUDA tensor launches the kernel or raises. ``fpn_stride4`` on CPU tensors runs
the unfused module chain (``fpn_stride4_plain``, the pixel decoder's loop at
``openpvsg_tpu/models/pixel_decoder.py:245-258``). Inference only: there is
no backward, so a CUDA launch raises when grad mode is on and an input or
weight requires grad (training runs the unfused chain instead).

Layouts are those of the Pallas function: activations NHWC, ``w_lat``
(Cin, C) or (1, 1, Cin, C), ``w_out`` (3, 3, C, C) HWIO, ``w_mask`` (C, Cout)
or (1, 1, C, Cout).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from openpvsg_torch.kernels import build, refuse_autograd
from openpvsg_torch.ops.resize import resize_bilinear

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TC_MAX_CHANNELS = 256  # widest K, C or N of the bf16 kernels (csrc/fpn.cu kMaxC)
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("fpn")
    if not getattr(lib, "_bound", False):
        lib.fpn_lateral.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.fpn_conv3x3.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _P]
        lib.fpn_mask.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.fpn_stats_tiles.argtypes = [_I, _I, _I, _I, _I]
        for fn in (lib.fpn_lateral, lib.fpn_conv3x3, lib.fpn_mask,
                   lib.fpn_stats_tiles):
            fn.restype = _I
        lib._bound = True
    return lib


def _check(name: str, t: torch.Tensor, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _check_channels(what: str, dt: torch.dtype, **dims: int):
    for name, n in dims.items():
        if n % 8:
            raise ValueError(f"{what}: {name} = {n} must be a multiple of 8")
        if dt == torch.bfloat16 and n > TC_MAX_CHANNELS:
            raise ValueError(f"{what}: {name} = {n}; the bfloat16 kernel takes "
                             f"at most {TC_MAX_CHANNELS} channels")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _act_dtype(x: torch.Tensor) -> torch.dtype:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"activations must be float32 or bfloat16, got {x.dtype}")
    return x.dtype


def _channel_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, C) float32 -> per-(b, c) sum and sum of squares."""
    return x.sum(dim=(1, 2)), (x * x).sum(dim=(1, 2))


def _partials(dt: torch.dtype, kernel: int, B: int, H: int, W: int, N: int,
              device: torch.device) -> torch.Tensor:
    """The (2, B, N, tiles) float32 buffer where a stats launch (kernel 0
    lateral, 1 conv3x3) writes each CTA's partial sums ([0]) and sums of
    squares ([1]); ``.sum(-1)`` adds them up in a fixed order."""
    tiles = _lib().fpn_stats_tiles(_DTYPE_CODE[dt], kernel, B, H, W)
    _raise_on(max(0, -tiles), "fpn_stats_tiles")
    return torch.empty((2, B, N, tiles), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# launch 1: lateral 1x1 conv + bias, GN1 sums
# ---------------------------------------------------------------------------

def lateral_stats_plain(f0, w_lat, b_lat):
    B, H, W, Cin = f0.shape
    lat = (f0.reshape(-1, Cin).float() @ w_lat.float()
           + b_lat.float()).reshape(B, H, W, -1)
    s, q = _channel_sums(lat)
    return lat.to(f0.dtype), s, q


def lateral_stats(f0: torch.Tensor, w_lat: torch.Tensor, b_lat: torch.Tensor):
    """f0 (B, H, W, Cin), w_lat (Cin, C) in the activation dtype, b_lat (C,)
    float32 -> (l_raw (B, H, W, C) in the activation dtype, sums (B, C),
    sums of squares (B, C)) with float32 sums over the float32 results."""
    if f0.device.type == "cpu":
        return lateral_stats_plain(f0, w_lat, b_lat)
    dt = _act_dtype(f0)
    B, H, W, Cin = f0.shape
    C = w_lat.shape[1]
    dev = f0.device
    refuse_autograd("lateral_stats", f0, w_lat, b_lat)
    _check("f0", f0, (B, H, W, Cin), dt, dev)
    _check("w_lat", w_lat, (Cin, C), dt, dev)
    _check("b_lat", b_lat, (C,), torch.float32, dev)
    _check_channels("lateral_stats", dt, Cin=Cin, C=C)
    out = torch.empty((B, H, W, C), dtype=dt, device=dev)
    with torch.cuda.device(dev):  # the library's per-device caches
        part = _partials(dt, 0, B, H, W, C, dev)
        rc = _lib().fpn_lateral(_DTYPE_CODE[dt], f0.data_ptr(), w_lat.data_ptr(),
                                b_lat.data_ptr(), out.data_ptr(), part.data_ptr(),
                                B, H * W, Cin, C, _stream(dev))
    _raise_on(rc, "fpn_lateral")
    lateral_stats.launches += 1
    s, q = part.sum(dim=-1)
    return out, s, q


lateral_stats.launches = 0


# ---------------------------------------------------------------------------
# launch 2: x1 = GN1affine(l_raw) + up2x(s8) built on load; 3x3 conv + bias,
# GN2 sums
# ---------------------------------------------------------------------------

def conv3x3_stats_plain(l_raw, s8, sc1, bi1, w_out, b_out):
    B, H, W, C = l_raw.shape
    up = resize_bilinear(s8.float(), (H, W))
    x1 = l_raw.float() * sc1[:, None, None, :] + bi1[:, None, None, :] + up
    x1 = x1.to(l_raw.dtype).float()
    x2 = F.conv2d(x1.permute(0, 3, 1, 2), w_out.float().permute(3, 2, 0, 1),
                  b_out.float(), padding=1).permute(0, 2, 3, 1)
    s, q = _channel_sums(x2)
    return x2.to(l_raw.dtype).contiguous(), s, q


def conv3x3_stats(l_raw, s8, sc1, bi1, w_out, b_out):
    """l_raw (B, H, W, C), s8 (B, H8, W8, C), w_out (3, 3, C, N) in the
    activation dtype; sc1, bi1 (B, C) and b_out (N,) float32 ->
    (x2 (B, H, W, N), sums (B, N), sums of squares (B, N))."""
    if l_raw.device.type == "cpu":
        return conv3x3_stats_plain(l_raw, s8, sc1, bi1, w_out, b_out)
    dt = _act_dtype(l_raw)
    B, H, W, C = l_raw.shape
    H8, W8 = s8.shape[1:3]
    N = w_out.shape[-1]
    dev = l_raw.device
    refuse_autograd("conv3x3_stats", l_raw, s8, sc1, bi1, w_out, b_out)
    _check("l_raw", l_raw, (B, H, W, C), dt, dev)
    _check("s8", s8, (B, H8, W8, C), dt, dev)
    _check("sc1", sc1, (B, C), torch.float32, dev)
    _check("bi1", bi1, (B, C), torch.float32, dev)
    _check("w_out", w_out, (3, 3, C, N), dt, dev)
    _check("b_out", b_out, (N,), torch.float32, dev)
    _check_channels("conv3x3_stats", dt, C=C, N=N)
    out = torch.empty((B, H, W, N), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        part = _partials(dt, 1, B, H, W, N, dev)
        rc = _lib().fpn_conv3x3(
            _DTYPE_CODE[dt], l_raw.data_ptr(), s8.data_ptr(), sc1.data_ptr(),
            bi1.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), out.data_ptr(),
            part.data_ptr(), B, H, W, H8, W8, C, N, _stream(dev))
    _raise_on(rc, "fpn_conv3x3")
    conv3x3_stats.launches += 1
    s, q = part.sum(dim=-1)
    return out, s, q


conv3x3_stats.launches = 0


# ---------------------------------------------------------------------------
# launch 3: GN2 affine + relu prologue, mask 1x1 conv + bias
# ---------------------------------------------------------------------------

def mask_proj_plain(x2, sc2, bi2, w_mask, b_mask):
    B, H, W, C = x2.shape
    y = torch.relu(x2.float() * sc2[:, None, None, :] + bi2[:, None, None, :])
    y = y.to(x2.dtype).float().reshape(-1, C)
    out = y @ w_mask.float() + b_mask.float()
    return out.reshape(B, H, W, -1).to(x2.dtype)


def mask_proj(x2, sc2, bi2, w_mask, b_mask):
    """x2 (B, H, W, C) and w_mask (C, Cout) in the activation dtype; sc2,
    bi2 (B, C) and b_mask (Cout,) float32 -> (B, H, W, Cout)."""
    if x2.device.type == "cpu":
        return mask_proj_plain(x2, sc2, bi2, w_mask, b_mask)
    dt = _act_dtype(x2)
    B, H, W, C = x2.shape
    Cout = w_mask.shape[1]
    dev = x2.device
    refuse_autograd("mask_proj", x2, sc2, bi2, w_mask, b_mask)
    _check("x2", x2, (B, H, W, C), dt, dev)
    _check("sc2", sc2, (B, C), torch.float32, dev)
    _check("bi2", bi2, (B, C), torch.float32, dev)
    _check("w_mask", w_mask, (C, Cout), dt, dev)
    _check("b_mask", b_mask, (Cout,), torch.float32, dev)
    _check_channels("mask_proj", dt, C=C, Cout=Cout)
    out = torch.empty((B, H, W, Cout), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().fpn_mask(_DTYPE_CODE[dt], x2.data_ptr(), sc2.data_ptr(),
                             bi2.data_ptr(), w_mask.data_ptr(), b_mask.data_ptr(),
                             out.data_ptr(), B, H * W, C, Cout, _stream(dev))
    _raise_on(rc, "fpn_mask")
    mask_proj.launches += 1
    return out


mask_proj.launches = 0

KERNEL_WRAPPERS = (lateral_stats, conv3x3_stats, mask_proj)


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

def group_affine(sums, sumsqs, scale, bias, count, num_groups, eps):
    """(B, C) channel sums -> per-channel (B, C) scale' and bias' that fold
    the group normalization: GN(x) = x * scale' + bias'
    (``openpvsg_tpu/ops/pallas/fpn_kernel.py:78``)."""
    B, C = sums.shape
    cg = C // num_groups
    mean = sums.reshape(B, num_groups, cg).sum(-1) / count
    var = sumsqs.reshape(B, num_groups, cg).sum(-1) / count - mean * mean
    rstd = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=1)
    rstd_c = rstd.repeat_interleave(cg, dim=1)
    sc = rstd_c * scale.float()[None, :]
    return sc.contiguous(), (bias.float()[None, :] - mean_c * sc).contiguous()


def _weights(p: Dict[str, torch.Tensor], Cin: int, C: int, dt: torch.dtype):
    return (p["w_lat"].reshape(Cin, C).to(dt).contiguous(),
            p["w_out"].to(dt).contiguous(),
            p["w_mask"].reshape(C, -1).to(dt).contiguous())


def fpn_stride4_plain(f0, s8, p, num_groups: int = 32, eps: float = 1e-6):
    """The unfused module chain in the activation dtype: ConvGN(1x1) ->
    + bilinear 2x -> ConvGN(3x3, relu) -> 1x1 conv (NHWC in and out)."""
    dt = f0.dtype
    Cin, C = f0.shape[-1], s8.shape[-1]
    w_lat, w_out, w_mask = _weights(p, Cin, C, dt)

    def conv(x, w_oihw, b, pad):  # NHWC in, NCHW out
        return F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b.to(dt), padding=pad)

    def gn(y, scale, bias):
        return F.group_norm(y, num_groups, scale.to(dt), bias.to(dt), eps)

    lat = gn(conv(f0, w_lat.t()[:, :, None, None], p["b_lat"], 0),
             p["gn1_scale"], p["gn1_bias"]).permute(0, 2, 3, 1)
    x1 = lat + resize_bilinear(s8, f0.shape[1:3])
    x2 = torch.relu(gn(conv(x1, w_out.permute(3, 2, 0, 1), p["b_out"], 1),
                       p["gn2_scale"], p["gn2_bias"])).permute(0, 2, 3, 1)
    out = conv(x2, w_mask.t()[:, :, None, None], p["b_mask"], 0)
    return out.permute(0, 2, 3, 1)


def fpn_stride4(f0: torch.Tensor, s8: torch.Tensor, p: Dict[str, torch.Tensor],
                num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """f0 (B, H, W, Cin) stride-4 backbone features, s8 (B, H/2, W/2, C)
    encoder stride-8 output -> mask_feature (B, H, W, Cout), all in the
    activation dtype (float32 or bfloat16); ``p`` holds the ten parameters
    named as in ``fused_fpn_stride4``. CUDA tensors run the three kernels,
    CPU tensors the unfused chain."""
    if f0.device.type == "cpu":
        return fpn_stride4_plain(f0, s8, p, num_groups, eps)
    refuse_autograd("fpn_stride4", f0, s8, *p.values())
    dt = _act_dtype(f0)
    B, H, W, Cin = f0.shape
    C = s8.shape[-1]
    w_lat, w_out, w_mask = _weights(p, Cin, C, dt)
    f32 = {k: p[k].float().contiguous() for k in
           ("b_lat", "gn1_scale", "gn1_bias", "b_out", "gn2_scale",
            "gn2_bias", "b_mask")}
    count = H * W * (C // num_groups)
    l_raw, s1, q1 = lateral_stats(f0.contiguous(), w_lat, f32["b_lat"])
    sc1, bi1 = group_affine(s1, q1, f32["gn1_scale"], f32["gn1_bias"], count,
                            num_groups, eps)
    x2, s2, q2 = conv3x3_stats(l_raw, s8.to(dt).contiguous(), sc1, bi1, w_out,
                               f32["b_out"])
    sc2, bi2 = group_affine(s2, q2, f32["gn2_scale"], f32["gn2_bias"], count,
                            num_groups, eps)
    return mask_proj(x2, sc2, bi2, w_mask, f32["b_mask"])
