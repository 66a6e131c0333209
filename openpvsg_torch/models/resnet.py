"""ResNet backbone ("pytorch style": the stride sits on the 3x3 conv), the
port of ``openpvsg_tpu/models/resnet.py``: Bottleneck blocks for depths
26/50/101 (the segmenters, the tracker's appearance encoder) and torchvision
BasicBlocks for 18/34 (the appearance zoo's resnet18/34 entries). The
appearance encoder cuts the network after ``num_stages`` stages, with the
first block of each stage at ``stage_strides``.

Module names follow the flax tree (``conv1``, ``bn1.bn``, ``layer1_0.conv2``,
``layer2_0.downsample_conv``, ...) so weights convert by a mechanical walk
(``openpvsg_torch/weights.py``). Input and outputs are channels last
(B, H, W, C) as in the JAX package; the convolutions run in NCHW with
channels-last memory.

Norms: 'frozen_bn' and 'sync_bn' both use running statistics at inference
(eps 1e-5, ``openpvsg_tpu/models/resnet.py:51``); 'folded' is the serving
form whose BN affines were folded into the convs by ``fold_frozen_bn``.
With ``train=True``, 'sync_bn' normalizes by the batch statistics over
(N, H, W) and updates the running statistics as flax does (momentum 0.9,
the *biased* batch variance); 'frozen_bn' keeps its running statistics in
training too. The JAX trainer runs ``axis_name=None`` under ``pjit``, so
its batch statistics are those of the global batch; the port's 'sync_bn'
gets them across ranks from a process group (``set_process_group``): the
counts, means and squared deviations of each rank's batch are combined in
float64, and its backward all-reduces the sums of dy and dy * x_hat, so
every rank's gradient is that of the global batch (``_SyncBatchNorm``;
``torch.nn.SyncBatchNorm`` refuses CPU tensors).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from openpvsg_torch.models.layers import Conv
from openpvsg_torch.parallel.mesh import all_reduce_sum

# 26 = one bottleneck per stage (test/debug scale)
STAGE_BLOCKS = {18: (2, 2, 2, 2), 26: (1, 1, 1, 1), 34: (3, 4, 6, 3),
                50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
# depths built from BasicBlock (two 3x3 convs, expansion 1)
BASIC_DEPTHS = (18, 34)
BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax: ra = momentum * ra + (1 - momentum) * batch


class _SyncBatchNorm(torch.autograd.Function):
    """Batch normalization over the batch of every rank of ``group``: x
    (N, C, H, W) -> (y, mean, biased var). Each rank takes its batch's
    mean and 1 / std as the one-device path does; the counts and the
    count-weighted first and second moments are summed over the ranks in
    float64 (one all-reduce), which a float32 variance survives. Backward: dx = w * rstd
    * (dy - mean(dy) - x_hat * mean(dy * x_hat)) with the means over the
    global batch; the weight and bias gradients stay per rank, for the
    trainer's gradient all-reduce to sum. On the GPU the per-rank sums and
    the elementwise passes are the kernels of torch's own SyncBatchNorm
    (those of the one-device training BatchNorm), so a group of one
    normalizes as one device does; on the CPU, where they do not exist,
    the same formulas run as plain ops."""

    @staticmethod
    def forward(ctx, x, weight, bias, group):
        C = x.shape[1]
        view = (1, C, 1, 1)
        n_local = x.numel() // C
        if x.is_cuda:
            mean_l, rstd_l = torch.batch_norm_stats(x, BN_EPS)
        else:
            _, mean_l, rstd_l = torch.native_batch_norm(x, None, None, None, None, True,
                                                        0.0, BN_EPS)
        mean_l, var_l = mean_l.double(), rstd_l.double().pow(-2) - BN_EPS
        # one all-reduce of the counts and the first and second moments
        sums = torch.cat([mean_l.new_full((1,), n_local), n_local * mean_l,
                          n_local * (var_l + mean_l * mean_l)])
        all_reduce_sum([sums], group)
        n = sums[0]
        mean = sums[1:C + 1] / n
        var = (sums[C + 1:] / n - mean * mean).clamp(min=0.0)
        rstd = torch.rsqrt(var + BN_EPS).to(rstd_l.dtype)
        mean, var = mean.to(rstd_l.dtype), var.to(rstd_l.dtype)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        if x.is_cuda:
            ctx.save_for_backward(x, weight, mean, rstd, n.to(torch.int32).reshape(1))
            return torch.batch_norm_elemt(x, weight, bias, mean, rstd, BN_EPS), mean, var
        x_hat = (x - mean.view(view).to(x.dtype)) * rstd.view(view).to(x.dtype)
        ctx.save_for_backward(x_hat, weight, rstd.to(x.dtype), n.to(x.dtype))
        return x_hat * weight.view(view) + bias.view(view), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        if dy.is_cuda:
            x, weight, mean, rstd, count = ctx.saved_tensors
            sum_dy, sum_dy_xmu, grad_w, grad_b = torch.batch_norm_backward_reduce(
                dy, x, mean, rstd, weight, True, True, True)
            C = sum_dy.numel()
            sums = torch.cat([sum_dy, sum_dy_xmu])
            all_reduce_sum([sums], ctx.group)
            dx = torch.batch_norm_backward_elemt(dy, x, mean, rstd, weight, sums[:C],
                                                 sums[C:], count)
            return dx, grad_w, grad_b, None
        x_hat, weight, rstd, n = ctx.saved_tensors
        C = x_hat.shape[1]
        dims = (0, 2, 3)
        view = (1, C, 1, 1)
        sum_dy = dy.sum(dims)
        sum_dy_xhat = (dy * x_hat).sum(dims)
        sums = torch.cat([sum_dy, sum_dy_xhat])
        all_reduce_sum([sums], ctx.group)
        mean_dy, mean_dy_xhat = (sums / n).split(C)
        dx = (weight * rstd).view(view) * (dy - mean_dy.view(view)
                                           - x_hat * mean_dy_xhat.view(view))
        return dx, sum_dy_xhat, sum_dy, None


class BatchNorm(nn.Module):
    """BatchNorm whose state dict is exactly the flax ``bn`` scope:
    scale/bias params plus mean/var batch stats (no update counter).

    ``batch_stats=False`` normalizes by the running statistics. With
    ``batch_stats=True`` it normalizes by the batch's mean and biased
    variance over (N, H, W) and moves the running statistics toward them.
    The update is the port's own: torch's would store the unbiased
    variance (n / (n - 1) times flax's). The biased variance comes back
    from the normalization's own statistics, so x is reduced once.

    With a ``compute_dtype`` (``models/layers.py``) it normalizes the
    float32 input with float32 statistics, scale and bias and returns the
    compute dtype, as flax's ``BatchNorm(dtype=...)`` does; the running
    statistics stay float32."""

    compute_dtype = None
    group = None  # a torch.distributed process group: statistics over its ranks

    def __init__(self, channels: int, batch_stats: bool = False):
        super().__init__()
        self.batch_stats = batch_stats
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if self.compute_dtype is not None:
            return self._normalize(x.float()).to(self.compute_dtype)
        return self._normalize(x)

    def _normalize(self, x):
        if not self.batch_stats:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=BN_EPS)
        if self.group is not None:
            y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias, self.group)
        else:
            # running statistics None: normalize by the batch and return its
            # mean and 1 / sqrt(biased var + eps), from the one pass over x
            y, mean, rstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, BN_EPS)
            with torch.no_grad():
                var = rstd.pow(-2) - BN_EPS
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        return y


def set_process_group(model: nn.Module, group) -> None:
    """Reduce the batch statistics of every training-mode BatchNorm of
    ``model`` over ``group`` (None: this process's batch alone)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


class Norm(nn.Module):
    """frozen_bn (running statistics) | sync_bn (batch statistics when
    ``train``) | folded (identity)."""

    def __init__(self, kind: str, channels: int, train: bool = False):
        super().__init__()
        if kind not in ("frozen_bn", "sync_bn", "folded"):
            raise ValueError(f"backbone norm '{kind}' is not ported")
        self.kind = kind
        if kind != "folded":
            self.bn = BatchNorm(channels,
                                batch_stats=train and kind == "sync_bn")

    def forward(self, x):
        return x if self.kind == "folded" else self.bn(x)


def _conv(cin, cout, k, stride=1, bias=False):
    return Conv(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 norm: str, train: bool = False):
        super().__init__()
        bias = norm == "folded"
        self.conv1 = _conv(cin, planes, 1, bias=bias)
        self.bn1 = Norm(norm, planes, train)
        self.conv2 = _conv(planes, planes, 3, stride, bias=bias)
        self.bn2 = Norm(norm, planes, train)
        self.conv3 = _conv(planes, planes * 4, 1, bias=bias)
        self.bn3 = Norm(norm, planes * 4, train)
        if downsample:
            self.downsample_conv = _conv(cin, planes * 4, 1, stride, bias=bias)
            self.downsample_bn = Norm(norm, planes * 4, train)
        self.has_downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class BasicBlock(nn.Module):
    """torchvision's BasicBlock (resnet18/34): two 3x3 convs, expansion 1."""

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 norm: str, train: bool = False):
        super().__init__()
        bias = norm == "folded"
        self.conv1 = _conv(cin, planes, 3, stride, bias=bias)
        self.bn1 = Norm(norm, planes, train)
        self.conv2 = _conv(planes, planes, 3, bias=bias)
        self.bn2 = Norm(norm, planes, train)
        if downsample:
            self.downsample_conv = _conv(cin, planes, 1, stride, bias=bias)
            self.downsample_bn = Norm(norm, planes, train)
        self.has_downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Returns the outputs of the stages in ``out_indices`` (strides
    4/8/16/32 with the default ``stage_strides``; channels 256/512/1024/2048
    for the Bottleneck depths, 64/128/256/512 for 18/34), channels last."""

    def __init__(self, depth: int = 50, norm: str = "frozen_bn",
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 train: bool = False, num_stages: int = 4,
                 stage_strides: Tuple[int, ...] = (1, 2, 2, 2)):
        super().__init__()
        if depth not in STAGE_BLOCKS:
            raise ValueError(f"ResNet depth {depth} is not ported "
                             f"(have {sorted(STAGE_BLOCKS)})")
        self.out_indices = tuple(out_indices)
        bias = norm == "folded"
        self.conv1 = _conv(3, 64, 7, 2, bias=bias)
        self.bn1 = Norm(norm, 64, train)
        self.block_names: List[List[str]] = []
        basic = depth in BASIC_DEPTHS
        block_cls, expansion = (BasicBlock, 1) if basic else (Bottleneck, 4)
        cin, planes = 64, 64
        for stage, n_blocks in enumerate(STAGE_BLOCKS[depth][:num_stages]):
            names = []
            for b in range(n_blocks):
                name = f"layer{stage + 1}_{b}"
                stride = stage_strides[stage] if b == 0 else 1
                # a BasicBlock stage of stride 1 keeps 64 channels: no
                # projection
                down = b == 0 and not (basic and stage == 0 and stride == 1)
                self.add_module(name, block_cls(cin, planes, stride,
                                                downsample=down, norm=norm,
                                                train=train))
                cin = planes * expansion
                names.append(name)
            self.block_names.append(names)
            planes *= 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, H, W, 3) -> list of (B, h, w, C) stage outputs."""
        x = x.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage, names in enumerate(self.block_names):
            for name in names:
                x = getattr(self, name)(x)
            if stage in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return outs


def _bn_key_for(conv_key: str):
    if conv_key == "downsample_conv":
        return "downsample_bn"
    if conv_key.startswith("conv"):
        return "bn" + conv_key[len("conv"):]
    return None


def fold_frozen_bn(state_dict: Dict[str, torch.Tensor],
                   prefix: str = "backbone.",
                   eps: float = BN_EPS) -> Dict[str, torch.Tensor]:
    """Fold inference-mode BatchNorm into the preceding convs:
    BN(conv(x)) = conv(x) * s + b with s = gamma / sqrt(var + eps) and
    b = beta - mean * s, i.e. a conv with weight * s (per output channel)
    and bias b. Returns a new state dict for the same model built with
    backbone norm 'folded'; the BN entries are consumed. Same arithmetic as
    ``openpvsg_tpu.models.resnet.fold_frozen_bn`` (float32)."""
    out = dict(state_dict)
    for key in state_dict:
        if not (key.startswith(prefix) and key.endswith(".weight")):
            continue
        parent, name = key[:-len(".weight")].rsplit(".", 1)
        bn_name = _bn_key_for(name)
        bn = f"{parent}.{bn_name}.bn"
        if bn_name is None or f"{bn}.running_var" not in state_dict:
            continue
        gamma = state_dict[f"{bn}.weight"].float()
        beta = state_dict[f"{bn}.bias"].float()
        mean = state_dict[f"{bn}.running_mean"].float()
        var = state_dict[f"{bn}.running_var"].float()
        scale = gamma / torch.sqrt(var + eps)
        out[key] = state_dict[key].float() * scale[:, None, None, None]
        out[f"{parent}.{name}.bias"] = beta - mean * scale
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            del out[f"{bn}.{leaf}"]
    return out
