"""Segmenter (VPS) training on one device or over the ranks of a process
group: parameter groups, the optax recipe, the LR schedule and the train
step — the port of ``openpvsg_tpu/train/segmenter.py:14-18,36-117,185-310``.

The recipe (reference: configs/mask2former/..._custom.py:163-191):

  clip_by_global_norm(0.01) over all parameters, then per group
  AdamW (b1 0.9, b2 0.999, eps 1e-8), weight decay 0.05 where the decay
  mask allows, lr 1e-4 * schedule(count) * lr_mult; the backbone group's
  lr_mult is 0.1, which also scales its decay
  schedule: linear warmup from warmup_ratio, x lr_gamma at each step epoch

The objective is the configured one: dense or point-sampled
(``loss_sampling``), with or without the thing/stuff query split
(``split_thing_stuff``), matched by the host Hungarian, LAPJV or greedy on
the device (``assigner``, on operands pooled by ``match_downsample``), with
the mask losses in the query or the target layout (``loss_layout``), the
softmax or the focal classification loss (``focal_cls``), bfloat16 or
float32 mask logits and GT masks (``mask_logits_dtype``), and the semantic
head's loss when a batch carries ``gt_semantic`` (``with_sem_seg``; as in
the JAX trainer, no data path of either package fills it).
``SegmenterTrainer.loss`` computes it from the model's predictions.

Compute dtype (``model.backbone.dtype``): 'float32', or 'bfloat16' with
float32 parameters, as the JAX trainer builds its model at
``compute_dtype`` (``openpvsg_tpu/train/segmenter.py:208-214``). The
trainer keeps its float32 ``nn.Parameter``s and sets the model layers'
``compute_dtype`` (``models/layers.py``): each Dense and Conv computes on
bfloat16 casts of its input and weights, each norm takes float32
statistics, and autograd returns float32 gradients through the casts. The
optimizer, the clip and the checkpoints are the float32 path's; the loss
sums accumulate in float32.

Groups and the decay mask are the JAX package's rules applied to the flax
path of each parameter (``weights.flax_path``). torch's AdamW with those
groups is optax's chain: its decoupled decay p *= 1 - lr * wd before the
Adam step is optax's ``add_decayed_weights`` before
``scale_by_learning_rate``. The clip is written out, because
``clip_grad_norm_`` adds 1e-6 to the norm.

Data parallelism (``process_group``): the JAX trainer shards the global
batch over its mesh under ``pjit``, so its step is the one-device step on
the global batch. Here each rank of the group takes its contiguous block of
the global batch; 'sync_bn' reduces its batch statistics over the group
(``models/resnet.py:set_process_group``), the loss normalizers are summed
over it (``train/losses.py``), and each rank takes its slice of the global
batch's point draws (``ops/sampling.py:rank_draw``). The ranks' losses then
add up to the
global batch's loss, and one flat all-reduce sums their gradients into its
gradient, identical on every rank, which each rank clips by its global norm
and applies. Rank 0's parameters and statistics are broadcast at
construction. The logs are the global batch's.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from openpvsg_torch.config import (Mask2FormerConfig, TrainConfig,
                                   check_assigner_capacity,
                                   check_training_config, resolve_assigner)
from openpvsg_torch.infer.segmenter import resolve_device
from openpvsg_torch.models.layers import set_compute_dtype
from openpvsg_torch.models.mask2former import Mask2Former
from openpvsg_torch.models.resnet import set_process_group
from openpvsg_torch.ops.sampling import rank_draw, uniform_draw
from openpvsg_torch.parallel.mesh import all_reduce_sum, broadcast_, split_blocks
from openpvsg_torch.train.assign import (assignment_costs, lap_assign,
                                         solve_assignment)
from openpvsg_torch.train.losses import mask2former_loss
from openpvsg_torch.weights import flax_path, random_state_dict

_EMBEDS = ("query_embed", "query_feat", "level_embed")


def param_label(path: Sequence[str]) -> str:
    """'backbone' / 'no_decay' / 'default' for a flax params path
    (``_param_labels``, ``openpvsg_tpu/train/segmenter.py:36``)."""
    joined = "/".join(path)
    if any(k in joined for k in _EMBEDS):
        return "no_decay"
    if joined.startswith("backbone/"):
        return "backbone"
    return "default"


def decays(path: Sequence[str]) -> bool:
    """Whether weight decay applies to a flax params path: not to embeds,
    biases and norm scales (``_decay_mask``, ``segmenter.py:53``)."""
    joined = "/".join(path)
    no = (any(k in joined for k in _EMBEDS)
          or path[-1] == "bias"
          or any(n in joined for n in ("norm", "bn", "gn", "LayerNorm"))
          or path[-1] == "scale")
    return not no


def param_groups(model: torch.nn.Module, cfg: TrainConfig) -> List[dict]:
    """torch optimizer groups, one per (label, decay): each names its
    ``label``, ``lr_mult`` and ``weight_decay`` (0 for the 'no_decay'
    label and where the decay mask is False)."""
    groups: Dict[Tuple[str, bool], List[torch.nn.Parameter]] = {}
    for name, p in model.named_parameters():
        _, path = flax_path(name, p.ndim)
        label = param_label(path)
        decay = label != "no_decay" and decays(path)
        groups.setdefault((label, decay), []).append(p)
    return [{"params": ps, "label": label, "lr": 0.0,
             "lr_mult": cfg.backbone_lr_mult if label == "backbone" else 1.0,
             "weight_decay": cfg.weight_decay if decay else 0.0}
            for (label, decay), ps in sorted(groups.items())]


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int):
    """count -> lr, in float32 as the JAX schedule computes it: optax's
    ``piecewise_constant_schedule`` (x lr_gamma for each boundary with
    count >= boundary) times the linear warmup from ``warmup_ratio`` over
    ``warmup_iters``; count starts at 0."""
    boundaries = {e * steps_per_epoch: cfg.lr_gamma for e in cfg.lr_step_epochs}
    f32 = np.float32

    def schedule(count: int) -> np.float32:
        lr = f32(cfg.lr)
        for threshold, scale in sorted(boundaries.items()):
            if count >= threshold:
                lr = f32(scale) * lr
        warm = min(f32(count) / f32(max(cfg.warmup_iters, 1)), f32(1.0))
        return lr * (f32(cfg.warmup_ratio) + f32(1 - cfg.warmup_ratio) * warm)

    return schedule


def cosine_warmup_schedule(max_lr: float, min_lr: float, warmup_epochs: int,
                           num_epochs: int, steps_per_epoch: int):
    """count -> lr in float32: optax's ``warmup_cosine_decay_schedule``
    from ``min_lr`` up to ``max_lr`` over ``warmup_epochs`` and a cosine
    back to ``min_lr`` at ``num_epochs`` (``cosine_warmup_schedule``,
    ``openpvsg_tpu/train/segmenter.py:84``; reference:
    utils/lr_scheduler.py:6-34). Like the JAX package's, no trainer uses
    it."""
    f32 = np.float32
    warmup = max(warmup_epochs * steps_per_epoch, 1)
    decay = max(num_epochs * steps_per_epoch, 2) - warmup
    alpha = 0.0 if max_lr == 0.0 else min_lr / max_lr

    def schedule(count: int) -> np.float32:
        if count < warmup:  # optax linear_schedule(min_lr -> max_lr)
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return f32(min_lr - max_lr) * frac + f32(max_lr)
        # cosine_decay_schedule(max_lr, decay, alpha) at count - warmup
        c = min(f32(count - warmup), f32(decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
        return f32(max_lr) * (f32(1 - alpha) * cosine + f32(alpha))

    return schedule


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: g -> (g / norm) * max_norm
    when the global L2 norm is not below ``max_norm`` (no epsilon), decided
    on the device. Returns the norm."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


@contextlib.contextmanager
def ieee_float32():
    """TF32 off for cuBLAS and cuDNN inside the block, and cuBLAS's
    reduced-precision bfloat16 reductions too, restored after: the
    trainer's float32 products are IEEE float32, which torch's default for
    cuDNN convolutions (TF32) would not be, and its bfloat16 products
    accumulate in float32, as XLA's do."""
    matmul = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (matmul.allow_tf32, cudnn.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = saved


def pad_targets(samples, max_instances: int, mask_stride: int = 4):
    """Stack per-sample GT into fixed-shape batch arrays (the port's copy of
    ``tools/train.py:21``): images (B, T, H, W, 3), gt_labels (B, N) int32,
    gt_masks (B, N, T, H/s, W/s) uint8 by a strided (nearest) view,
    gt_valid (B, N) bool, with N = max_instances."""
    B = len(samples)
    T, H, W = samples[0]["images"].shape[:3]
    hm, wm = H // mask_stride, W // mask_stride
    images = np.stack([s["images"] for s in samples])
    gt_labels = np.zeros((B, max_instances), np.int32)
    gt_masks = np.zeros((B, max_instances, T, hm, wm), np.uint8)
    gt_valid = np.zeros((B, max_instances), bool)
    for i, s in enumerate(samples):
        n = min(len(s["gt_labels"]), max_instances)
        gt_labels[i, :n] = s["gt_labels"][:n]
        gt_valid[i, :n] = True
        for j in range(n):
            m = s["gt_mask_tubes"][j]  # (T, H, W)
            gt_masks[i, j] = m[:, ::mask_stride, ::mask_stride][:, :hm, :wm]
    return {"images": images, "gt_labels": gt_labels,
            "gt_masks": gt_masks, "gt_valid": gt_valid}


class SegmenterTrainer:
    """Owns the train-mode model and the optimizer on one device.

    batch dict (host numpy or tensors), as the JAX trainer takes it:
      images    (B, T, H, W, 3) normalized float32, or uint8 (normalized
                here on the device with ``norm_mean`` / ``norm_std``)
      gt_labels (B, N) int, padded
      gt_masks  (B, N, T, H/4, W/4) binary at mask-feature resolution
      gt_valid  (B, N) bool
      gt_semantic (B, T, H/4, W/4) class ids, optional: the semantic
                head's target (its loss is added only when it is given)

    ``device=None`` means the GPU and raises without one; pass
    ``device="cpu"`` to train on the CPU. The forward and backward compute
    in ``model.backbone.dtype`` (float32, or bfloat16 over float32
    parameters), with IEEE float32 (TF32 off) for the float32 products and
    float32 accumulation for the bfloat16 ones, whatever the global
    settings, and leave those settings as they found them. ``state_dict`` (the port's float32
    state dict) defaults to ``random_state_dict(cfg, seed)``. In points mode
    every uniform draw (matching and loss points) comes from ``draw``, by
    default ``generator``, a ``torch.Generator`` on the trainer's device
    seeded with ``seed``; checkpoints save and restore its state. After each step
    ``last_assigned`` holds the (L, B, Q) assignment and ``last_timings``
    the host seconds: with the host Hungarian, blocked in the cost copy
    (``cost_wait_s``: it waits for the device to finish the forward and the
    costs) and spent in the host LAP (``host_lap_s``, while the device has
    nothing queued); with 'lapjv' or 'greedy', from the costs' enqueue to
    the assignment on the host (``device_assign_s``, the forward's tail
    included).

    With a ``process_group`` (``torch.distributed``; the device is then this
    rank's) every ``step`` takes the global batch, whose size the group's
    size must divide, and computes on this rank's contiguous block of it;
    ``draw`` hands each rank its slice of the global batch's draws.
    """

    def __init__(self, cfg: Mask2FormerConfig, train_cfg: TrainConfig,
                 steps_per_epoch: int = 1000, device=None, seed: int = 0,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 norm_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53),
                 norm_std: Tuple[float, float, float] = (58.395, 57.12, 57.375),
                 process_group=None):
        check_training_config(cfg)
        self.cfg = cfg
        self.assigner = resolve_assigner(cfg)
        self.train_cfg = train_cfg
        self.device = resolve_device(device)
        model = Mask2Former(cfg, train=True)
        model.load_state_dict(random_state_dict(cfg, seed) if state_dict is None
                              else state_dict, strict=True)
        if cfg.backbone.dtype == "bfloat16":
            set_compute_dtype(model, torch.bfloat16)
        self.model = model.to(self.device)
        self.params = list(self.model.parameters())
        self.group = process_group
        self.rank, self.world = 0, 1
        if process_group is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank(process_group)
            self.world = dist.get_world_size(process_group)
            set_process_group(self.model, process_group)
            with torch.no_grad():
                broadcast_(list(self.model.state_dict().values()),
                           dist.get_global_rank(process_group, 0), process_group)
        self.optimizer = torch.optim.AdamW(
            param_groups(self.model, train_cfg), lr=0.0, betas=(0.9, 0.999),
            eps=1e-8)
        self.schedule = make_lr_schedule(train_cfg, steps_per_epoch)
        self.step_count = 0
        self._mean = torch.tensor(norm_mean, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(norm_std, dtype=torch.float32, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.draw = uniform_draw(self.generator)
        if self.world > 1:
            self.draw = rank_draw(self.draw, self.rank, self.world)
        self.last_assigned: Optional[np.ndarray] = None
        self.last_timings: Dict[str, float] = {}

    def local_batch(self, batch: Dict) -> Dict:
        """This rank's contiguous block of the global batch (all of it
        without a process group)."""
        if self.group is None:
            return batch
        return split_blocks(batch, self.world)[self.rank]

    def global_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the process group (a copy)."""
        t = t.detach().clone()
        all_reduce_sum([t], self.group)
        return t

    def device_batch(self, batch: Dict):
        """The batch's (images normalized float32, gt_labels int64,
        gt_masks float32 (bfloat16 with ``mask_logits_dtype``: exact for
        0/1), gt_valid bool) on the trainer's device."""
        def dev(x, dtype=None):  # copy as given, convert on the device
            t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
            return t.to(self.device).to(dtype)

        images = dev(batch["images"])
        if images.dtype == torch.uint8:
            images = (images.float() - self._mean) / self._std
        gt_dtype = (torch.bfloat16 if self.cfg.mask_logits_dtype == "bfloat16"
                    else torch.float32)
        return (images.float(), dev(batch["gt_labels"], torch.int64),
                dev(batch["gt_masks"], gt_dtype),
                dev(batch["gt_valid"], torch.bool))

    def loss_and_grads(self, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Forward, assignment, loss and backward: fills ``.grad`` of every
        parameter (zeros where the loss does not reach one, as optax sees
        it) and returns (loss, logs) as device tensors. Updates the BN
        running statistics; does not step the optimizer. Runs under
        ``ieee_float32`` whatever the caller's settings. With a process
        group ``batch`` is the global batch, and the gradients and the logs
        are the global batch's, summed over the ranks."""
        with ieee_float32():
            return self._loss_and_grads(batch)

    def _loss_and_grads(self, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        batch = self.local_batch(batch)
        images, gt_labels, gt_masks, gt_valid = self.device_batch(batch)
        cls_preds, mask_preds, _, sem_seg = self.model(images, return_sem_seg=True)
        gt_semantic = batch.get("gt_semantic")
        if gt_semantic is not None:
            gt_semantic = torch.as_tensor(np.asarray(gt_semantic)).to(self.device)
        loss, logs = self.loss(cls_preds, mask_preds, gt_labels, gt_masks,
                               gt_valid, sem_seg, gt_semantic)
        logs["loss"] = loss
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.group is not None:
            all_reduce_sum([p.grad for p in self.params], self.group)
            values = torch.stack([v.detach().float() for v in logs.values()])
            all_reduce_sum([values], self.group)
            logs = dict(zip(logs, values.unbind()))
            loss = logs["loss"]
        return loss, logs

    def loss(self, cls_preds, mask_preds, gt_labels, gt_masks, gt_valid,
             sem_seg=None, gt_semantic=None) -> Tuple[torch.Tensor, Dict]:
        """The configured objective of the model's predictions: the costs
        on the device, then the assignment (timed into ``last_timings``,
        kept in ``last_assigned``), then ``mask2former_loss``; points draws
        from ``self.draw``."""
        cfg = self.cfg
        kw = dict(cls_weight=cfg.loss_cls_weight, mask_weight=cfg.loss_mask_weight,
                  dice_weight=cfg.loss_dice_weight,
                  num_points=cfg.num_points if cfg.loss_sampling == "points" else 0,
                  draw=self.draw,
                  num_stuff_queries=cfg.num_stuff_classes if cfg.split_thing_stuff else 0,
                  num_things_classes=cfg.num_things_classes)
        costs = assignment_costs(cls_preds.detach(), mask_preds.detach(),
                                 gt_labels, gt_masks, gt_valid,
                                 match_downsample=cfg.match_downsample, **kw)
        t0 = time.perf_counter()
        if self.assigner == "hungarian":
            host_costs = costs.cpu().numpy()
            t1 = time.perf_counter()
            self.last_assigned = lap_assign(host_costs, kw["num_stuff_queries"])
            self.last_timings = {"cost_wait_s": t1 - t0,
                                 "host_lap_s": time.perf_counter() - t1}
        else:
            self.last_assigned = solve_assignment(costs, self.assigner,
                                                  kw["num_stuff_queries"])
            self.last_timings = {"device_assign_s": time.perf_counter() - t0}
        return mask2former_loss(
            cls_preds, mask_preds, gt_labels, gt_masks, gt_valid,
            cfg.num_classes, bg_cls_weight=cfg.bg_cls_weight,
            assigned=self.last_assigned,
            oversample_ratio=cfg.oversample_ratio,
            importance_sample_ratio=cfg.importance_sample_ratio,
            loss_layout=cfg.loss_layout, focal=cfg.focal_cls,
            focal_gamma=cfg.focal_gamma, focal_alpha=cfg.focal_alpha,
            sem_seg_logits=sem_seg, gt_semantic=gt_semantic,
            sem_seg_weight=cfg.sem_seg_weight,
            global_sum=None if self.group is None else self.global_sum, **kw)

    def apply_updates(self) -> None:
        """Clip the gradients by their global norm, then one AdamW step of
        every group at ``schedule(step_count) * lr_mult``."""
        clip_by_global_norm_([p.grad for p in self.params],
                             self.train_cfg.grad_clip)
        lr = self.schedule(self.step_count)
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr * np.float32(group["lr_mult"]))
        self.optimizer.step()
        self.step_count += 1

    def step(self, batch: Dict) -> Dict[str, float]:
        """One train step; returns the logs (``loss`` and the per-layer
        ``loss_cls``/``loss_mask``/``loss_dice``) as floats. With LAPJV the
        batch's padded target count must not exceed ``num_queries``
        (``check_assigner_capacity``)."""
        if self.assigner == "lapjv":
            check_assigner_capacity(self.cfg, np.shape(batch["gt_labels"])[1])
        _, logs = self.loss_and_grads(batch)
        self.apply_updates()
        values = torch.stack([v.detach().float() for v in logs.values()]).cpu()
        return dict(zip(logs, values.tolist()))
