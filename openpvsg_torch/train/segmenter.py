"""Segmenter (VPS) training on one device: parameter groups, the optax
recipe, the LR schedule and the train step — the port of
``openpvsg_tpu/train/segmenter.py:36-117,185-310``.

The recipe (reference: configs/mask2former/..._custom.py:163-191):

  clip_by_global_norm(0.01) over all parameters, then per group
  AdamW (b1 0.9, b2 0.999, eps 1e-8), weight decay 0.05 where the decay
  mask allows, lr 1e-4 * schedule(count) * lr_mult; the backbone group's
  lr_mult is 0.1, which also scales its decay
  schedule: linear warmup from warmup_ratio, x lr_gamma at each step epoch

The objective is the configured one: dense or point-sampled
(``loss_sampling``), with or without the thing/stuff query split
(``split_thing_stuff``); ``SegmenterTrainer.loss`` computes it from the
model's predictions.

Groups and the decay mask are the JAX package's rules applied to the flax
path of each parameter (``weights.flax_path``). torch's AdamW with those
groups is optax's chain: its decoupled decay p *= 1 - lr * wd before the
Adam step is optax's ``add_decayed_weights`` before
``scale_by_learning_rate``. The clip is written out, because
``clip_grad_norm_`` adds 1e-6 to the norm.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from openpvsg_torch.config import (Mask2FormerConfig, TrainConfig,
                                   check_training_config)
from openpvsg_torch.infer.segmenter import resolve_device
from openpvsg_torch.models.mask2former import Mask2Former
from openpvsg_torch.ops.sampling import uniform_draw
from openpvsg_torch.train.assign import assignment_costs, lap_assign
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
    """TF32 off for cuBLAS and cuDNN inside the block, restored after: the
    trainer computes in float32 (``backbone.dtype``), which torch's default
    for cuDNN convolutions (TF32) would not be."""
    matmul = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


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

    ``device=None`` means the GPU and raises without one; pass
    ``device="cpu"`` to train on the CPU. The forward and backward run in
    IEEE float32 with TF32 off, whatever the global settings, and leave
    those settings as they found them. ``state_dict`` (the port's float32
    state dict) defaults to ``random_state_dict(cfg, seed)``. In points mode
    every uniform draw (matching and loss points) comes from ``draw``, by
    default ``generator``, a ``torch.Generator`` on the trainer's device
    seeded with ``seed``; checkpoints save and restore its state. After each step
    ``last_assigned`` holds the (L, B, Q) assignment and ``last_timings``
    the host seconds blocked in the cost copy (``cost_wait_s``: it waits for
    the device to finish the forward and the costs) and spent in the host
    LAP (``host_lap_s``, while the device has nothing queued).
    """

    def __init__(self, cfg: Mask2FormerConfig, train_cfg: TrainConfig,
                 steps_per_epoch: int = 1000, device=None, seed: int = 0,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 norm_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53),
                 norm_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)):
        check_training_config(cfg)
        self.cfg = cfg
        self.train_cfg = train_cfg
        self.device = resolve_device(device)
        model = Mask2Former(cfg, train=True)
        model.load_state_dict(random_state_dict(cfg, seed) if state_dict is None
                              else state_dict, strict=True)
        self.model = model.to(self.device)
        self.params = list(self.model.parameters())
        self.optimizer = torch.optim.AdamW(
            param_groups(self.model, train_cfg), lr=0.0, betas=(0.9, 0.999),
            eps=1e-8)
        self.schedule = make_lr_schedule(train_cfg, steps_per_epoch)
        self.step_count = 0
        self._mean = torch.tensor(norm_mean, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(norm_std, dtype=torch.float32, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.draw = uniform_draw(self.generator)
        self.last_assigned: Optional[np.ndarray] = None
        self.last_timings: Dict[str, float] = {}

    def device_batch(self, batch: Dict):
        """The batch's (images normalized float32, gt_labels int64,
        gt_masks float32, gt_valid bool) on the trainer's device."""
        def dev(x, dtype=None):  # copy as given, convert on the device
            t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
            return t.to(self.device).to(dtype)

        images = dev(batch["images"])
        if images.dtype == torch.uint8:
            images = (images.float() - self._mean) / self._std
        return (images.float(), dev(batch["gt_labels"], torch.int64),
                dev(batch["gt_masks"], torch.float32),
                dev(batch["gt_valid"], torch.bool))

    def loss_and_grads(self, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Forward, assignment, loss and backward: fills ``.grad`` of every
        parameter (zeros where the loss does not reach one, as optax sees
        it) and returns (loss, logs) as device tensors. Updates the BN
        running statistics; does not step the optimizer. Runs in IEEE
        float32 (``ieee_float32``) whatever the caller's TF32 settings."""
        with ieee_float32():
            return self._loss_and_grads(batch)

    def _loss_and_grads(self, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        images, gt_labels, gt_masks, gt_valid = self.device_batch(batch)
        cls_preds, mask_preds, _ = self.model(images)
        loss, logs = self.loss(cls_preds, mask_preds, gt_labels, gt_masks, gt_valid)
        logs["loss"] = loss
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return loss, logs

    def loss(self, cls_preds, mask_preds, gt_labels, gt_masks, gt_valid
             ) -> Tuple[torch.Tensor, Dict]:
        """The configured objective of the model's predictions: the costs
        on the device, their copy and the host LAP (timed into
        ``last_timings``, the assignment kept in ``last_assigned``), then
        ``mask2former_loss``; points draws from ``self.draw``."""
        cfg = self.cfg
        kw = dict(cls_weight=cfg.loss_cls_weight, mask_weight=cfg.loss_mask_weight,
                  dice_weight=cfg.loss_dice_weight,
                  num_points=cfg.num_points if cfg.loss_sampling == "points" else 0,
                  draw=self.draw,
                  num_stuff_queries=cfg.num_stuff_classes if cfg.split_thing_stuff else 0,
                  num_things_classes=cfg.num_things_classes)
        costs = assignment_costs(cls_preds.detach(), mask_preds.detach(),
                                 gt_labels, gt_masks, gt_valid, **kw)
        t0 = time.perf_counter()
        host_costs = costs.cpu().numpy()
        t1 = time.perf_counter()
        self.last_assigned = lap_assign(host_costs, kw["num_stuff_queries"])
        self.last_timings = {"cost_wait_s": t1 - t0,
                             "host_lap_s": time.perf_counter() - t1}
        return mask2former_loss(
            cls_preds, mask_preds, gt_labels, gt_masks, gt_valid,
            cfg.num_classes, bg_cls_weight=cfg.bg_cls_weight,
            assigned=self.last_assigned,
            oversample_ratio=cfg.oversample_ratio,
            importance_sample_ratio=cfg.importance_sample_ratio, **kw)

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
        ``loss_cls``/``loss_mask``/``loss_dice``) as floats."""
        _, logs = self.loss_and_grads(batch)
        self.apply_updates()
        values = torch.stack([v.detach().float() for v in logs.values()]).cpu()
        return dict(zip(logs, values.tolist()))
