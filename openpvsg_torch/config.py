"""Configuration: the ``Mask2FormerConfig`` family, the segmenter's
``TrainConfig``, the relation head's ``RelationHeadConfig`` and their
presets (``mask2former_vps``, ``relation_head``, ``relation_conv_interact``,
``relation_conv_large``).

The port's own copy of the inference, stage-1 training and relation-head
fields of ``openpvsg_tpu.config`` (same names, same defaults), so a
configuration reads the same in both packages. Tracker and data settings,
and the segmenter training CLI's fields (epochs, seed, checkpoint and log
intervals), are not ported yet. ``check_training_config`` refuses the training values
this port does not run yet, naming the ``ROADMAP.md`` item that ports them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

from openpvsg_torch import NUM_RELATIONS, NUM_STUFF_CLASSES, NUM_THING_CLASSES


@dataclass(frozen=True)
class BackboneConfig:
    kind: str = "resnet"  # only 'resnet' is ported
    depth: int = 50
    # 'frozen_bn' / 'sync_bn' run BatchNorm with running statistics at
    # inference; 'folded' means the BN affine is folded into the convs.
    norm: str = "frozen_bn"
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    dtype: str = "float32"  # compute dtype; params always float32


@dataclass(frozen=True)
class PixelDecoderConfig:
    in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    feat_channels: int = 256
    out_channels: int = 256
    num_outs: int = 3
    encoder_layers: int = 6
    encoder: str = "axial"  # only the axial encoder is ported
    num_heads: int = 8
    num_levels: int = 3
    ffn_channels: int = 1024
    num_groups: int = 32  # GroupNorm groups


@dataclass(frozen=True)
class TransformerDecoderConfig:
    num_layers: int = 9
    num_heads: int = 8
    feat_channels: int = 256
    ffn_channels: int = 2048


@dataclass(frozen=True)
class Mask2FormerConfig:
    num_things_classes: int = NUM_THING_CLASSES
    num_stuff_classes: int = NUM_STUFF_CLASSES
    num_queries: int = 100
    num_transformer_feat_level: int = 3
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    pixel_decoder: PixelDecoderConfig = field(default_factory=PixelDecoderConfig)
    decoder: TransformerDecoderConfig = field(default_factory=TransformerDecoderConfig)
    # video (VPS) options
    video: bool = False
    num_frames: int = 2
    # loss weights (reference lines 97-117)
    loss_cls_weight: float = 2.0
    loss_mask_weight: float = 5.0
    loss_dice_weight: float = 5.0
    bg_cls_weight: float = 0.1
    # 'dense': mask losses and matching costs over every stride-4 pixel;
    # 'points': the reference's point-rend sampling (not ported)
    loss_sampling: str = "dense"
    # 'auto' | 'hungarian' (host LAP) | 'lapjv' | 'greedy' (not ported)
    assigner: str = "auto"
    # average-pool factor of the matching operands (1 = exact)
    match_downsample: int = 1
    # dense mask-loss layout: 'query' | 'target' (not ported)
    loss_layout: str = "query"
    # storage dtype of the per-layer mask logits: 'float32' | 'bfloat16'
    mask_logits_dtype: str = "float32"
    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    # fusion thresholds (reference test cfg)
    object_mask_thr: float = 0.8
    iou_thr: float = 0.8
    # head variants: split thing/stuff queries, focal classification loss,
    # per-pixel semantic aux head
    split_thing_stuff: bool = False
    focal_cls: bool = False
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    with_sem_seg: bool = False
    sem_seg_weight: float = 1.0

    @property
    def num_classes(self) -> int:
        return self.num_things_classes + self.num_stuff_classes


@dataclass(frozen=True)
class TrainConfig:
    """Segmenter optimization (reference config lines 163-191 + schedules).
    ``samples_per_gpu`` is the clips per step that ``chip_smoke.py``'s train
    phase starts from."""
    lr: float = 1e-4
    weight_decay: float = 0.05
    backbone_lr_mult: float = 0.1
    grad_clip: float = 0.01
    lr_step_epochs: Tuple[int, ...] = (7,)
    lr_gamma: float = 0.1
    warmup_iters: int = 10
    warmup_ratio: float = 1e-3
    samples_per_gpu: int = 32


@dataclass(frozen=True)
class RelationHeadConfig:
    """Relation-head hyperparameters (reference: tools/rel_train.py:38-97).
    The capacity knobs default to the reference's fixed values: encoders
    d 256, 8 heads, ffn 512, 2 layers; temporal transformer 4 heads, ffn
    512, 1 layer; conv kernel 5."""
    model_name: str = "transformer"  # vanilla | filter | conv | transformer
    d_model: int = 256
    encoder_layers: int = 2
    encoder_heads: int = 8
    encoder_ffn: int = 512
    temporal_layers: int = 1
    temporal_heads: int = 4
    temporal_ffn: int = 512
    num_relations: int = NUM_RELATIONS
    num_top_pairs: int = 100
    max_tubes: int = 100
    max_frames: int = 900
    conv_kernel: int = 5
    # beyond the reference: feed [s, o, s-o, s*o] (not just [s, o]) to the
    # temporal model (``RelationModel.pair_interaction``)
    pair_interaction: bool = False
    # training
    lr: float = 1e-4
    epochs: int = 100
    accumulation_steps: int = 32
    loss_prob_weight: float = 5.0


@dataclass(frozen=True)
class PVSGConfig:
    name: str = "mask2former_ips"
    model: Mask2FormerConfig = field(default_factory=Mask2FormerConfig)
    relation: RelationHeadConfig = field(default_factory=RelationHeadConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def mask2former_vps() -> PVSGConfig:
    """configs/mask2former_vps/mask2former_video_r50.py: R-50 with SyncBN,
    trained on 2-frame clips with the 3-D positional encoding; stage 2 runs
    each frame with T=1 and stitches MinVIS windows."""
    return PVSGConfig(
        name="mask2former_vps",
        model=Mask2FormerConfig(video=True, num_frames=2,
                                backbone=BackboneConfig(norm="sync_bn")),
        train=TrainConfig(samples_per_gpu=16),
    )


def relation_head(model_name: str = "transformer") -> PVSGConfig:
    """The reference's relation heads: 'vanilla', 'filter', 'conv' or
    'transformer' (the reference's default) at its fixed widths."""
    return PVSGConfig(name=f"relation_{model_name}",
                      relation=RelationHeadConfig(model_name=model_name))


def relation_conv_interact() -> PVSGConfig:
    """The capacity study's winning cell: the temporal-conv head with the
    pair-interaction input and larger encoders and temporal model."""
    return PVSGConfig(
        name="relation_conv_interact",
        relation=RelationHeadConfig(
            model_name="conv", pair_interaction=True,
            encoder_layers=3, encoder_ffn=1024,
            temporal_layers=2, temporal_heads=8, temporal_ffn=1024))


def relation_conv_large() -> PVSGConfig:
    """``relation_conv_interact``'s capacity without the pair-interaction
    input: the head to prefer when each predicate has plenty of training
    data."""
    return PVSGConfig(
        name="relation_conv_large",
        relation=RelationHeadConfig(
            model_name="conv",
            encoder_layers=3, encoder_ffn=1024,
            temporal_layers=2, temporal_heads=8, temporal_ffn=1024))


def resolve_assigner(cfg: Mask2FormerConfig) -> str:
    """'auto' is the host Hungarian on every device of the port: the LAP
    runs on the host after one copy of the cost tensor, on CPU and CUDA
    alike."""
    return "hungarian" if cfg.assigner == "auto" else cfg.assigner


def check_training_config(cfg: Mask2FormerConfig) -> None:
    """Raise ValueError for a training value this port does not run yet,
    whether or not the JAX package accepts it; the message names the
    ROADMAP.md item. The knobs of the unported modes (points, focal, the
    semantic head) are refused too, so that setting one never does nothing.
    ``check_assigner_capacity`` (``openpvsg_tpu/train/segmenter.py:137``)
    guards LAPJV's N <= Q and comes with LAPJV."""
    unported = {
        "loss_sampling": (cfg.loss_sampling, "dense"),
        "num_points": (cfg.num_points, 12544),
        "oversample_ratio": (cfg.oversample_ratio, 3.0),
        "importance_sample_ratio": (cfg.importance_sample_ratio, 0.75),
        "assigner": (resolve_assigner(cfg), "hungarian"),
        "match_downsample": (cfg.match_downsample, 1),
        "loss_layout": (cfg.loss_layout, "query"),
        "mask_logits_dtype": (cfg.mask_logits_dtype, "float32"),
        "split_thing_stuff": (cfg.split_thing_stuff, False),
        "focal_cls": (cfg.focal_cls, False),
        "focal_gamma": (cfg.focal_gamma, 2.0),
        "focal_alpha": (cfg.focal_alpha, 0.25),
        "with_sem_seg": (cfg.with_sem_seg, False),
        "sem_seg_weight": (cfg.sem_seg_weight, 1.0),
        "backbone.dtype": (cfg.backbone.dtype, "float32"),
    }
    for name, (value, ported) in unported.items():
        if value != ported:
            raise ValueError(
                f"model.{name}={value!r} is not ported to openpvsg_torch "
                f"training (only {ported!r}); ROADMAP.md A9c ports it")
