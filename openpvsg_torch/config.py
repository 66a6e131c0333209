"""Configuration: the ``Mask2FormerConfig`` family, the segmenter's
``TrainConfig``, the tracker's ``TrackerConfig``, the relation head's
``RelationHeadConfig``, the data pipeline's ``DataConfig``, their presets,
and the ``config.json`` and ``--set key=value`` plumbing of the CLIs.

The port's own copy of ``openpvsg_tpu.config`` (same names, same defaults,
the same fields), so a configuration reads the same in both packages and
``load_config_file`` reads every ``config.json`` of the JAX package.
``check_training_config`` accepts
every training value of ``Mask2FormerConfig`` that the JAX package accepts
(the compute dtype float32 or bfloat16 among them) and raises the JAX
package's errors for the invalid ones.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

from openpvsg_torch import NUM_RELATIONS, NUM_STUFF_CLASSES, NUM_THING_CLASSES


@dataclass(frozen=True)
class BackboneConfig:
    kind: str = "resnet"  # 'resnet' | 'swin'
    depth: int = 50
    swin_variant: str = "tiny"  # tiny | small | base | large
    # 'frozen_bn' / 'sync_bn' run BatchNorm with running statistics at
    # inference; 'gn' a 32-group GroupNorm; 'folded' means the BN affine is
    # folded into the convs.
    norm: str = "frozen_bn"
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    dtype: str = "float32"  # compute dtype; params always float32


@dataclass(frozen=True)
class PixelDecoderConfig:
    in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    # the backbone strides of ``in_channels``, as in the JAX schema; neither
    # package reads them
    strides: Tuple[int, ...] = (4, 8, 16, 32)
    feat_channels: int = 256
    out_channels: int = 256
    num_outs: int = 3
    encoder_layers: int = 6
    # 'axial': the dense encoder (the default); 'msda': the reference's
    # multi-scale deformable attention, the one its checkpoints hold
    encoder: str = "axial"
    num_heads: int = 8
    num_levels: int = 3
    num_points: int = 4  # MSDA sampling points per head and level
    ffn_channels: int = 1024
    num_groups: int = 32  # GroupNorm groups
    # the JAX package's switch of the fused stride-4 kernel; it selects
    # nothing in the port, which always launches kernel B1 when serving on
    # the card and runs the plain chain on the CPU and in training
    fused_fpn: bool = False


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
    # 'points': the reference's point-rend sampling (num_points uniform
    # points for the costs, uncertainty-sampled points for the losses)
    loss_sampling: str = "dense"
    # 'auto' (= 'hungarian') | 'hungarian' (host LAP) | 'lapjv' (exact, on
    # the device) | 'greedy' (on the device, approximate)
    assigner: str = "auto"
    # average-pool factor of the matching operands (1 = exact; dense only)
    match_downsample: int = 1
    # dense mask-loss layout: 'query' (GT gathered to every query) |
    # 'target' (the matched predictions gathered to the targets; same sums)
    loss_layout: str = "query"
    # storage dtype of the per-layer mask logits: 'float32' | 'bfloat16'
    # (float32 accumulation; the trainer's GT masks follow it)
    mask_logits_dtype: str = "float32"
    # serving only: backbone and pixel-decoder kernels held as int8 with
    # per-output-channel scales, dequantized inside every forward
    # (``utils/quantize.py``, ``infer/segmenter.py``); training ignores it
    int8_weights: bool = False
    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    # fusion thresholds (reference test cfg)
    object_mask_thr: float = 0.8
    iou_thr: float = 0.8
    # instance_postprocess's test cfg; as in the JAX package no code reads
    # them (``models/fusion.py:instance_postprocess`` takes its top-k count
    # as an argument)
    max_per_image: int = 100
    filter_low_score: bool = True
    # head variants: split thing/stuff queries (the last num_stuff_classes
    # queries take only stuff targets), sigmoid focal classification loss,
    # per-pixel semantic aux head (a 1x1 conv on the mask features, trained
    # when a batch carries ``gt_semantic``)
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
    ``samples_per_gpu`` sets the train CLI's global batch
    (``max(samples_per_gpu // 4, world)`` clips, rounded down to a multiple
    of the ranks of a multi-process run); ``epochs``,
    ``seed``, ``checkpoint_interval`` and ``log_interval`` are read by the
    train CLI only."""
    lr: float = 1e-4
    weight_decay: float = 0.05
    backbone_lr_mult: float = 0.1
    # as in the JAX package, the embeddings never decay whatever its value
    # (``train/segmenter.py:decays``)
    embed_no_decay: bool = True
    grad_clip: float = 0.01
    epochs: int = 8
    lr_step_epochs: Tuple[int, ...] = (7,)
    lr_gamma: float = 0.1
    warmup_iters: int = 10
    warmup_ratio: float = 1e-3
    samples_per_gpu: int = 32
    seed: int = 0
    checkpoint_interval: int = 1
    log_interval: int = 50


@dataclass(frozen=True)
class DataConfig:
    data_dir: str = "./data"
    anno_file: str = "./data/pvsg.json"
    work_dir: str = "./work_dirs"
    # train pipeline (reference: configs/_base_/datasets/pvsg_vps.py:4-22)
    train_scale: Tuple[int, int] = (360, 480)  # (h, w), keep_ratio=False
    crop_size: Tuple[int, int] = (360, 480)
    flip_prob: float = 0.5
    pad_divisor: int = 32
    # the ImageNet RGB statistics on RGB-loaded frames (to_rgb=False)
    mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    to_rgb: bool = False
    ref_seq_index: Tuple[int, ...] = (0, 1)  # 2-frame VPS clips
    ref_seq_len_test: int = 2
    num_workers: int = 4


@dataclass(frozen=True)
class TrackerConfig:
    """UniTrack MOTS association parameters of IPS stage 2 (reference:
    configs/unitrack/imagenet_resnet50_s3_womotion_timecycle.py:5-41).
    ``feat_size``, ``prop_flag`` and ``down_factor`` are read by nothing,
    as in the JAX package."""
    conf_thres: float = 0.5
    track_buffer: int = 300
    use_kalman: bool = True
    asso_with_motion: bool = False
    motion_lambda: float = 0.98
    motion_gated: bool = False
    dup_iou_thres: float = 0.15
    confirm_iou_thres: float = 0.7
    max_mask_area: int = 300
    feat_size: Tuple[int, int] = (4, 10)
    first_assoc_thresh: float = 0.9  # appearance association cost limit
    second_assoc_iou_thresh: float = 0.5
    prop_flag: bool = False
    down_factor: int = 8
    appearance_depth: int = 50  # ResNet depth of the appearance model
    # appearance-encoder zoo entry and layer surgery (reference model_type /
    # remove_layers, models/unitrack/model/model.py:89-147; see tracker/zoo.py)
    model_type: str = "imagenet50"
    remove_layers: Tuple[str, ...] = ("layer4",)


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
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    relation: RelationHeadConfig = field(default_factory=RelationHeadConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)


def mask2former_ips() -> PVSGConfig:
    """configs/mask2former/mask2former_r50_lsj_8x2_50e_coco-panoptic_custom.py:
    the per-frame (IPS) segmenter, R-50 with frozen BN."""
    return PVSGConfig(name="mask2former_ips")


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


def mask2former_swin(video: bool = True) -> PVSGConfig:
    """The Swin-T backbone variant of the segmenter, VPS (2-frame clips)
    or IPS."""
    return PVSGConfig(
        name="mask2former_swin_vps" if video else "mask2former_swin_ips",
        model=Mask2FormerConfig(
            video=video,
            num_frames=2 if video else 1,
            backbone=BackboneConfig(kind="swin", swin_variant="tiny"),
            pixel_decoder=PixelDecoderConfig(in_channels=(96, 192, 384, 768))))


def mask2former_swinl_vps() -> PVSGConfig:
    """Mask2Former's flagship, Swin-L (window 12) with the MSDA pixel
    decoder and 200 queries, as the VPS segmenter (2-frame clips):
    Mask2Former's configs/coco/panoptic-segmentation/swin/
    maskformer2_swin_large_IN21k_384_bs16_100ep.yaml on PVSG's classes."""
    return PVSGConfig(
        name="mask2former_swinl_vps",
        model=Mask2FormerConfig(
            video=True, num_frames=2, num_queries=200,
            backbone=BackboneConfig(kind="swin", swin_variant="large"),
            pixel_decoder=PixelDecoderConfig(in_channels=(192, 384, 768, 1536),
                                             encoder="msda")))


PRESETS = {
    "mask2former_ips": mask2former_ips,
    "mask2former_vps": mask2former_vps,
    "mask2former_swin_ips": lambda: mask2former_swin(False),
    "mask2former_swin_vps": lambda: mask2former_swin(True),
    "mask2former_swinl_vps": mask2former_swinl_vps,
    "relation_vanilla": lambda: relation_head("vanilla"),
    "relation_filter": lambda: relation_head("filter"),
    "relation_conv": lambda: relation_head("conv"),
    "relation_transformer": lambda: relation_head("transformer"),
    "relation_conv_interact": relation_conv_interact,
    "relation_conv_large": relation_conv_large,
}

def get_config(name: str) -> PVSGConfig:
    """A preset name, or the path of a ``config.json`` (``save_config``; the
    train CLI writes one into its work directory)."""
    if name.endswith(".json"):
        if not os.path.exists(name):
            raise FileNotFoundError(
                f"config file '{name}' does not exist (a .json --config is "
                f"always treated as a path, never a preset name)")
        return load_config_file(name)
    if name not in PRESETS:
        raise KeyError(f"unknown config preset '{name}'; have {sorted(PRESETS)}")
    return PRESETS[name]()


def config_to_dict(cfg: PVSGConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def _dataclass_from_dict(cls, d: Dict[str, Any]):
    defaults = cls()
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        cur = getattr(defaults, f.name)
        if isinstance(v, dict) and dataclasses.is_dataclass(cur):
            kwargs[f.name] = _dataclass_from_dict(type(cur), v)
        elif isinstance(v, list):
            # json has no tuples; every sequence field here is a tuple
            kwargs[f.name] = tuple(tuple(e) if isinstance(e, list) else e
                                   for e in v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def save_config(cfg: PVSGConfig, path: str) -> None:
    """Write ``cfg`` as JSON in the JAX package's schema."""
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=1)


def load_config_file(path: str) -> PVSGConfig:
    """Read a ``config.json`` written by ``save_config`` or by the JAX
    package's ``tools/train.py``: the two packages share the schema."""
    with open(path) as f:
        d = json.load(f)
    return _dataclass_from_dict(PVSGConfig, d)


def apply_overrides(cfg: Any, overrides: Dict[str, Any]) -> Any:
    """Apply dotted-path overrides (the --cfg-options equivalent)."""
    for key, value in overrides.items():
        cfg = _replace_path(cfg, key.split("."), value)
    return cfg


def _replace_path(obj: Any, parts: List[str], value: Any) -> Any:
    if len(parts) == 1:
        cur = getattr(obj, parts[0])
        if cur is not None and not isinstance(value, type(cur)):
            if isinstance(cur, bool):
                value = str(value).lower() in ("1", "true", "yes")
            elif isinstance(cur, (int, float)):
                value = type(cur)(value)
            elif isinstance(cur, tuple):
                value = tuple(type(cur[0])(v)
                              for v in str(value).strip("()[] ").split(","))
        return dataclasses.replace(obj, **{parts[0]: value})
    child = getattr(obj, parts[0])
    return dataclasses.replace(obj, **{parts[0]: _replace_path(child, parts[1:], value)})


def parse_set_args(pairs: Sequence[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        out[k] = v
    return out


ASSIGNERS = ("hungarian", "lapjv", "greedy")


def resolve_assigner(cfg: Mask2FormerConfig) -> str:
    """'auto' is the host Hungarian on every device of the port: the LAP
    runs on the host after one copy of the cost tensor, on CPU and CUDA
    alike. (The JAX package resolves 'auto' to LAPJV off the CPU because
    host callbacks fail inside a TPU step; a CUDA step has no such
    limit.)"""
    return "hungarian" if cfg.assigner == "auto" else cfg.assigner


def check_assigner_capacity(cfg: Mask2FormerConfig, max_instances: int) -> None:
    """The JAX package's config-time checks of the assigner and the
    matching and loss layouts, with its messages
    (``openpvsg_tpu/train/segmenter.py:137-175``): LAPJV needs
    ``max_instances <= num_queries``; ``match_downsample`` >= 1 and, above
    1, dense sampling; ``loss_layout`` 'query' or 'target', and 'target'
    only dense; ``mask_logits_dtype`` 'float32' or 'bfloat16'. The port
    also refuses an assigner it does not know, which the JAX package would
    run as the host Hungarian."""
    if cfg.assigner not in ("auto",) + ASSIGNERS:
        raise ValueError(f"model.assigner must be one of "
                         f"{('auto',) + ASSIGNERS}, got {cfg.assigner!r}")
    if (resolve_assigner(cfg) == "lapjv"
            and max_instances > cfg.num_queries):
        raise ValueError(
            f"assigner='lapjv' (resolved from '{cfg.assigner}') requires "
            f"max_instances <= model.num_queries, got max_instances="
            f"{max_instances} > num_queries={cfg.num_queries}. Lower "
            f"--max-instances, raise model.num_queries, or use "
            f"model.assigner='hungarian' or 'greedy'.")
    if cfg.match_downsample < 1:
        raise ValueError(
            f"model.match_downsample must be >= 1, got {cfg.match_downsample}")
    if cfg.match_downsample != 1 and cfg.loss_sampling == "points":
        raise ValueError(
            "model.match_downsample > 1 requires loss_sampling='dense' "
            "(point-rend matching already subsamples; pooling on top of it "
            "would double-approximate). Set model.loss_sampling='dense' or "
            "model.match_downsample=1.")
    if cfg.loss_layout not in ("query", "target"):
        raise ValueError(
            f"model.loss_layout must be 'query' or 'target', got "
            f"{cfg.loss_layout!r}")
    if cfg.loss_layout == "target" and cfg.loss_sampling == "points":
        raise ValueError(
            "model.loss_layout='target' requires loss_sampling='dense' "
            "(point sampling needs the per-query layout). Set "
            "model.loss_sampling='dense' or model.loss_layout='query'.")
    if cfg.mask_logits_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"model.mask_logits_dtype must be 'float32' or 'bfloat16', "
            f"got {cfg.mask_logits_dtype!r}")


def check_training_config(cfg: Mask2FormerConfig) -> None:
    """Raise ValueError for a training value the port does not take.
    ``loss_sampling`` is 'dense' or 'points'; the assigner, layout and
    dtype checks are ``check_assigner_capacity``'s (LAPJV's capacity is
    checked against each batch, as the JAX trainer does); the backbone is
    'resnet' or 'swin'; its compute dtype ``backbone.dtype`` 'float32' or
    'bfloat16', in the words of the ``mask_logits_dtype`` check. (The JAX
    trainer would run any other value in float32.)"""
    if cfg.loss_sampling not in ("dense", "points"):
        raise ValueError(f"model.loss_sampling={cfg.loss_sampling!r}: "
                         "'dense' or 'points'")
    if cfg.backbone.kind not in ("resnet", "swin"):
        raise ValueError(f"model.backbone.kind={cfg.backbone.kind!r}: "
                         "'resnet' or 'swin'")
    check_assigner_capacity(cfg, 0)
    if cfg.backbone.dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"model.backbone.dtype must be 'float32' or 'bfloat16', "
            f"got {cfg.backbone.dtype!r}")
