"""Checkpoints of a ``SegmenterTrainer`` (the model's state dict with its BN
running statistics, the optimizer's state, the step count and the state of
its points generator) and of a
``RelationTrainer`` (the model's state dict, Adam's state, the gradient
accumulator and its count, and the subsampling ``random.Random`` state),
written with ``torch.save`` and read back with
``torch.load(weights_only=True)``.

The format is the port's own. A trainer resumed from a checkpoint takes the
same next step as one that was never interrupted, bit for bit on the CPU
when the step's operations are deterministic there: at one intra-op thread
(``torch.set_num_threads(1)``) or under
``torch.use_deterministic_algorithms(True)``. With more threads, torch's
CPU backward of advanced indexing (``index_put_`` with accumulate on
float32, at least 32768 elements) adds atomically in parallel, so two
identical steps can differ in the last bits when the host is loaded.

The reference's own checkpoints, mmdet 2.x ``.pth`` files of Mask2Former
(R-50, the MSDA pixel decoder), load through ``load_mmdet_checkpoint`` and
``convert_mmdet_mask2former``, the port of
``openpvsg_tpu/train/checkpoint.py:87-254``, into the port's state dict for
a config with ``pixel_decoder.encoder='msda'``. An mmdet Swin backbone
state dict converts with ``convert_mmdet_swin`` into the port's
``SwinTransformer`` names. Loading the JAX package's msgpack checkpoints is
not ported (ROADMAP.md A9).
"""
from __future__ import annotations

import os
import pickle
import re
import warnings
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def save_checkpoint(path: str, trainer) -> None:
    """Write the trainer's state to ``path`` (through a temporary file, so a
    crash never leaves a half-written checkpoint)."""
    tmp = f"{path}.tmp"
    torch.save({"model": trainer.model.state_dict(),
                "optimizer": trainer.optimizer.state_dict(),
                "step": trainer.step_count,
                "generator": trainer.generator.get_state()}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, trainer) -> int:
    """Restore a trainer built with the same configuration from ``path``;
    returns the restored step count. A checkpoint written before the
    generator was saved leaves the trainer's generator as it is."""
    state = torch.load(path, map_location=trainer.device, weights_only=True)
    trainer.model.load_state_dict(state["model"], strict=True)
    trainer.optimizer.load_state_dict(state["optimizer"])
    trainer.step_count = int(state["step"])
    if "generator" in state:
        trainer.generator.set_state(state["generator"].cpu())
    return trainer.step_count


def save_relation_checkpoint(path: str, trainer) -> None:
    """Write a ``RelationTrainer``'s state to ``path`` (through a temporary
    file)."""
    tmp = f"{path}.tmp"
    torch.save({"model": trainer.model.state_dict(),
                "optimizer": trainer.optimizer.state_dict(),
                "accum": trainer._accum,
                "accum_count": trainer._accum_count,
                "rng": trainer.rng.getstate()}, tmp)
    os.replace(tmp, path)


def load_relation_checkpoint(path: str, trainer) -> None:
    """Restore a ``RelationTrainer`` built with the same configuration."""
    state = torch.load(path, map_location=trainer.device, weights_only=True)
    trainer.model.load_state_dict(state["model"], strict=True)
    trainer.optimizer.load_state_dict(state["optimizer"])
    trainer._accum = state["accum"]
    trainer._accum_count = int(state["accum_count"])
    version, internal, gauss = state["rng"]
    trainer.rng.setstate((version, tuple(internal), gauss))


def load_model_state(path: str):
    """The model's state dict (float32, with the BN running statistics) of
    a ``SegmenterTrainer`` checkpoint, on the CPU: what ``SegmenterInference``
    takes (it folds the BN)."""
    return torch.load(path, map_location="cpu", weights_only=True)["model"]


# ---------------------------------------------------------------------------
# mmdet Mask2Former checkpoints
# ---------------------------------------------------------------------------

def load_mmdet_checkpoint(path: str, trusted: bool = False) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of an mmdet ``.pth`` file (or the file's dict when
    it has none), on the CPU. Read with ``weights_only=True`` (mmdet 2.25's
    ``meta`` holds plain types). A file that needs other classes raises
    ``pickle.UnpicklingError``, unless ``trusted=True``: then it is read
    again as a full pickle, with a warning, since a full unpickle can run
    code of the file's making."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if not trusted:
            raise pickle.UnpicklingError(
                f"{path}: not loadable with weights_only=True ({e}); pass "
                "trusted=True to read it as a full pickle, only for a file "
                "whose origin you trust") from e
        warnings.warn(f"{path}: not loadable with weights_only=True ({e}); "
                      "reading it as a full pickle (trusted=True)")
        obj = torch.load(path, map_location="cpu", weights_only=False)
    return obj.get("state_dict", obj) if isinstance(obj, dict) else obj


_PD = "panoptic_head.pixel_decoder"
_TD = "panoptic_head.transformer_decoder"
# the port's key (a regex over it) -> the mmdet key; mmdet's torch layouts
# (OIHW convs, (out, in) linears) are the port's, so only names change
_MMDET_NAMES = [
    (r"backbone\.(layer\d+)_(\d+)\.downsample_conv\.", r"backbone.\1.\2.downsample.0."),
    (r"backbone\.(layer\d+)_(\d+)\.downsample_bn\.bn\.", r"backbone.\1.\2.downsample.1."),
    (r"backbone\.(layer\d+)_(\d+)\.(bn\d)\.bn\.", r"backbone.\1.\2.\3."),
    (r"backbone\.(layer\d+)_(\d+)\.", r"backbone.\1.\2."),
    (r"backbone\.bn1\.bn\.", "backbone.bn1."),
    (r"pixel_decoder\.input_conv_(\d+)\.", _PD + r".input_convs.\1."),
    (r"pixel_decoder\.lateral_conv_(\d+)\.", _PD + r".lateral_convs.\1."),
    (r"pixel_decoder\.output_conv_(\d+)\.", _PD + r".output_convs.\1."),
    (r"pixel_decoder\.level_embed$", _PD + ".level_encoding.weight"),
    (r"pixel_decoder\.encoder_layer_(\d+)_attn\.", _PD + r".encoder.layers.\1.attentions.0."),
    (r"pixel_decoder\.encoder_layer_(\d+)_ffn\.fc1\.", _PD + r".encoder.layers.\1.ffns.0.layers.0.0."),
    (r"pixel_decoder\.encoder_layer_(\d+)_ffn\.fc2\.", _PD + r".encoder.layers.\1.ffns.0.layers.1."),
    (r"pixel_decoder\.encoder_layer_(\d+)_norm1\.", _PD + r".encoder.layers.\1.norms.0."),
    (r"pixel_decoder\.encoder_layer_(\d+)_norm2\.", _PD + r".encoder.layers.\1.norms.1."),
    (r"pixel_decoder\.mask_feature\.", _PD + ".mask_feature."),
    (r"head\.(query_embed|query_feat|level_embed)$", r"panoptic_head.\1.weight"),
    (r"head\.layer_(\d+)\.cross_attn\.out_proj\.", _TD + r".layers.\1.attentions.0.attn.out_proj."),
    (r"head\.layer_(\d+)\.self_attn\.out_proj\.", _TD + r".layers.\1.attentions.1.attn.out_proj."),
    (r"head\.layer_(\d+)\.ffn\.fc1\.", _TD + r".layers.\1.ffns.0.layers.0.0."),
    (r"head\.layer_(\d+)\.ffn\.fc2\.", _TD + r".layers.\1.ffns.0.layers.1."),
    (r"head\.layer_(\d+)\.norm1\.", _TD + r".layers.\1.norms.0."),
    (r"head\.layer_(\d+)\.norm2\.", _TD + r".layers.\1.norms.1."),
    (r"head\.layer_(\d+)\.norm3\.", _TD + r".layers.\1.norms.2."),
    (r"head\.decoder_norm\.", _TD + ".post_norm."),
    (r"head\.cls_embed\.", "panoptic_head.cls_embed."),
    (r"head\.mask_embed\.fc(\d)\.", r"panoptic_head.mask_embed.layers.\1."),
]
# q/k/v of torch's nn.MultiheadAttention are row blocks of in_proj_*
_MHA = re.compile(r"head\.layer_(\d+)\.(cross|self)_attn\.([qkv])_proj\.(weight|bias)$")


def _mmdet_source(key: str) -> Tuple[Tuple[str, ...], int]:
    """The mmdet key(s) that hold the port's ``key`` (alternatives in
    order) and, for a q/k/v projection, its row block (else -1)."""
    m = _MHA.match(key)
    if m:
        layer, kind, qkv, leaf = m.groups()
        attn = 0 if kind == "cross" else 1
        return ((f"{_TD}.layers.{layer}.attentions.{attn}.attn.in_proj_{leaf}",),
                "qkv".index(qkv))
    for pattern, repl in _MMDET_NAMES:
        new, n = re.subn(pattern, repl, key)
        if n:
            if key.startswith("head.mask_embed."):
                # mmdet's MLP is layers.{i} in some versions, {2i} in others
                j = int(re.search(r"fc(\d)", key).group(1))
                return (new, new.replace(f"mask_embed.layers.{j}.", f"mask_embed.{2 * j}.")), -1
            return (new,), -1
    return (key,), -1


def convert_mmdet_mask2former(sd: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """An mmdet Mask2Former(Custom/Video) state dict (tensors or arrays) ->
    the float32 state dict of ``openpvsg_torch.models.mask2former
    .Mask2Former(cfg)``, BN running statistics included (``cfg`` is a
    ``Mask2FormerConfig`` with ``pixel_decoder.encoder='msda'``). Raises
    ValueError naming the keys the port expects and the state dict lacks,
    the state dict's keys the port would not use (``num_batches_tracked``
    aside), and shapes that do not fit."""
    from openpvsg_torch.weights import expected_shapes

    out: Dict[str, torch.Tensor] = {}
    used, missing, bad = set(), [], []
    for key, shape in expected_shapes(cfg).items():
        sources, block = _mmdet_source(key)
        src = next((k for k in sources if k in sd), None)
        if src is None:
            missing.append(sources[0])
            continue
        used.add(src)
        arr = np.array(sd[src].detach().cpu().numpy() if hasattr(sd[src], "detach")
                       else sd[src], dtype=np.float32)
        if block >= 0:
            rows = arr.shape[0] // 3
            arr = arr[block * rows:(block + 1) * rows]
        if tuple(arr.shape) != shape:
            bad.append((src, tuple(arr.shape), shape))
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    unused = sorted(k for k in sd if k not in used
                    and not k.endswith("num_batches_tracked"))
    problems = []
    if missing:
        problems.append(f"{len(missing)} keys the port expects and the state "
                        f"dict lacks {missing[:8]}")
    if unused:
        problems.append(f"{len(unused)} keys the configured model does not "
                        f"use {unused[:8]}")
    if bad:
        problems.append(f"shape mismatches {bad[:8]}")
    if problems:
        raise ValueError("convert_mmdet_mask2former: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# mmdet Swin backbones
# ---------------------------------------------------------------------------

def _array(value) -> np.ndarray:
    return np.array(value.detach().cpu().numpy() if hasattr(value, "detach")
                    else value, dtype=np.float32)


def _unfold_to_dy_dx_c(arr: np.ndarray) -> np.ndarray:
    """A patch-merging tensor whose last axis (4C) is in mmdet's ``nn.Unfold``
    order (c, dy, dx) -> the same tensor in the port's (dy, dx, c) order."""
    *lead, four_c = arr.shape
    c = four_c // 4
    return (arr.reshape(*lead, c, 2, 2)
            .transpose(*range(len(lead)), len(lead) + 1, len(lead) + 2, len(lead))
            .reshape(*lead, four_c))


def convert_mmdet_swin(sd: Mapping, src: str = "backbone") -> Dict[str, torch.Tensor]:
    """An mmdet 2.x ``SwinTransformer`` state dict (keys under ``src``:
    ``patch_embed.projection``/``.norm``, ``stages.S.blocks.B.{norm1,
    attn.w_msa.{qkv,proj,relative_position_bias_table}, norm2,
    ffn.layers.0.0, ffn.layers.1}``, ``stages.S.downsample.{norm,
    reduction}``, ``norm0..3``; tensors or arrays) -> float32 weights of
    ``openpvsg_torch.models.swin.SwinTransformer`` in its names (the port of
    ``openpvsg_tpu/train/checkpoint.py:255-289``, which walks the same keys).

    mmdet's ``PatchMerging`` gathers each 2x2 patch with ``nn.Unfold``, so
    its ``norm`` (4C) and the input axis of its ``reduction`` are in
    (c, dy, dx) order, while the port (and the JAX package) concatenates in
    (dy, dx, c); both are reordered here. The JAX converter copies them as
    they are. Keys it does not walk (``relative_position_index``) are left
    out, as there."""
    out: Dict[str, torch.Tensor] = {}

    def put(key, value, merge_order=False):
        arr = _array(value)
        out[key] = torch.from_numpy(np.ascontiguousarray(
            _unfold_to_dy_dx_c(arr) if merge_order else arr))

    put("patch_embed.weight", sd[f"{src}.patch_embed.projection.weight"])
    put("patch_embed.bias", sd[f"{src}.patch_embed.projection.bias"])
    for leaf in ("weight", "bias"):
        put(f"patch_norm.{leaf}", sd[f"{src}.patch_embed.norm.{leaf}"])
    s = 0
    while f"{src}.stages.{s}.blocks.0.norm1.weight" in sd:
        b = 0
        while f"{src}.stages.{s}.blocks.{b}.norm1.weight" in sd:
            p, d = f"{src}.stages.{s}.blocks.{b}", f"stage{s}_block{b}"
            for leaf in ("weight", "bias"):
                put(f"{d}.norm1.{leaf}", sd[f"{p}.norm1.{leaf}"])
                put(f"{d}.norm2.{leaf}", sd[f"{p}.norm2.{leaf}"])
                put(f"{d}.attn.qkv.{leaf}", sd[f"{p}.attn.w_msa.qkv.{leaf}"])
                put(f"{d}.attn.proj.{leaf}", sd[f"{p}.attn.w_msa.proj.{leaf}"])
                put(f"{d}.mlp_fc1.{leaf}", sd[f"{p}.ffn.layers.0.0.{leaf}"])
                put(f"{d}.mlp_fc2.{leaf}", sd[f"{p}.ffn.layers.1.{leaf}"])
            put(f"{d}.attn.rel_bias_table",
                sd[f"{p}.attn.w_msa.relative_position_bias_table"])
            b += 1
        down = f"{src}.stages.{s}.downsample"
        if f"{down}.norm.weight" in sd:
            for leaf in ("weight", "bias"):
                put(f"downsample{s}.norm.{leaf}", sd[f"{down}.norm.{leaf}"], True)
            put(f"downsample{s}.reduction.weight", sd[f"{down}.reduction.weight"], True)
        s += 1
    for i in range(4):
        if f"{src}.norm{i}.weight" in sd:
            for leaf in ("weight", "bias"):
                put(f"out_norm{i}.{leaf}", sd[f"{src}.norm{i}.{leaf}"])
    return out
