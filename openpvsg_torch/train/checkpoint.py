"""Checkpoints of a ``SegmenterTrainer`` (the model's state dict with its BN
running statistics, the optimizer's state and the step count) and of a
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
Loading the JAX package's msgpack or mmdet ``.pth`` checkpoints is not
ported (ROADMAP.md A9).
"""
from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, trainer) -> None:
    """Write the trainer's state to ``path`` (through a temporary file, so a
    crash never leaves a half-written checkpoint)."""
    tmp = f"{path}.tmp"
    torch.save({"model": trainer.model.state_dict(),
                "optimizer": trainer.optimizer.state_dict(),
                "step": trainer.step_count}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, trainer) -> int:
    """Restore a trainer built with the same configuration from ``path``;
    returns the restored step count."""
    state = torch.load(path, map_location=trainer.device, weights_only=True)
    trainer.model.load_state_dict(state["model"], strict=True)
    trainer.optimizer.load_state_dict(state["optimizer"])
    trainer.step_count = int(state["step"])
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
