"""Checkpoints of a ``SegmenterTrainer``: the model's state dict (BN running
statistics included), the optimizer's state and the step count, written with
``torch.save`` and read back with ``torch.load(weights_only=True)``.

The format is the port's own. A trainer resumed from a checkpoint takes the
same next step, bit for bit on the CPU, as one that was never interrupted.
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
