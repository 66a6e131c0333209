"""Structured metrics logging, the port of ``openpvsg_tpu/utils/logging.py``.

Replaces the reference's TextLoggerHook/WandbLoggerHook pair (reference:
configs/mask2former_vps/mask2former_video_r50.py:70-80) with a dependency-
free JSONL metrics stream, mirrored to wandb only when it is importable.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    """JSONL metrics stream + pluggable experiment-tracker hooks.

    `add_hook(fn)` registers any callable `(row: dict, step: int|None)`,
    the generalization of the reference's LoggerHook list (TextLoggerHook +
    WandbLoggerHook). The wandb hook is pre-wired when requested and the
    package is importable; anything else (tensorboard, mlflow, a socket)
    plugs in the same way without new dependencies here.
    """

    def __init__(self, work_dir: str, use_wandb: bool = False,
                 wandb_kwargs: Optional[Dict] = None):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, "metrics.jsonl")
        self._hooks = []
        if use_wandb:
            try:
                import wandb

                wandb.init(**(wandb_kwargs or {}))
                self.add_hook(lambda row, step: wandb.log(row, step=step))
            except Exception:
                pass  # wandb not installed / offline: JSONL only

    def add_hook(self, fn) -> None:
        """fn(row: dict, step: Optional[int]) called after every log()."""
        self._hooks.append(fn)

    def log(self, metrics: Dict, step: Optional[int] = None):
        row = {"time": time.time(), **({"step": step} if step is not None else {}),
               **{k: float(v) for k, v in metrics.items()
                  if isinstance(v, (int, float)) or hasattr(v, "item")}}
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        for fn in self._hooks:
            fn(row, step)
