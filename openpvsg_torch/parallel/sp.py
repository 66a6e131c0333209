"""Frame-sharded inference and pair-sharded relation scoring, the port of
``openpvsg_tpu/parallel/sp.py:29-83``.

- ``ShardedFrameForward``: a batch of N frames is split into contiguous
  blocks over the mesh's 'data' axis; each replica runs the function on its
  block on its own device (frames are independent: no exchange at all),
  and the outputs are gathered onto the mesh's first device.
- ``ShardedPairPredict``: relation pair scoring with the pair axis split
  over 'data': the pair count is zero-padded to a multiple of the axis and
  the padding stripped from the outputs (the temporal heads score pairs
  independently, so zero rows are inert).

Both are persistent executors: the replicas' weights are copied once at
construction, and there is no module-level cache (one served stale
weights): new weights mean a new executor.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch

from openpvsg_torch.parallel.mesh import Mesh, replicate, shard_batch


def gather(outs, device: torch.device):
    """Concatenate the per-shard outputs (tensors, or tuples, lists or dicts
    of them) along dim 0 on ``device``."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: gather([o[k] for o in outs], device) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(gather([o[i] for o in outs], device)
                           for i in range(len(first)))
    return torch.cat([o.to(device) for o in outs])


def pad_frames_for_mesh(frames, n_data: int) -> Tuple[Any, int]:
    """Pad the frame axis (dim 0) to a multiple of ``n_data`` by repeating
    the last frame; returns (padded, original count). Takes a numpy array
    or a tensor and returns the same kind."""
    n = frames.shape[0]
    rem = (-n) % n_data
    if rem:
        if torch.is_tensor(frames):
            frames = torch.cat([frames, frames[-1:].expand(rem, *frames.shape[1:])])
        else:
            frames = np.concatenate([frames, np.repeat(frames[-1:], rem, axis=0)])
    return frames, n


class ShardedFrameForward:
    """Frame-sharded executor: ``fn(replica, x)`` runs on each block of the
    frame axis with the replica of ``module`` on that block's device, under
    ``torch.no_grad``; the outputs come back gathered on the mesh's first
    device."""

    def __init__(self, mesh: Mesh, fn: Callable, module: torch.nn.Module):
        self.mesh = mesh
        self.fn = fn
        self.replicas = replicate(module, mesh)

    @torch.no_grad()
    def __call__(self, frames):
        """frames: (N, ...) with N divisible by the 'data' axis size."""
        n_data = self.mesh.shape["data"]
        if frames.shape[0] % n_data:
            raise ValueError(f"frame count {frames.shape[0]} not divisible by "
                             f"the data axis {n_data}")
        shards = shard_batch(self.mesh, frames)
        outs = [self.fn(rep, x) for rep, x in zip(self.replicas, shards)]
        return gather(outs, self.mesh.first)


class ShardedPairPredict(ShardedFrameForward):
    """Relation pair scoring with the pair axis split over 'data'."""

    def __call__(self, pair_feats):
        """pair_feats: (P, T, 2D) -> (span (P, T, R), prob (P, R))."""
        n_data = self.mesh.shape["data"]
        p = pair_feats.shape[0]
        rem = (-p) % n_data
        if rem:
            pair_feats = np.concatenate(
                [np.asarray(pair_feats),
                 np.zeros((rem, *pair_feats.shape[1:]), np.asarray(pair_feats).dtype)])
        span, prob = super().__call__(pair_feats)
        return span[:p], prob[:p]
