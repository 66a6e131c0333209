"""Time-axis (sequence) parallelism for the relation head, the port of
``openpvsg_tpu/parallel/tp.py:33-154``.

The frame axis is split over the mesh's 'time' axis and the pair axis over
'data': the device at (d, j) holds only frames [j * S, (j + 1) * S) of data
block d's pairs, S = T_pad / n_time, with T padded to a multiple of n_time
(the padding is masked out through ``frame_valid``). The JAX executor
annotates shardings and XLA inserts the collectives; here each cross-frame
step is explicit:

- the object encoders attend across tubes separately for each frame: each
  time shard runs on its own, with no exchange;
- the pair proposal's and the relation heads' max over T: a max per shard,
  then the max of the shards' maxima (exact);
- the temporal transformer: each shard projects its keys and values, the
  shards' K/V are gathered on every device of the row, and each shard's
  queries attend over all frames; ``sine_embed_1d`` is taken at the global
  frame positions;
- the handcrafted filter and the learned 1-D convolutions (a k-tap window
  over T): each shard takes a halo of k // 2 frames from its neighbours,
  with zeros beyond the sequence, as the convolution's own zero padding.

The per-frame arithmetic is the heads' own (``_PredHeads.per_frame``,
``TorchEncoderLayer.finish``, ``HandcraftedFilter.smooth``,
``Learnable1DConv.conv_layer``, ``TemporalTransformer.add_positions``);
this module holds only the cross-shard steps. The executors run under
``torch.no_grad`` with TF32 off (IEEE float32). The module holds one
replica of the relation model per device of the mesh, copied once.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from openpvsg_torch.models.relation.heads import (HandcraftedFilter, Learnable1DConv,
                                                  TemporalTransformer, VanillaModel,
                                                  masked_frame_max, pair_interaction_feats)
from openpvsg_torch.parallel.mesh import Mesh, replicate
from openpvsg_torch.train.segmenter import ieee_float32


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _tensor(x) -> torch.Tensor:
    """A float32 tensor of ``x`` (host array or tensor, on its device)."""
    return (x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))).float()


def _pad_dims(x: torch.Tensor, sizes) -> torch.Tensor:
    """Zero-pad the leading dims of ``x`` up to ``sizes``."""
    pad = []
    for have, want in zip(reversed(x.shape[:len(sizes)]), reversed(sizes)):
        pad += [0, want - have]
    return F.pad(x, [0, 0] * (x.dim() - len(sizes)) + pad) if any(pad) else x


class TimeShards:
    """A (N, T_pad, D) activation split along dim 1: ``parts[j]`` holds
    frames [j * size, (j + 1) * size) on time device j; ``length`` frames
    are the input's."""

    def __init__(self, parts: List[torch.Tensor], length: int):
        self.parts = parts
        self.length = length
        self.size = parts[0].shape[1]

    def full(self) -> torch.Tensor:
        """The (N, length, D) tensor, gathered on the first shard's device."""
        device = self.parts[0].device
        return torch.cat([p.to(device) for p in self.parts], dim=1)[:, :self.length]


def _frame_window(parts: List[torch.Tensor], start: int, stop: int,
                 device: torch.device) -> torch.Tensor:
    """Frames [start, stop) of a tensor split along dim 1 into equal
    ``parts``, on ``device``, with zeros outside the sequence."""
    size = parts[0].shape[1]
    total = size * len(parts)
    shape = list(parts[0].shape)
    pieces = []
    if start < 0:
        shape[1] = -start
        pieces.append(torch.zeros(shape, dtype=parts[0].dtype, device=device))
    lo = max(start, 0)
    while lo < min(stop, total):
        j = lo // size
        a, b = lo - j * size, min(stop - j * size, size)
        pieces.append(parts[j][:, a:b].to(device))
        lo = j * size + b
    if stop > total:
        shape[1] = stop - max(total, start)
        pieces.append(torch.zeros(shape, dtype=parts[0].dtype, device=device))
    return torch.cat(pieces, dim=1)


class TimeShardedRelation:
    """Persistent executor for a ``RelationModel`` over a (data, time) mesh:
    tube features enter (N, T, D) on the host, T is split over 'time' and
    pairs over 'data'; results are gathered on the mesh's first device."""

    def __init__(self, mesh: Mesh, model: torch.nn.Module):
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.n_time = mesh.shape["time"]
        flat = replicate(model.eval(), mesh, axis=None)
        self.replicas = [flat[d * self.n_time:(d + 1) * self.n_time]
                         for d in range(self.n_data)]
        self.model = flat[0]

    def _each_device(self, t: torch.Tensor):
        """A small tensor ``t`` copied once to each distinct device of the
        mesh (a copy from the host waits for the device: one per call and
        device, not one per use)."""
        return {d: t.to(d) for d in set(self.mesh.axis_devices(None))}

    def _frame_valid(self, frame_valid, t: int, t_pad: int) -> torch.Tensor:
        """The caller's frame validity (all True by default) over t frames,
        extended with False for the shard-multiple padding."""
        out = torch.zeros(t_pad, dtype=torch.bool)
        out[:t] = (True if frame_valid is None else torch.as_tensor(
            frame_valid if torch.is_tensor(frame_valid) else np.asarray(frame_valid, bool)
        ).cpu())
        return out

    # ------------------------------------------------------------------
    @torch.no_grad()
    def propose(self, feats, tube_valid=None, frame_valid=None):
        """feats (N, T, D), a host array or a tensor -> {'sub_feats',
        'obj_feats': ``TimeShards`` of the encoders' outputs on the first
        data row's devices, 'pred_matrix' (N, N) on the first device}."""
        feats = _tensor(feats)
        n, t, _ = feats.shape
        t_pad = _pad_to(t, self.n_time)
        size = t_pad // self.n_time
        padded = _pad_dims(feats, (n, t_pad))
        tv = (torch.ones(n, dtype=torch.bool) if tube_valid is None
              else torch.as_tensor(np.asarray(tube_valid, bool)))
        fv = self._each_device(self._frame_valid(frame_valid, t, t_pad))
        tv = self._each_device(tv)
        first = self.mesh.first
        subs, objs, sub_max, obj_max = [], [], [], []
        with ieee_float32():
            for j, model in enumerate(self.replicas[0]):
                dev = self.mesh.devices[0][j]
                s, o = model.encode(padded[:, j * size:(j + 1) * size].to(dev), tv[dev])
                keep = fv[dev][j * size:(j + 1) * size]
                subs.append(s)
                objs.append(o)
                sub_max.append(masked_frame_max(s, keep).to(first))
                obj_max.append(masked_frame_max(o, keep).to(first))
            pred_matrix = self.model.pair_proposal.score(
                torch.stack(sub_max).amax(dim=0), torch.stack(obj_max).amax(dim=0))
        return {"sub_feats": TimeShards(subs, t), "obj_feats": TimeShards(objs, t),
                "pred_matrix": pred_matrix}

    @torch.no_grad()
    def predict_pairs(self, out, idx: np.ndarray, frame_valid=None):
        """Pair gather on the devices, then predict over the mesh.

        out: ``propose``'s dict; idx (P, 2) subject / object tube indices
        (padding rows may point at tube 0: every temporal head scores pairs
        independently). Each time shard gathers its frames of the pairs
        where the encoders left them, zeroes invalid frames (so the tensor
        equals the host-built one of ``predict``) and sends each data block
        to its device. Returns (span > 0 (P, T, R) bool, prob (P, R)) as
        numpy arrays."""
        sub, obj = out["sub_feats"], out["obj_feats"]
        t, size = sub.length, sub.size
        p = len(idx)
        p_pad = _pad_to(p, self.n_data)
        rows = np.zeros((p_pad, 2), np.int64)
        rows[:p] = np.asarray(idx, np.int64)
        fv = self._frame_valid(frame_valid, t, size * self.n_time)
        fvd, rows = self._each_device(fv), self._each_device(torch.from_numpy(rows))
        block = p_pad // self.n_data
        grid = [[None] * self.n_time for _ in range(self.n_data)]
        for j in range(self.n_time):
            src = sub.parts[j].device
            r = rows[src]
            pair = torch.cat([sub.parts[j].index_select(0, r[:, 0]),
                              obj.parts[j].index_select(0, r[:, 1])], dim=-1)
            pair = pair * fvd[src][j * size:(j + 1) * size][None, :, None]
            for d in range(self.n_data):
                grid[d][j] = pair[d * block:(d + 1) * block].to(self.mesh.devices[d][j])
        span, prob = self._predict_grid(grid, fv, t)
        return ((span[:p, :t] > 0).cpu().numpy(), prob[:p].cpu().numpy())

    @torch.no_grad()
    def predict(self, pair_feats, frame_valid=None):
        """pair_feats (P, T, 2D), a host array or a tensor -> (span (P, T, R),
        prob (P, R)) on the first device; pairs split over 'data', frames
        over 'time'."""
        x = _tensor(pair_feats)
        p, t = x.shape[:2]
        p_pad, t_pad = _pad_to(p, self.n_data), _pad_to(t, self.n_time)
        padded = _pad_dims(x, (p_pad, t_pad))
        block, size = p_pad // self.n_data, t_pad // self.n_time
        grid = [[padded[d * block:(d + 1) * block, j * size:(j + 1) * size].to(dev)
                 for j, dev in enumerate(row)] for d, row in enumerate(self.mesh.devices)]
        span, prob = self._predict_grid(grid, self._frame_valid(frame_valid, t, t_pad), t)
        return span[:p, :t], prob[:p]

    # ------------------------------------------------------------------
    def _predict_grid(self, grid, fv: torch.Tensor, length: int):
        """The temporal head on grid[d][j] (pairs of block d, frames of
        shard j) -> (span (P_pad, T_pad, R), prob (P_pad, R)) on the first
        device. ``length``: the input's frame count; the convolutions see
        zeros beyond it, as their own padding."""
        first = self.mesh.first
        fv = self._each_device(fv)
        spans, probs = [], []
        with ieee_float32():
            for d in range(self.n_data):
                models = self.replicas[d]
                xs = grid[d]
                if models[0].pair_interaction:
                    xs = [pair_interaction_feats(x) for x in xs]
                fvs = [fv[x.device][j * x.shape[1]:(j + 1) * x.shape[1]]
                       for j, x in enumerate(xs)]
                xs = self._temporal(models, xs, fv, length)
                span_row, prob_row = [], []
                for m, x, keep in zip(models, xs, fvs):
                    span, pred = m.temporal.heads.per_frame(x)
                    span_row.append(span.to(first))
                    prob_row.append(masked_frame_max(pred, keep).to(first))
                spans.append(torch.cat(span_row, dim=1))
                probs.append(torch.stack(prob_row).amax(dim=0))
        return torch.cat(spans), torch.cat(probs)

    def _temporal(self, models, xs: List[torch.Tensor], fv, length: int
                  ) -> List[torch.Tensor]:
        """The temporal model's body (everything before ``_PredHeads``) on one
        data row's time shards; ``fv`` is the frame validity on each
        device."""
        head = models[0].temporal
        size = xs[0].shape[1]
        if isinstance(head, VanillaModel):
            return xs
        if isinstance(head, HandcraftedFilter):
            h = head.halo
            return [m.temporal.smooth(_frame_window(xs, j * size - h, (j + 1) * size + h,
                                                    x.device))
                    for j, (m, x) in enumerate(zip(models, xs))]
        if isinstance(head, Learnable1DConv):
            h = head.halo
            for layer in range(head.num_layers):
                out = []
                for j, (m, x) in enumerate(zip(models, xs)):
                    win = _frame_window(xs, j * size - h, (j + 1) * size + h, x.device)
                    y = m.temporal.conv_layer(layer, win)
                    # frames past the input are the next layer's zero padding
                    keep = min(max(length - j * size, 0), size)
                    if keep < size:
                        y = torch.cat([y[:, :keep], torch.zeros_like(y[:, keep:])], dim=1)
                    out.append(y)
                xs = out
            return xs
        if isinstance(head, TemporalTransformer):
            xs = [m.temporal.add_positions(x, j * size, size * len(xs))
                  for j, (m, x) in enumerate(zip(models, xs))]
            masks = [fv[x.device][None, None, :] for x in xs]
            for layer in range(head.num_layers):
                layers = [getattr(m.temporal, f"layer_{layer}") for m in models]
                xs = _attention_layer(layers, xs, masks)
            return [m.temporal.final_norm(x) for m, x in zip(models, xs)]
        raise TypeError(f"no time-sharded form of {type(head).__name__}")


def _attention_layer(layers, xs: List[torch.Tensor], masks) -> List[torch.Tensor]:
    """One post-norm ``TorchEncoderLayer`` over time shards: each shard
    projects its keys and values, the shards' K/V are gathered on each
    shard's device, and its queries attend over every frame."""
    kv = [(layer.self_attn.k_proj(x), layer.self_attn.v_proj(x))
          for layer, x in zip(layers, xs)]
    out = []
    for layer, x, mask in zip(layers, xs, masks):
        k = torch.cat([a.to(x.device) for a, _ in kv], dim=1)
        v = torch.cat([b.to(x.device) for _, b in kv], dim=1)
        a = layer.self_attn.attend(layer.self_attn.q_proj(x), k, v, mask=mask)
        out.append(layer.finish(x, a))
    return out
