"""Relation-head training (stage 4), the port of
``openpvsg_tpu/train/relation.py`` (reference: tools/rel_train.py:102-241).

One video per ``step``: tube and frame-window subsampling
(``subsample_video``), padding to bucket shapes (``build_batch``), the loss
(pair zlpr + 5 x reweighted BCE + span zlpr over rows with a GT span) and its
gradients, summed over ``step`` calls; every ``accumulation_steps`` videos
``flush`` divides the sum by the count and applies Adam (lr 1e-4, b1 0.9,
b2 0.999, eps 1e-8): the reference's loss/32 + backward + step.

The bucket shapes are the JAX package's. The trainer here compiles nothing
per shape, but the validity masks make the padding exact and keep this a
line-by-line reading of the reference; both packages draw the same
``random.Random`` numbers in the same order, so one seed gives the same
batches in both.

``DataParallelRelationTrainer`` spreads the accumulation over the 'data'
axis of a mesh (``openpvsg_tpu/train/relation.py:218-260,320-405``): one
replica per device, and same-bucket videos queue until there is one per
replica.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from openpvsg_torch.config import RelationHeadConfig
from openpvsg_torch.infer.segmenter import resolve_device
from openpvsg_torch.models.relation.heads import RelationModel
from openpvsg_torch.models.relation.losses import zlpr_loss
from openpvsg_torch.models.relation.utils import generate_gt_matrix, get_gt_pairs
from openpvsg_torch.train.segmenter import ieee_float32
from openpvsg_torch.weights import random_relation_state_dict


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


TUBE_BUCKETS = (20, 50, 100)
FRAME_BUCKETS = (128, 256, 512, 900)
PAIR_BUCKETS = (10, 25, 50)


@dataclasses.dataclass
class RelationBatch:
    """One padded video (shapes from the buckets)."""
    feats: np.ndarray        # (N, T, D)
    tube_valid: np.ndarray   # (N,)
    frame_valid: np.ndarray  # (T,)
    pair_feats: np.ndarray   # (P, 2) pair indices, gathered on the device
    pair_valid: np.ndarray   # (P,)
    gt_matrix: np.ndarray    # (N, N)
    gt_span: np.ndarray      # (P, T, R)
    gt_prob: np.ndarray      # (P, R)


def subsample_video(feats: np.ndarray, gt_relations: List[Dict],
                    cfg: RelationHeadConfig, rng: random.Random):
    """Tube (<= max_tubes, GT tubes first) and frame-window (<= max_frames)
    subsampling (reference: rel_train.py:106-160)."""
    n = feats.shape[0]
    if n > cfg.max_tubes:
        unique = set()
        for rel in gt_relations:
            unique.add(int(rel["subject_index"]))
            unique.add(int(rel["object_index"]))
        if len(unique) > cfg.max_tubes:
            unique = set(rng.sample(sorted(unique), cfg.max_tubes))
        remaining = sorted(set(range(n)) - unique)
        extra = rng.sample(remaining, min(cfg.max_tubes - len(unique), len(remaining)))
        selected = list(unique) + extra
        feats = feats[selected]
        index_map = {old: new for new, old in enumerate(selected)}
        gt_relations = [
            {**rel,
             "subject_index": index_map[int(rel["subject_index"])],
             "object_index": index_map[int(rel["object_index"])]}
            for rel in gt_relations
            if int(rel["subject_index"]) in index_map
            and int(rel["object_index"]) in index_map
        ]
    t = feats.shape[1]
    if t > cfg.max_frames:
        start = rng.randint(0, t - cfg.max_frames)
        custom_span = (start, start + cfg.max_frames)
    else:
        custom_span = (0, t)
    feats = feats[:, custom_span[0]:custom_span[1]]
    return feats, gt_relations, custom_span


def build_batch(feats: np.ndarray, gt_relations: List[Dict],
                custom_span: Tuple[int, int], cfg: RelationHeadConfig,
                rng: random.Random) -> Optional[RelationBatch]:
    """Pad one subsampled video to bucket shapes; None when it has no GT
    pair. ``pair_feats`` carries the pair indices: the features are
    gathered from the encoders' outputs inside the loss."""
    n, t, d = feats.shape
    # dynamic pair budget (reference: num_top_pairs = min(50, 10000 // T))
    num_top_pairs = min(cfg.num_top_pairs // 2, max(10000 // max(t, 1), 1))
    pairs = get_gt_pairs(gt_relations, num_top_pairs, rng)
    if not pairs:
        return None

    nb = _bucket(n, TUBE_BUCKETS)
    tb = _bucket(t, FRAME_BUCKETS)
    pb = _bucket(len(pairs), PAIR_BUCKETS)

    feats_p = np.zeros((nb, tb, d), dtype=np.float32)
    feats_p[:n, :t] = feats
    tube_valid = np.zeros(nb, dtype=bool)
    tube_valid[:n] = True
    frame_valid = np.zeros(tb, dtype=bool)
    frame_valid[:t] = True

    gt_matrix = np.zeros((nb, nb), dtype=np.float32)
    for rel in gt_relations:
        gt_matrix[int(rel["subject_index"]), int(rel["object_index"])] = 1.0

    gt_span_full, gt_prob_full = generate_gt_matrix(
        gt_relations, pairs, (len(pairs), t, cfg.num_relations), custom_span)
    gt_span = np.zeros((pb, tb, cfg.num_relations), dtype=np.float32)
    gt_span[:len(pairs), :t] = gt_span_full
    gt_prob = np.zeros((pb, cfg.num_relations), dtype=np.float32)
    gt_prob[:len(pairs)] = gt_prob_full

    pair_idx = np.zeros((pb, 2), dtype=np.int32)
    pair_idx[:len(pairs)] = np.asarray(pairs, dtype=np.int32)
    pair_valid = np.zeros(pb, dtype=bool)
    pair_valid[:len(pairs)] = True

    return RelationBatch(
        feats=feats_p, tube_valid=tube_valid, frame_valid=frame_valid,
        pair_feats=pair_idx, pair_valid=pair_valid, gt_matrix=gt_matrix,
        gt_span=gt_span, gt_prob=gt_prob)


def device_batch(b: RelationBatch, device) -> Dict[str, torch.Tensor]:
    """A ``RelationBatch`` as tensors on ``device``, under the JAX loss's
    names."""
    def dev(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)

    return {"feats": dev(b.feats, torch.float32),
            "tube_valid": dev(b.tube_valid, torch.bool),
            "frame_valid": dev(b.frame_valid, torch.bool),
            "pair_idx": dev(b.pair_feats, torch.int64),
            "pair_valid": dev(b.pair_valid, torch.bool),
            "gt_matrix": dev(b.gt_matrix, torch.float32),
            "gt_span": dev(b.gt_span, torch.float32),
            "gt_prob": dev(b.gt_prob, torch.float32)}


def relation_loss(model: RelationModel, batch: Dict[str, torch.Tensor],
                  counts: torch.Tensor, loss_prob_weight: float = 5.0):
    """The loss of ``make_loss_fn`` (``openpvsg_tpu/train/relation.py:141``)
    on one padded video -> (loss, {loss_pair, loss_prob, loss_span}). The
    validity masks keep padded tubes and frames out of every attention,
    pooling and loss term."""
    out = model(batch["feats"], tube_valid=batch["tube_valid"],
                frame_valid=batch["frame_valid"])
    sub, obj = out["sub_feats"], out["obj_feats"]
    pred_matrix = out["pred_matrix"]

    # pair zlpr over the flattened matrix; invalid pairs act as absent
    tube_valid = batch["tube_valid"]
    pair_mask2d = tube_valid[:, None] & tube_valid[None, :]
    pm = pred_matrix.masked_fill(~pair_mask2d, -9999.0)
    gm = batch["gt_matrix"]
    loss_pair = zlpr_loss(gm.reshape(1, -1), pm.reshape(1, -1))

    pidx = batch["pair_idx"]
    pair_feats = torch.cat([sub[pidx[:, 0]], obj[pidx[:, 1]]], dim=-1)
    span_pred, prob = model.predict(pair_feats, batch["frame_valid"])

    # reweighted BCE, masked mean over the valid pairs
    pv = batch["pair_valid"].float()
    gt_prob = batch["gt_prob"]
    pos_weight = counts.sum() / counts
    bce = -(pos_weight * gt_prob * F.logsigmoid(prob)
            + (1 - gt_prob) * F.logsigmoid(-prob))
    loss_prob = (bce.mean(dim=-1) * pv).sum() / torch.clamp(pv.sum(), min=1)

    # span zlpr over the (pair, relation) rows with a GT span, padded
    # frames forced inert
    gt_rows = batch["gt_span"].transpose(1, 2)       # (P, R, T)
    pred_rows = span_pred.transpose(1, 2)
    row_mask = (gt_rows != 0).any(dim=-1) & batch["pair_valid"][:, None]
    fv = batch["frame_valid"]
    yp = pred_rows.masked_fill(~fv[None, None, :], -9999.0)
    yt = gt_rows
    ypn = (1 - 2 * yt) * yp - yt * 9999.0
    ypp = (1 - 2 * yt) * yp - (1 - yt) * 9999.0
    zeros = torch.zeros_like(yp[..., :1])
    neg = torch.logsumexp(torch.cat([ypn, zeros], dim=-1), dim=-1)
    pos = torch.logsumexp(torch.cat([ypp, zeros], dim=-1), dim=-1)
    row_loss = neg + pos
    loss_span = (row_loss * row_mask).sum() / torch.clamp(row_mask.sum(), min=1)

    loss = loss_pair + loss_prob_weight * loss_prob + loss_span
    return loss, {"loss_pair": loss_pair, "loss_prob": loss_prob,
                  "loss_span": loss_span}


class RelationTrainer:
    """Adam and gradient accumulation over videos (reference:
    rel_train.py:62, 205-215: accumulation_steps 32, lr 1e-4).

    ``device=None`` means the GPU and raises without one; pass
    ``device="cpu"`` to train on the CPU. Each step's forward and backward
    run in IEEE float32 with TF32 off, whatever the caller set.
    ``state_dict`` defaults to ``random_relation_state_dict(cfg, rng_seed)``;
    ``rng_seed`` also seeds the ``random.Random`` of the subsampling."""

    def __init__(self, cfg: RelationHeadConfig, relation_count: np.ndarray,
                 rng_seed: int = 0, device=None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = RelationModel.from_config(cfg)
        model.load_state_dict(random_relation_state_dict(cfg, rng_seed)
                              if state_dict is None else state_dict, strict=True)
        self.model = model.to(self.device)
        self.params = list(self.model.parameters())
        self.rng = random.Random(rng_seed)
        self.optimizer = torch.optim.Adam(self.params, lr=cfg.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.counts = torch.as_tensor(np.asarray(relation_count, np.float32),
                                      device=self.device)
        self._accum: Optional[List[torch.Tensor]] = None
        self._accum_count = 0

    def loss_and_grads(self, batch: RelationBatch):
        """(loss, aux, grads) of one padded video as device tensors; the
        gradients of every parameter (zeros where the loss does not reach
        one), computed with TF32 off."""
        with ieee_float32():
            loss, aux = relation_loss(self.model, device_batch(batch, self.device),
                                      self.counts, self.cfg.loss_prob_weight)
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        return loss, aux, grads

    def step(self, feats: np.ndarray, gt_relations: List[Dict]):
        """Accumulate the gradients of one video; applies Adam every
        ``accumulation_steps`` videos. Returns (loss, aux) as floats, or
        None when the video has no GT pair."""
        feats, gt_relations, custom_span = subsample_video(
            feats, gt_relations, self.cfg, self.rng)
        batch = build_batch(feats, gt_relations, custom_span, self.cfg, self.rng)
        if batch is None:
            return None
        loss, aux, grads = self.loss_and_grads(batch)
        self.accumulate(grads, 1)
        if self._accum_count >= self.cfg.accumulation_steps:
            self.flush()
        values = torch.stack([loss.detach(), *(v.detach() for v in aux.values())]).cpu()
        return float(values[0]), dict(zip(aux, values[1:].tolist()))

    def accumulate(self, grads: List[torch.Tensor], count: int) -> None:
        """Add the gradients of ``count`` videos to the running sum."""
        if self._accum is None:
            self._accum = grads
        else:
            torch._foreach_add_(self._accum, grads)
        self._accum_count += count

    def flush(self):
        """Apply Adam to the mean of the accumulated gradients."""
        if self._accum is None or self._accum_count == 0:
            return
        for p, g in zip(self.params, self._accum):
            p.grad = g / self._accum_count
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self._accum = None
        self._accum_count = 0


class DataParallelRelationTrainer(RelationTrainer):
    """Relation training with the gradient accumulation spread over the
    'data' axis of a ``Mesh`` (``openpvsg_tpu/train/relation.py:320``).

    Videos are bucketed as in ``RelationTrainer``; same-bucket videos queue
    until there is one per replica, then each replica computes the loss and
    gradients of its video on its device, and the gradients are summed onto
    the first device (JAX's psum over 'data'). A partial queue is padded
    with copies of its first video at weight 0. Summing, not averaging,
    keeps the sequential trainer's accumulate-then-divide: Adam applies the
    sum divided by the video count every ``accumulation_steps`` videos
    (the count is checked after each queue runs) and at ``flush``, which
    drains the partial queues first. The replicas take the new weights after
    each apply. The model and optimizer live on the mesh's first device.
    """

    def __init__(self, cfg: RelationHeadConfig, relation_count: np.ndarray,
                 mesh, rng_seed: int = 0,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None):
        from openpvsg_torch.parallel.mesh import replicate

        super().__init__(cfg, relation_count, rng_seed, device=mesh.first,
                         state_dict=state_dict)
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.replicas = replicate(self.model, mesh)
        self._replica_params = [list(m.parameters()) for m in self.replicas]
        self._counts = [self.counts.to(next(m.parameters()).device)
                        for m in self.replicas]
        self._queues: Dict[tuple, List[RelationBatch]] = {}

    def step(self, feats: np.ndarray, gt_relations: List[Dict]):
        """Queue one video; runs the replicas when its bucket's queue is
        full. Returns (mean loss, mean aux) of the queue that ran, else None."""
        feats, gt_relations, custom_span = subsample_video(
            feats, gt_relations, self.cfg, self.rng)
        batch = build_batch(feats, gt_relations, custom_span, self.cfg, self.rng)
        if batch is None:
            return None
        key = (batch.feats.shape, batch.pair_feats.shape[0])
        self._queues.setdefault(key, []).append(batch)
        if len(self._queues[key]) < self.n_data:
            return None
        res = self._run_queue(key)
        if self._accum_count >= self.cfg.accumulation_steps:
            self._apply()
        return res

    def _run_queue(self, key) -> Tuple[float, Dict[str, float]]:
        batches = self._queues.pop(key)
        n_valid = len(batches)
        batches += [batches[0]] * (self.n_data - n_valid)
        first = self.mesh.first
        total, grads_sum = None, None
        with ieee_float32():
            for i, (model, b) in enumerate(zip(self.replicas, batches)):
                dev = self._counts[i].device
                weight = 1.0 if i < n_valid else 0.0
                loss, aux = relation_loss(model, device_batch(b, dev), self._counts[i],
                                          self.cfg.loss_prob_weight)
                terms = torch.stack([loss, *aux.values()]) * weight
                grads = torch.autograd.grad(terms[0], self._replica_params[i],
                                            allow_unused=True)
                grads = [torch.zeros_like(p, device=first) if g is None else g.to(first)
                         for p, g in zip(self._replica_params[i], grads)]
                terms = terms.detach().to(first)
                if grads_sum is None:
                    grads_sum, total = grads, terms
                else:
                    torch._foreach_add_(grads_sum, grads)
                    total = total + terms
        self.accumulate(grads_sum, n_valid)
        values = (total / n_valid).cpu()
        return float(values[0]), dict(zip(aux, values[1:].tolist()))

    def _apply(self) -> None:
        RelationTrainer.flush(self)
        with torch.no_grad():
            for params in self._replica_params[1:]:
                for p, src in zip(params, self.params):
                    p.copy_(src)

    def flush(self):
        """Drain every partial bucket queue, then apply the accumulated
        gradients (epoch boundary or end of training)."""
        for key in list(self._queues):
            if self._queues[key]:
                self._run_queue(key)
        self._apply()
