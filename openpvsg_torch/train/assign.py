"""Target assignment for Mask2Former training: the port of
``openpvsg_tpu/train/assign.py``.

  cost = 2.0 * classification cost (-softmax prob at the gt label)
       + 5.0 * sigmoid-BCE mask cost over P points
       + 5.0 * dice cost over the same points

The points are every stride-4 pixel of the clip (dense mode, P = T*H*W) or,
in points mode, ``num_points`` uniform draws per (layer, item), shared by
the Q predictions and the N targets, each clip sampled as one tall
(T*H, W) image (``_make_single``'s ``num_points > 0`` branch). With the
thing/stuff split the last ``num_stuff_queries`` queries may take only
stuff targets and the rest only things: two problems per (layer, item)
(``openpvsg_tpu/train/losses.py:187-220``).

The costs of every decoder layer and batch item are computed on the device
over padded targets (invalid ones get ``BIG_COST``); ``match_downsample``
> 1 average-pools both mask operands first (dense mode only). Three
solvers (``method``):

- 'hungarian': the (L, B, Q, N) costs are copied to the host in one
  transfer and solved there by the same C++ LAP as the JAX package
  (``native.linear_sum_assignment``), so ties break alike;
- 'lapjv': exact Jonker-Volgenant shortest augmenting paths on the device,
  every (layer, item) problem in lockstep, as the JAX package's nested
  vmap runs them; the arithmetic of each problem is the JAX loop's, so the
  assignments are the same bits;
- 'greedy': ``min(Q, N)`` rounds of taking the cheapest free (query,
  target) pair, on the device, approximate.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from openpvsg_torch import native
from openpvsg_torch.ops.sampling import Draw, point_sample

BIG_COST = 1e8


def _host_lap(cost: np.ndarray) -> np.ndarray:
    """cost (Q, N) -> assigned target index per query, -1 if unassigned.
    Padded (invalid) targets carry BIG_COST and are stripped on return."""
    cost = np.asarray(cost, dtype=np.float64)
    q, _ = cost.shape
    out = np.full(q, -1, dtype=np.int32)
    ri, ci = native.linear_sum_assignment(cost)
    for i, j in zip(ri, ci):
        if cost[i, j] < BIG_COST / 2:
            out[i] = j
    return out


def classification_cost(cls_pred: torch.Tensor,
                        gt_labels: torch.Tensor) -> torch.Tensor:
    """(..., Q, K+1) logits x (..., N) labels -> (..., Q, N); mmdet
    ClassificationCost."""
    probs = torch.softmax(cls_pred, dim=-1)
    idx = gt_labels[..., None, :].expand(*probs.shape[:-1], gt_labels.shape[-1])
    return -probs.gather(-1, idx)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or float64 when it is float64: the accumulation
    dtype of the costs."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def mask_bce_cost(mask_pts: torch.Tensor, tgt_pts: torch.Tensor) -> torch.Tensor:
    """Pairwise mean sigmoid BCE: (..., Q, P) logits x (..., N, P) binary ->
    (..., Q, N); mmdet CrossEntropyLossCost(use_sigmoid=True). The log
    sigmoids keep the logits' dtype; the products accumulate in float32."""
    P = mask_pts.shape[-1]
    tgt = _wide(tgt_pts)
    pos = _wide(F.logsigmoid(mask_pts))
    neg = _wide(F.logsigmoid(-mask_pts))
    cost = -(pos @ tgt.transpose(-1, -2) + neg @ (1.0 - tgt).transpose(-1, -2))
    return cost / P


def dice_cost(mask_pts: torch.Tensor, tgt_pts: torch.Tensor,
              eps: float = 1.0) -> torch.Tensor:
    """Pairwise dice cost with sigmoid activation (mmdet DiceCost,
    pred_act=True, naive dice): (..., Q, P) x (..., N, P) -> (..., Q, N).
    The sigmoid keeps the logits' dtype; products and sums accumulate in
    float32."""
    pred = _wide(torch.sigmoid(mask_pts))
    tgt = _wide(tgt_pts)
    numer = 2.0 * (pred @ tgt.transpose(-1, -2))
    denom = pred.sum(-1)[..., :, None] + tgt.sum(-1)[..., None, :]
    return -(numer + eps) / (denom + eps)


def greedy_assign_from_cost(cost: torch.Tensor, n_iters: int) -> torch.Tensor:
    """On-device greedy assignment of a batch of problems: ``n_iters``
    rounds of taking each problem's cheapest (query, target) pair (the
    first flat index among ties) and retiring its row and column, while
    that pair is below ``BIG_COST / 2``. cost (P, Q, N) with ``BIG_COST``
    at invalid targets -> (P, Q) int32 target index per query or -1
    (``greedy_assign_from_cost``, ``openpvsg_tpu/train/assign.py:79``)."""
    P, Q, N = cost.shape
    c = cost.float()
    assigned = torch.full((P, Q), -1, dtype=torch.int32, device=cost.device)
    rows = torch.arange(P, device=cost.device)
    for _ in range(n_iters):
        flat = c.reshape(P, -1).argmin(1)
        q, n = flat // N, flat % N
        ok = c[rows, q, n] < BIG_COST / 2
        assigned[rows, q] = torch.where(ok, n.int(), assigned[rows, q])
        # retire the row and the column
        retire = ((torch.arange(Q, device=c.device)[None, :, None] == q[:, None, None])
                  | (torch.arange(N, device=c.device)[None, None, :] == n[:, None, None]))
        retire &= ok[:, None, None]
        c = torch.where(retire, BIG_COST, c)
    return assigned


_INF = 1e30
# lockstep iterations run between two host checks of the loop conditions;
# an iteration of a finished problem changes nothing
LAPJV_CHECK_EVERY = 8


def lapjv_assign_from_cost(cost: torch.Tensor,
                           check_every: int = LAPJV_CHECK_EVERY,
                           stats: Optional[dict] = None) -> torch.Tensor:
    """Exact linear assignment of a batch of problems on the device:
    Jonker-Volgenant shortest augmenting paths
    (``lapjv_assign_from_cost``, ``openpvsg_tpu/train/assign.py:107-198``),
    all problems in lockstep.

    cost (P, Q, N) float32, each column all valid or all ``BIG_COST``;
    needs N <= Q. -> (P, Q) int32 target index per query, -1 if none.

    The targets are the persons, the queries the objects. For each target
    i in turn, a Dijkstra over reduced costs scans one new column per
    iteration until it reaches a free one; the scanned column is excluded
    from its own relaxation before the relaxation (f32 cancellation in
    (mu + K) - K can land below mu, and the other order can then set
    pred[j] to the row that j leads to and loop forever on the walk back).
    Then the potentials of the scanned columns are updated and the path is
    augmented. A problem whose target i is invalid, or whose search or
    walk has ended, is frozen while the others go on; the loops check on
    the host whether any problem is still running every ``check_every``
    iterations, and each check is one device-to-host sync. A search scans
    at most Q columns and a walk takes at most N steps, so a loop that runs
    longer (non-finite costs) raises instead of spinning. ``stats``, when
    given, receives the counts of host checks and lockstep iterations."""
    P, Q, N = cost.shape
    if N > Q:
        raise ValueError(f"lapjv assigner needs N <= Q, got (Q={Q}, N={N})")
    dev = cost.device
    C = cost.transpose(1, 2).float().contiguous()       # (P, N, Q)
    target_valid = C[:, :, 0] < BIG_COST / 2            # columns all-or-nothing
    rows = torch.arange(P, device=dev)
    cols = torch.arange(Q, device=dev)
    v = torch.zeros((P, Q), dtype=torch.float32, device=dev)
    x = torch.full((P, N), -1, dtype=torch.int64, device=dev)   # row -> col
    y = torch.full((P, Q), -1, dtype=torch.int64, device=dev)   # col -> row
    checks = iterations = 0
    for i in range(N):
        running = target_valid[:, i].clone()
        d = C[:, i] - v
        pred = torch.full((P, Q), i, dtype=torch.int64, device=dev)
        scanned = torch.zeros((P, Q), dtype=torch.bool, device=dev)
        sink = torch.full((P,), -1, dtype=torch.int64, device=dev)
        mu = torch.zeros((P,), dtype=torch.float32, device=dev)
        for _ in range(0, Q + check_every + 1, check_every):
            checks += 1
            if not bool(running.any()):
                break
            iterations += check_every
            for _ in range(check_every):
                dm = torch.where(scanned, _INF, d)
                j = dm.argmin(1)
                mu_j = dm[rows, j]
                y_j = y[rows, j]
                free = y_j < 0
                i2 = y_j.clamp(min=0)
                scanned = scanned | ((cols[None] == j[:, None]) & running[:, None])
                c_i2 = C[rows, i2]                      # (P, Q)
                alt = (mu_j[:, None] + c_i2 - v
                       - (c_i2[rows, j] - v[rows, j])[:, None])
                upd = (running & ~free)[:, None] & ~scanned & (alt < d)
                d = torch.where(upd, alt, d)
                pred = torch.where(upd, i2[:, None], pred)
                mu = torch.where(running, mu_j, mu)
                sink = torch.where(running & free, j, sink)
                running = running & ~free
        else:
            raise RuntimeError(f"lapjv: the search for target {i} scanned more "
                               f"than Q={Q} columns (non-finite costs?)")
        # dual update on the scanned columns keeps reduced costs >= 0
        v = torch.where(scanned, v + d - mu[:, None], v)
        j = sink
        for _ in range(0, N + check_every + 1, check_every):
            checks += 1
            if not bool((j >= 0).any()):
                break
            iterations += check_every
            for _ in range(check_every):
                on = j >= 0
                js = j.clamp(min=0)
                i2 = pred[rows, js]
                j_next = x[rows, i2]
                y[rows, js] = torch.where(on, i2, y[rows, js])
                x[rows, i2] = torch.where(on, js, x[rows, i2])
                j = torch.where(on, j_next, -1)
        else:
            raise RuntimeError(f"lapjv: the augmenting walk for target {i} took "
                               f"more than N={N} steps")
    if stats is not None:
        stats.update(host_checks=checks, iterations=iterations)
    return y.int()


def pool_masks(x: torch.Tensor, d: int) -> torch.Tensor:
    """Average-pool the trailing (H, W) of (..., T, H, W) by ``d``: the
    matching operands of ``match_downsample`` (the losses keep full
    resolution) (``pool_masks``, ``openpvsg_tpu/train/assign.py:201``)."""
    if d == 1:
        return x
    *lead, T, H, W = x.shape
    if H % d or W % d:
        raise ValueError(
            f"match_downsample={d} must divide the stride-4 mask grid "
            f"({H}, {W}); pad sizes are /32 so 2, 4 and 8 always divide")
    return x.reshape(*lead, T, H // d, d, W // d, d).mean(dim=(-1, -3))


def split_validity(gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                   num_queries: int, num_stuff_queries: int,
                   num_things_classes: int) -> torch.Tensor:
    """(B, N) -> (B, Q, N): which targets each query may take. Without the
    split (``num_stuff_queries`` 0) every valid one; with it, the last
    ``num_stuff_queries`` queries only stuff targets (label >=
    ``num_things_classes``), the others only things."""
    valid = gt_valid[:, None, :].expand(-1, num_queries, -1)
    if not num_stuff_queries:
        return valid
    thing_query = torch.arange(num_queries, device=gt_valid.device) < (
        num_queries - num_stuff_queries)
    thing_target = gt_labels < num_things_classes
    return valid & (thing_query[None, :, None] == thing_target[:, None, :])


def _tall_points(masks: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """masks (B, C, T, H, W) -> (B, C, P): each clip sampled as one tall
    (T*H, W) image at its item's points (B, P, 2), shared by its C masks
    (the channels of ``point_sample``)."""
    B, C, W = masks.shape[0], masks.shape[1], masks.shape[-1]
    return point_sample(masks.reshape(B, C, -1, W).permute(0, 2, 3, 1),
                        points).transpose(1, 2)


@torch.no_grad()
def assignment_costs(cls_preds: torch.Tensor, mask_preds: torch.Tensor,
                     gt_labels: torch.Tensor, gt_masks: torch.Tensor,
                     gt_valid: torch.Tensor, cls_weight: float = 2.0,
                     mask_weight: float = 5.0, dice_weight: float = 5.0,
                     num_points: int = 0, draw: Optional[Draw] = None,
                     num_stuff_queries: int = 0,
                     num_things_classes: int = 0,
                     match_downsample: int = 1) -> torch.Tensor:
    """cls_preds (L, B, Q, K+1), mask_preds (L, B, Q, T, H, W) logits,
    gt_labels (B, N), gt_masks (B, N, T, Hm, Wm) binary, gt_valid (B, N) ->
    the (L, B, Q, N) float32 cost, ``BIG_COST`` where a query may not take
    a target (``split_validity``). Dense (``num_points`` 0): clip masks are
    matched over all T*H*W pixels at once, at the prediction's resolution.
    Points: one ``draw`` of (L, B, num_points, 2), and the predictions and
    the targets are sampled there. ``match_downsample`` > 1 (dense only)
    average-pools the predictions and the targets first. One layer at a
    time; the mask operands keep their storage dtype (bfloat16 logits with
    ``mask_logits_dtype``) through the sigmoids, and the products and sums
    accumulate in float32, as in the JAX package."""
    L, B, Q = cls_preds.shape[:3]
    N = gt_labels.shape[1]
    if match_downsample != 1:
        if num_points > 0:
            raise ValueError("match_downsample requires dense matching "
                             "(num_points <= 0 / loss_sampling='dense')")
        mask_preds = pool_masks(mask_preds, match_downsample)
        gt_masks = pool_masks(gt_masks.float(), match_downsample)
    valid = split_validity(gt_labels, gt_valid, Q, num_stuff_queries,
                           num_things_classes)
    if num_points > 0:
        if draw is None:
            raise ValueError("points mode (num_points > 0) needs a draw")
        points = draw((L, B, num_points, 2))
    else:
        tgt = gt_masks.reshape(B, N, -1).float()
    out = []
    for layer in range(L):
        if num_points > 0:
            mp = _tall_points(mask_preds[layer], points[layer])
            tgt = _tall_points(gt_masks, points[layer])
        else:
            mp = mask_preds[layer].reshape(B, Q, -1)
        cost = (cls_weight * classification_cost(cls_preds[layer].float(),
                                                 gt_labels)
                + mask_weight * mask_bce_cost(mp, tgt)
                + dice_weight * dice_cost(mp, tgt))
        out.append(torch.where(valid, cost, BIG_COST))
    return torch.stack(out)


def _query_blocks(Q: int, num_stuff_queries: int) -> List[slice]:
    """The query rows solved as one problem: all of them, or with the split
    the thing queries and the last ``num_stuff_queries``."""
    if not num_stuff_queries:
        return [slice(0, Q)]
    return [slice(0, Q - num_stuff_queries), slice(Q - num_stuff_queries, Q)]


def lap_assign(costs: np.ndarray, num_stuff_queries: int = 0) -> np.ndarray:
    """Host LAP of every (layer, item): (L, B, Q, N) cost -> (L, B, Q)
    int32 target index per query, -1 where unassigned. With the split, the
    thing queries and the last ``num_stuff_queries`` are two problems."""
    L, B, Q, _ = costs.shape
    out = np.empty((L, B, Q), dtype=np.int32)
    for layer in range(L):
        for b in range(B):
            for rows in _query_blocks(Q, num_stuff_queries):
                out[layer, b, rows] = _host_lap(costs[layer, b, rows])
    return out


def device_assign(costs: torch.Tensor, method: str,
                  num_stuff_queries: int = 0) -> torch.Tensor:
    """'lapjv' or 'greedy' over every (layer, item) problem at once, on the
    costs' device: (L, B, Q, N) cost -> (L, B, Q) int32. With the split,
    the thing queries and the stuff queries are two batches of problems,
    each with its own Q (LAPJV checks N against each)."""
    L, B, Q, N = costs.shape
    out = []
    for rows in _query_blocks(Q, num_stuff_queries):
        c = costs[:, :, rows].reshape(L * B, -1, N)
        if method == "lapjv":
            a = lapjv_assign_from_cost(c)
        elif method == "greedy":
            a = greedy_assign_from_cost(c, min(c.shape[1], N))
        else:
            raise ValueError(f"device assigner '{method}': 'lapjv' or 'greedy'")
        out.append(a.reshape(L, B, -1))
    return torch.cat(out, dim=2)


def solve_assignment(costs: torch.Tensor, method: str = "hungarian",
                     num_stuff_queries: int = 0) -> np.ndarray:
    """(L, B, Q, N) costs -> (L, B, Q) int32 on the host: 'hungarian'
    copies the costs and runs the host LAP, 'lapjv' and 'greedy' solve on
    the device and copy the assignment."""
    if method == "hungarian":
        return lap_assign(costs.cpu().numpy(), num_stuff_queries)
    return device_assign(costs, method, num_stuff_queries).cpu().numpy()


def hungarian_assign_layers(cls_preds, mask_preds, gt_labels, gt_masks,
                            gt_valid, cls_weight: float = 2.0,
                            mask_weight: float = 5.0,
                            dice_weight: float = 5.0, num_points: int = 0,
                            draw: Optional[Draw] = None,
                            num_stuff_queries: int = 0,
                            num_things_classes: int = 0,
                            method: str = "hungarian",
                            match_downsample: int = 1) -> np.ndarray:
    """All decoder layers' assignments -> (L, B, Q) int32 on the host: the
    costs on the device, then ``solve_assignment`` by ``method``."""
    costs = assignment_costs(cls_preds, mask_preds, gt_labels, gt_masks,
                             gt_valid, cls_weight, mask_weight, dice_weight,
                             num_points, draw, num_stuff_queries,
                             num_things_classes, match_downsample)
    return solve_assignment(costs, method, num_stuff_queries)
