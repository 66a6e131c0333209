"""Plain VPS stage 2 after the forward, and the comparison of a run's
``masks.txt`` and ``query_feats.pickle`` with it.

The reference half is a frozen copy of what the port's
``run_query_tube_vps`` does after the model: the MinVIS stitch of each
window (cosine costs, an optimal assignment), the window mean of the
aligned class logits, panoptic fusion (4x bilinear upsample, sigmoid,
score-weighted owner, the owner's binary bit, the area rule), the segment
ids and the query feature of each segment; and the COCO RLE decoder. All
float32, numpy and scipy.

The comparison judges each program answer by how far the reference would
have to move to give it, as a served model's tokens are judged by the gap
of their logit below the reference's best:

- ``mask_gap``: over every pixel of the judged frames where the program's
  class differs from the reference's, the least that one decision of the
  reference would have to move to give the program's class there
  (``mask_gaps``); the largest. A near tie that bfloat16 flips costs
  little; a wrong answer stands against a firm reference.
- ``segment_gap``: over every segment the program wrote in the judged
  frames (its pixels and class), the least that the reference would have
  to move for one query, or one merge of queries for stuff, to give that
  whole segment (``producers``); the largest. It holds each segment's
  instance and class, which the class map alone does not.
- ``feat_gap``: over the same segments, the relative distance of its query
  feature to the nearest feature of a producer that gives the segment
  within the cell's ``segment_gap`` limit (the cheapest where none does):
  that query's aligned embedding, or the mean of that merge; the largest.
  A feature of another query than the segment's own reads as far from it
  as two queries are.
"""
from __future__ import annotations

import itertools
import pickle
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

INSTANCE_OFFSET = 1000


# ----------------------------------------------------------------- program files

def rle_decode(counts: str, h: int, w: int) -> np.ndarray:
    """pycocotools' rleFrString and decode: (h, w) uint8, column-major runs
    alternating from a zero-run."""
    runs, p = [], 0
    while p < len(counts):
        x, k, more = 0, 0, True
        while more:
            c = ord(counts[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(runs) > 2:
            x += runs[-2]
        runs.append(x)
    vals = np.zeros(len(runs), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, np.asarray(runs, np.int64))
    flat = np.concatenate([flat, np.zeros(max(0, h * w - flat.size), np.uint8)])
    return flat[:h * w].reshape(h, w, order="F")


def read_masks_txt(path: str) -> Dict[int, List[Tuple[int, int, int, int, str]]]:
    """{frame id (1-based): [(track id, class id, h, w, counts)]}."""
    out: Dict[int, list] = {}
    with open(path) as f:
        for line in f:
            fid, tid, cid, h, w, counts = line.split()
            out.setdefault(int(fid), []).append((int(tid), int(cid), int(h), int(w), counts))
    return out


class _Tube:
    """Stands in for the program's tube class: only its attributes are read."""


class _TubeUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name in ("SimpleTube", "QueryFeatTube") and module.endswith("tracker.tubes"):
            return _Tube
        if module.split(".")[0] in ("numpy", "builtins", "collections", "copyreg"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not read here")


def read_tubes(path: str) -> Dict[int, list]:
    """{track id: per-frame entries ({'query_feat', 'cls_id'} or None)}."""
    with open(path, "rb") as f:
        tubes = _TubeUnpickler(f).load()
    return {int(t.track_id): list(t.qf_tube) for t in tubes}


def class_map(entries, hw) -> np.ndarray:
    """One frame's masks.txt entries -> (H, W) class ids, -1 where none."""
    out = np.full(hw, -1, np.int64)
    for _, cid, h, w, counts in entries:
        out[rle_decode(counts, h, w) > 0] = cid
    return out


# -------------------------------------------------------------------- reference

def stitch(embds: np.ndarray) -> np.ndarray:
    """One window's MinVIS alignment: embds (T, Q, C) -> perms (T, Q),
    perms[t][slot] = the query of frame t in that slot (frame 0: the
    identity), each frame matched to the previous aligned one by cosine
    cost."""
    T, Q, _ = embds.shape
    perms = np.zeros((T, Q), np.int64)
    perms[0] = np.arange(Q)
    prev = embds[0]
    for t in range(1, T):
        a = prev / np.maximum(np.linalg.norm(prev, axis=1, keepdims=True), 1e-12)
        b = embds[t] / np.maximum(np.linalg.norm(embds[t], axis=1, keepdims=True), 1e-12)
        _, col = linear_sum_assignment(1.0 - a @ b.T)   # (slot, current query)
        perms[t] = col
        prev = embds[t][col]
    return perms


def fuse_window(cls, masks, embds, ori_hw, num_things: int, num_stuff: int,
                object_mask_thr: float, iou_thr: float, device) -> List[dict]:
    """Fusion of one window in float32. cls (T, Q, K+1), masks (T, Q, h, w)
    stride-4 logits of the padded frames, embds (T, Q, C), numpy or tensors.
    Returns per frame a dict: 'cls_map' (H, W) class ids (-1 where void),
    'feats' {segment id: feature}, the candidate features of every class
    ('cands'), and on the device what ``mask_gaps`` weighs a
    disagreement with: the upsampled mask logits, the window's class
    logits, each query's label, score, keep and valid bits and area ratio,
    and the owner of every pixel."""
    K = num_things + num_stuff
    embds = np.asarray(embds, np.float32)
    perms = stitch(embds)
    cls = torch.as_tensor(cls, dtype=torch.float32, device=device)
    masks = torch.as_tensor(masks, dtype=torch.float32, device=device)
    T, Q = cls.shape[:2]
    idx = torch.as_tensor(perms, device=device)
    cls_a = cls.gather(1, idx[:, :, None].expand(-1, -1, cls.shape[2]))
    masks_a = masks.gather(1, idx[:, :, None, None].expand(-1, -1, *masks.shape[2:]))
    embd_a = np.take_along_axis(embds, perms[:, :, None], 1)
    logits = cls_a.mean(0)                              # (Q, K+1), the window's
    probs = torch.softmax(logits, -1)
    scores, labels = probs.max(-1)
    keep = (labels != K) & (scores > object_mask_thr)
    oh, ow = int(ori_hw[0]), int(ori_hw[1])
    h, w = masks.shape[2:]
    out = []
    labels_np = labels.cpu().numpy()
    for t in range(T):
        up = F.interpolate(masks_a[t][None], size=(4 * h, 4 * w), mode="bilinear",
                           align_corners=False)[0][:, :oh, :ow].contiguous()
        sig = torch.sigmoid(up)
        val = torch.where(keep[:, None, None], scores[:, None, None] * sig,
                          torch.tensor(float("-inf"), device=device))
        owner = val.argmax(0)
        binary_all = up >= 0
        owned = (owner[None] == torch.arange(Q, device=device)[:, None, None]) & binary_all
        mask_area = owned.sum((1, 2))
        orig_area = binary_all.sum((1, 2))
        valid = (keep & (mask_area > 0) & (orig_area > 0)
                 & (mask_area >= iou_thr * orig_area))
        valid_np = valid.cpu().numpy()
        is_thing = labels_np < num_things
        inst = np.cumsum(valid_np & is_thing)
        seg_id = np.where(is_thing, labels_np + inst * INSTANCE_OFFSET, labels_np)
        owner_np = owner.cpu().numpy()
        painted = valid_np[owner_np] & binary_all.gather(0, owner[None])[0].cpu().numpy()
        feats: Dict[int, list] = {}
        for q in np.flatnonzero(valid_np):
            feats.setdefault(int(seg_id[q]), []).append(embd_a[t, q])
        out.append({
            "cls_map": np.where(painted, labels_np[owner_np], -1),
            "feats": {k: np.mean(v, 0) for k, v in feats.items()},
            "seg_map": np.where(painted, seg_id[owner_np], -1), "embd": embd_a[t],
            "up": up, "logits": logits, "labels": labels, "score": scores, "keep": keep,
            "valid": valid, "owner": owner, "iou_thr": iou_thr,
            "ratio": mask_area.float() / orig_area.clamp(min=1).float(),
        })
    return out


# -------------------------------------------------------------------- comparison

def query_costs(ref: dict, pix: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """(Q, n): for every query and each pixel of ``pix`` (flat indices), how
    far the reference's decisions would have to move for that query to give
    class ``cls`` there (-1: void): the cost of the query taking the pixel
    (the log of the owner's score-weighted sigmoid over the query's, 0 for
    the owner) and of it painting the class (its top class logit over that
    of the class or of void, its mask logit from 0, its area ratio from
    ``iou_thr``: each where it must change), the largest of the moves."""
    up = ref["up"]
    Q = up.shape[0]
    logits = ref["logits"]                                          # (Q, K+1)
    K = logits.shape[1] - 1
    u = up.reshape(Q, -1)[:, pix]                                   # (Q, n)
    labels, valid = ref["labels"], ref["valid"]
    # every query's score as if kept: its best class other than void
    score = torch.softmax(logits, -1)[:, :K].amax(-1)
    log_v = score.log()[:, None] + F.logsigmoid(u)
    own = (log_v.gather(0, ref["owner"].reshape(-1)[pix][None]) - log_v).clamp(min=0)
    top = logits.amax(-1)[:, None]
    paints = valid[:, None] & (u >= 0) & (labels != K)[:, None]
    ratio_cost = (ref["ratio"] - ref["iou_thr"]).abs()[:, None]
    # to void: unpaint by the label (to void), the mask bit or the area rule
    to_void = torch.where(paints, torch.minimum(torch.minimum(top - logits[:, K:K + 1], u.abs()),
                                                ratio_cost), 0.0)
    # to class c: the label to c, the bit to 1 and the area rule to valid
    lc = logits[:, cls.clamp(min=0)]                                # (Q, n)
    to_c = torch.maximum(torch.maximum(top - lc, torch.where(u >= 0, 0.0, -u)),
                         torch.where(valid[:, None], 0.0, ratio_cost).expand_as(u))
    paint = torch.where(cls[None] < 0, to_void, to_c)
    return torch.maximum(own, paint)


def mask_gaps(ref: dict, prog_cls_map: np.ndarray) -> np.ndarray:
    """For every pixel where the program's class differs from the
    reference's, the least over the queries of ``query_costs``: how far the
    reference would have to move to give the program's class there. An
    empty array where the two agree."""
    wrong = np.flatnonzero((prog_cls_map != ref["cls_map"]).reshape(-1))
    if wrong.size == 0:
        return np.zeros(0)
    dev = ref["up"].device
    pix = torch.as_tensor(wrong, device=dev)
    cprog = torch.as_tensor(prog_cls_map.reshape(-1)[wrong], device=dev)
    return query_costs(ref, pix, cprog).amin(0).cpu().numpy()


def producers(ref: dict, mask: np.ndarray, cid: int, num_things: int,
              max_members: int = 8, block: int = 1 << 14):
    """The reference's producers of one program segment (``mask`` (H, W) its
    pixels, ``cid`` its class), each with its cost: how far the reference
    would have to move to give that whole segment. A thing segment is one
    query's: its cost is the largest over the segment's pixels of
    ``query_costs``. A stuff segment is the merge of every query with its
    class: a set of the ``max_members`` queries that take some pixel of
    the segment the cheapest costs the largest over the pixels of the
    least of its members' costs, and at least the cost of its dearest
    member taking its cheapest pixel. Returns (costs (n,), member lists)."""
    dev = ref["up"].device
    pix = torch.as_tensor(np.flatnonzero(mask.reshape(-1)), device=dev)
    if pix.numel() == 0:
        return np.zeros(0), []
    C = query_costs(ref, pix, torch.full_like(pix, int(cid)))     # (Q, n)
    if cid < num_things:
        return C.amax(1).cpu().numpy(), [[q] for q in range(C.shape[0])]
    least = C.amin(1)
    order = torch.argsort(least).cpu().numpy()
    members = [int(q) for q in order[:max_members]]
    Cm = C[members]                                                 # (m, n)
    sets = [list(s) for r in range(1, len(members) + 1)
            for s in itertools.combinations(range(len(members)), r)]
    pick = torch.zeros(len(sets), len(members), dtype=torch.bool, device=dev)
    for i, s in enumerate(sets):
        pick[i, s] = True
    cover = torch.zeros(len(sets), device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for lo in range(0, Cm.shape[1], block):
        part = torch.where(pick[:, :, None], Cm[None, :, lo:lo + block], inf)
        cover = torch.maximum(cover, part.amin(1).amax(1))
    entry = torch.where(pick, least[members][None], -inf).amax(1)
    return (torch.maximum(cover, entry).cpu().numpy(),
            [[members[j] for j in s] for s in sets])


class Verdict:
    """The numbers of one side's judged frames:

    - ``mask_gap``: the largest of ``mask_gaps`` (class maps);
    - ``segment_gap``: over every segment, the cost of its cheapest producer
      (``producers``): how far the reference must move to give the
      segment's pixels and class to one query, or to one merge of queries
      for stuff; the largest;
    - ``feat_gap``: over every segment, the relative distance of its query
      feature to the nearest feature of the producers that give the segment
      within ``reach`` (the cheapest producer where none does): one query's
      aligned embedding, or the mean of a merge; the largest.

    ``segments`` counts the segments judged; a segment without a feature
    reads infinite."""

    def __init__(self, num_things: int, reach: float):
        self.num_things = num_things
        self.reach = reach
        self.gaps: List[np.ndarray] = []
        self.pixels = 0
        self.producers: List[Tuple[np.ndarray, np.ndarray]] = []   # (costs, distances)

    def add(self, ref: dict, prog_cls_map: np.ndarray, segments) -> None:
        """One frame: ``prog_cls_map`` (H, W) the program's class ids (-1
        where void), ``segments`` [(class id, (H, W) pixels, query feature,
        or the pickle's entry for the frame, or None)]."""
        self.gaps.append(mask_gaps(ref, prog_cls_map))
        self.pixels += prog_cls_map.size
        embd = ref["embd"]
        for cid, mask, item in segments:
            costs, sets = producers(ref, mask, cid, self.num_things)
            if item is None or not costs.size:
                self.producers.append((np.array([np.inf]), np.array([np.inf])))
                continue
            f = item["query_feat"] if isinstance(item, dict) else item
            f = np.asarray(f, np.float32).reshape(-1)
            cands = np.stack([embd[s].mean(0) for s in sets])
            d = (np.linalg.norm(cands - f, axis=1)
                 / np.maximum(np.linalg.norm(cands, axis=1), 1e-12))
            self.producers.append((costs, d))

    @property
    def segments(self) -> int:
        return len(self.producers)

    def feat_gaps(self, reach: float) -> np.ndarray:
        return np.array([d[costs <= max(reach, costs.min())].min()
                         for costs, d in self.producers])

    def readings(self, reach=None) -> Dict[str, float]:
        d = self.feat_gaps(self.reach if reach is None else reach)
        d = d if d.size else np.zeros(1)
        g = np.concatenate(self.gaps) if self.gaps else np.zeros(0)
        q = (lambda x: float(np.quantile(g, x))) if g.size else (lambda x: 0.0)
        return {"mask_gap": float(g.max()) if g.size else 0.0,
                "mask_gap_p99": q(0.99), "mask_wrong_share": g.size / max(self.pixels, 1),
                "segment_gap": max((float(c.min()) for c, _ in self.producers), default=0.0),
                "feat_gap": float(d.max()), "feat_gap_median": float(np.median(d))}
