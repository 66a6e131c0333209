"""Synthetic PVSG-format dataset generator, the port of
``openpvsg_tpu/data/synthetic.py``: the same files, byte for byte, from the
same seed.

Builds a miniature but schema-complete dataset tree (frames, object-id
masks, pvsg.json) with moving objects and GT relations, so every stage can
be exercised end to end without the real PVSG download.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

THING = ["person", "dog", "cat", "ball", "cup"]
STUFF = ["floor", "wall", "table"]
RELATIONS = ["on", "next-to", "holding", "looking-at", "touching"]

# rich mode: predicates derived from per-frame geometry (below), so spans
# vary per video and the map from features to relation is learnable but not
# memorizable (the default mode's fixed 2-relation schema saturates every
# head)
RICH_RELATIONS = ["above", "beneath", "next-to", "touching",
                  "approaching", "leaving", "moving-with", "carrying"]


def make_video(root: str, vid: str, n_frames: int, h: int, w: int,
               rng: np.random.Generator) -> Dict:
    """One video: a moving thing, a static thing, a stuff plane."""
    from PIL import Image

    source = "vidor" if vid.split("_")[0].isdigit() else "ego4d"
    fdir = os.path.join(root, source, "frames", vid)
    mdir = os.path.join(root, source, "masks", vid)
    os.makedirs(fdir, exist_ok=True)
    os.makedirs(mdir, exist_ok=True)

    colors = rng.integers(60, 255, (4, 3))
    for t in range(n_frames):
        img = rng.integers(0, 60, (h, w, 3)).astype(np.uint8)
        mask = np.zeros((h, w), np.uint8)
        # object 1: moving square (thing)
        sz = h // 5
        x0 = int((w - sz - 2) * t / max(n_frames - 1, 1)) + 1
        y0 = h // 5
        mask[y0:y0 + sz, x0:x0 + sz] = 1
        # object 2: static circle-ish blob (thing)
        yy, xx = np.mgrid[:h, :w]
        blob = (yy - h // 3) ** 2 + (xx - 3 * w // 4) ** 2 < (h // 7) ** 2
        mask[blob & (mask == 0)] = 2
        # object 3: floor strip (stuff)
        mask[int(h * 0.7):, :][mask[int(h * 0.7):, :] == 0] = 3
        for oid in (1, 2, 3):
            img[mask == oid] = colors[oid]
        Image.fromarray(img).save(os.path.join(fdir, f"{t:04d}.png"))
        Image.fromarray(mask).save(os.path.join(mdir, f"{t:04d}.png"))

    return {
        "video_id": vid,
        "meta": {"fps": 5, "num_frames": n_frames, "height": h, "width": w},
        "objects": [
            {"object_id": 1, "category": THING[0]},
            {"object_id": 2, "category": THING[1]},
            {"object_id": 3, "category": STUFF[0]},
        ],
        "relations": [
            [1, 3, "on", [[0, n_frames - 1]]],
            [1, 2, "next-to", [[n_frames // 3, 2 * n_frames // 3]]],
        ],
    }


def _bool_spans(flags: Sequence[bool], min_len: int = 3) -> List[List[int]]:
    """Contiguous True runs of >= min_len frames as [start, end] pairs
    (inclusive, the pvsg.json GT span format)."""
    spans, start = [], None
    for t, f in enumerate(flags):
        if f and start is None:
            start = t
        elif not f and start is not None:
            if t - start >= min_len:
                spans.append([start, t - 1])
            start = None
    if start is not None and len(flags) - start >= min_len:
        spans.append([start, len(flags) - 1])
    return spans


# rich-mode appearance: color keyed to category (so category is decodable
# from pixels), shape varies per category
_CAT_COLORS = {
    "person": (200, 60, 60), "dog": (60, 170, 60), "cat": (220, 180, 50),
    "ball": (70, 90, 220), "cup": (180, 70, 190),
    "floor": (110, 90, 70), "wall": (140, 140, 150), "table": (150, 110, 60),
}


def _rich_trajectory(kind: str, n_frames: int, h: int, w: int, sz: int,
                     rng: np.random.Generator) -> np.ndarray:
    """(T, 2) float centroids (cy, cx) for one motion pattern."""
    m = sz // 2 + 1
    if kind == "static":
        c = np.array([rng.uniform(m, h * 0.65 - m), rng.uniform(m, w - m)])
        return np.tile(c, (n_frames, 1))
    if kind == "orbit":
        cy = rng.uniform(h * 0.25, h * 0.5)
        cx = rng.uniform(w * 0.3, w * 0.7)
        r = rng.uniform(h * 0.1, h * 0.22)
        phase = rng.uniform(0, 2 * np.pi)
        t = np.arange(n_frames) * rng.uniform(0.15, 0.4) + phase
        return np.stack([cy + r * np.sin(t), cx + r * np.cos(t)], 1)
    if kind == "walk":
        vel = rng.normal(0, 1.2, (n_frames, 2)).cumsum(0) * 0.5
        start = np.array([rng.uniform(m, h * 0.6), rng.uniform(m, w - m)])
        traj = start + vel
        traj[:, 0] = np.clip(traj[:, 0], m, h * 0.68 - m)
        traj[:, 1] = np.clip(traj[:, 1], m, w - m)
        return traj
    # linear bounce
    pos = np.array([rng.uniform(m, h * 0.6), rng.uniform(m, w - m)])
    vel = rng.uniform(-1, 1, 2) * np.array([h, w]) / n_frames * 2.5
    traj = np.zeros((n_frames, 2))
    for t in range(n_frames):
        traj[t] = pos
        pos = pos + vel
        for d, hi in ((0, h * 0.68), (1, w)):
            if pos[d] < m or pos[d] > hi - m:
                vel[d] = -vel[d]
                pos[d] = np.clip(pos[d], m, hi - m)
    return traj


def _rich_predicates(n_frames: int, objs: List[Dict],
                     w: int) -> List[List[object]]:
    """GT relations from per-frame pair geometry. Subject is always a
    thing; stuff objects participate only as 'touching'/'above' objects
    (a thing standing on the floor), so stuff doesn't flood the label set.
    Predicate definitions (boxes b=(y0,y1,x0,x1), centroids c, velocities v):
      above/beneath  horizontal overlap + strictly higher/lower box
      next-to        vertical overlap, boxes disjoint, horizontal gap <= w/6
      touching       boxes intersect
      approaching    d|c_A - c_B|/dt < -0.5 px/frame
      leaving        d|c_A - c_B|/dt > +0.5 px/frame
      moving-with    both moving, velocity cosine > 0.8, distance < w/3
      carrying       person subject, smaller thing object, boxes intersect,
                     velocity difference < 1.5 px/frame
    """
    rels = []
    for a in objs:
        if a["kind"] != "thing":
            continue
        for b in objs:
            if b is a:
                continue
            flags = {r: np.zeros(n_frames, bool) for r in RICH_RELATIONS}
            ca, cb = a["traj"], b["traj"]
            va = np.diff(ca, axis=0, prepend=ca[:1])
            vb = np.diff(cb, axis=0, prepend=cb[:1])
            dist = np.linalg.norm(ca - cb, axis=1)
            for t in range(n_frames):
                (ay0, ay1, ax0, ax1) = a["boxes"][t]
                (by0, by1, bx0, bx1) = b["boxes"][t]
                hov = min(ax1, bx1) - max(ax0, bx0) > 0
                vov = min(ay1, by1) - max(ay0, by0) > 0
                inter = hov and vov
                flags["touching"][t] = inter
                flags["above"][t] = hov and ay1 <= by0 + 2
                if b["kind"] == "stuff":
                    continue  # stuff: only touching/above
                flags["beneath"][t] = hov and ay0 >= by1 - 2
                gap = max(bx0 - ax1, ax0 - bx1)
                flags["next-to"][t] = vov and not inter and 0 < gap <= w / 6
                if t > 0:
                    flags["approaching"][t] = dist[t] < dist[t - 1] - 0.5
                    flags["leaving"][t] = dist[t] > dist[t - 1] + 0.5
                sa, sb = np.linalg.norm(va[t]), np.linalg.norm(vb[t])
                if sa > 0.5 and sb > 0.5 and dist[t] < w / 3:
                    cos = float(va[t] @ vb[t]) / (sa * sb)
                    flags["moving-with"][t] = cos > 0.8
                flags["carrying"][t] = (
                    a["category"] == "person" and inter
                    and b["size"] < a["size"]
                    and float(np.linalg.norm(va[t] - vb[t])) < 1.5)
            for rname, fl in flags.items():
                spans = _bool_spans(fl)
                if spans:
                    rels.append([a["object_id"], b["object_id"], rname,
                                 spans])
    return rels


def make_rich_video(root: str, vid: str, n_frames: int, h: int, w: int,
                    rng: np.random.Generator,
                    max_things: int = 5) -> Dict:
    """Rich mode: 2-max_things moving things over a floor (+ optional
    wall), four motion patterns, relations derived from geometry
    (_rich_predicates) so spans vary per video and per pair."""
    from PIL import Image

    source = "vidor" if vid.split("_")[0].isdigit() else "ego4d"
    fdir = os.path.join(root, source, "frames", vid)
    mdir = os.path.join(root, source, "masks", vid)
    os.makedirs(fdir, exist_ok=True)
    os.makedirs(mdir, exist_ok=True)

    objs: List[Dict] = []
    oid = 1
    # stuff: floor always, wall sometimes
    floor_y = int(h * rng.uniform(0.68, 0.8))
    objs.append({"object_id": oid, "category": "floor", "kind": "stuff",
                 "size": h - floor_y,
                 "strip": ("bottom", floor_y)})
    oid += 1
    if rng.random() < 0.5:
        wall_x = int(w * rng.uniform(0.06, 0.12))
        objs.append({"object_id": oid, "category": "wall", "kind": "stuff",
                     "size": wall_x, "strip": ("left", wall_x)})
        oid += 1
    n_things = int(rng.integers(2, max_things + 1))
    kinds = ["linear", "orbit", "walk", "static"]
    for i in range(n_things):
        cat = THING[int(rng.integers(len(THING)))]
        sz = int(rng.uniform(h / 8, h / 4))
        kind = kinds[int(rng.integers(len(kinds)))]
        traj = _rich_trajectory(kind, n_frames, h, w, sz, rng)
        objs.append({"object_id": oid, "category": cat, "kind": "thing",
                     "size": sz, "traj": traj})
        oid += 1

    # per-frame boxes (y0, y1, x0, x1), clipped
    for o in objs:
        if o["kind"] == "stuff":
            side, v = o["strip"]
            box = ((v, h, 0, w) if side == "bottom" else (0, h, 0, v))
            o["boxes"] = [box] * n_frames
            o["traj"] = np.tile(
                [[(box[0] + box[1]) / 2, (box[2] + box[3]) / 2]],
                (n_frames, 1))
        else:
            half = o["size"] // 2
            boxes = []
            for cy, cx in o["traj"]:
                boxes.append((max(int(cy) - half, 0),
                              min(int(cy) + half, h),
                              max(int(cx) - half, 0),
                              min(int(cx) + half, w)))
            o["boxes"] = boxes

    for t in range(n_frames):
        img = rng.integers(0, 40, (h, w, 3)).astype(np.uint8)
        mask = np.zeros((h, w), np.uint8)
        for o in objs:  # later objects draw on top (occlusion)
            y0, y1, x0, x1 = o["boxes"][t]
            if y1 <= y0 or x1 <= x0:
                continue
            region = np.zeros((h, w), bool)
            if o["category"] == "ball":  # circle
                yy, xx = np.mgrid[:h, :w]
                cy, cx = o["traj"][t]
                region = ((yy - cy) ** 2 + (xx - cx) ** 2
                          < (o["size"] / 2) ** 2)
            else:
                region[y0:y1, x0:x1] = True
            mask[region] = o["object_id"]
            color = np.array(_CAT_COLORS[o["category"]])
            jitter = rng.integers(-15, 16, 3)
            img[region] = np.clip(color + jitter, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(fdir, f"{t:04d}.png"))
        Image.fromarray(mask).save(os.path.join(mdir, f"{t:04d}.png"))

    return {
        "video_id": vid,
        "meta": {"fps": 5, "num_frames": n_frames, "height": h, "width": w},
        "objects": [{"object_id": o["object_id"], "category": o["category"]}
                    for o in objs],
        "relations": _rich_predicates(n_frames, objs, w),
    }


def make_dataset(root: str, n_train: int = 2, n_val: int = 1,
                 n_frames: int = 8, h: int = 64, w: int = 64,
                 seed: int = 0, style: str = "simple",
                 max_things: int = 5) -> str:
    rng = np.random.default_rng(seed)
    data, train_ids, val_ids = [], [], []
    for i in range(n_train + n_val):
        vid = f"{1000 + i:04d}_synth{i}"
        if style == "rich":
            data.append(make_rich_video(root, vid, n_frames, h, w, rng,
                                        max_things=max_things))
        else:
            data.append(make_video(root, vid, n_frames, h, w, rng))
        (train_ids if i < n_train else val_ids).append(vid)
    anno = {
        "objects": {"thing": THING, "stuff": STUFF},
        "relations": RICH_RELATIONS if style == "rich" else RELATIONS,
        "split": {"vidor": {"train": train_ids, "val": val_ids},
                  "epic_kitchen": {"train": [], "val": []},
                  "ego4d": {"train": [], "val": []}},
        "data": data,
    }
    path = os.path.join(root, "pvsg.json")
    with open(path, "w") as f:
        json.dump(anno, f)
    return path


def write_oracle_stage2(data_dir: str, anno_file: str, work_dir: str,
                        split: str, feat_dim: int = 256,
                        seed: int = 0) -> List[str]:
    """Oracle stage 2: GT masks -> {split}_save_qf/{vid}/quantitive/masks.txt
    + query_feats.pickle, bypassing the segmenter and tracker.

    The tubes are perfect (track_id = GT object_id); each per-frame feature
    is a fixed random-projection entanglement of the object's geometry and
    category:

        base = [cy, cx, box_h, box_w, area, vy, vx, onehot(category)]
        feat = tanh(W @ base) + N(0, 0.02),  W fixed by `seed`

    ``masks.txt`` is byte-identical to the JAX package's. The pickle holds
    the port's ``SimpleTube`` per track, in the same order, with the same
    ``track_id`` and ``qf_tube`` (None before the first frame and at gaps)
    as the JAX package's ``QueryFeatTube``; the pickled class path differs.
    """
    from openpvsg_torch.data import io as data_io, rle as rle_codec
    from openpvsg_torch.data.pipeline import load_mask
    from openpvsg_torch.data.pvsg import PVSGAnnotation, frame_paths
    from openpvsg_torch.tracker.tubes import SimpleTube

    anno = PVSGAnnotation(anno_file)
    classes = anno.classes
    n_cls = len(classes)
    base_dim = 7 + n_cls
    proj = np.random.default_rng(seed).normal(
        0, 1.0 / np.sqrt(base_dim), (feat_dim, base_dim))
    noise_rng = np.random.default_rng(seed + 1)

    written = []
    for vid in anno.video_ids(split):
        info = anno[vid]
        cat_of = {o["object_id"]: classes.index(o["category"])
                  for o in info["objects"]}
        mask_files = frame_paths(data_dir, vid, "masks")
        if not mask_files:
            continue
        results = []
        tubes: Dict[int, SimpleTube] = {}
        prev_cent: Dict[int, np.ndarray] = {}
        for t, p in enumerate(mask_files):
            m = load_mask(p)
            h, w = m.shape
            frame_id = t + 1  # stage-2 frame ids are 1-based
            rles, tids = [], []
            for oid in np.unique(m):
                oid = int(oid)
                if oid == 0 or oid not in cat_of:
                    continue
                ys, xs = np.nonzero(m == oid)
                cy, cx = ys.mean(), xs.mean()
                bh = (ys.max() - ys.min() + 1) / h
                bw = (xs.max() - xs.min() + 1) / w
                area = len(ys) / (h * w)
                prev = prev_cent.get(oid)
                vy = (cy - prev[0]) / h if prev is not None else 0.0
                vx = (cx - prev[1]) / w if prev is not None else 0.0
                prev_cent[oid] = np.array([cy, cx])
                base = np.zeros(base_dim, np.float32)
                base[:7] = [cy / h, cx / w, bh, bw, area, vy, vx]
                base[7 + cat_of[oid]] = 1.0
                feat = (np.tanh(proj @ base)
                        + noise_rng.normal(0, 0.02, feat_dim)
                        ).astype(np.float32)

                rle = rle_codec.encode(
                    np.asfortranarray((m == oid).astype(np.uint8)))
                counts = rle["counts"]
                rle = {"size": rle["size"],
                       "counts": counts if isinstance(counts, str)
                       else counts.decode(),
                       "class_id": cat_of[oid]}
                rles.append(rle)
                tids.append(oid)
                tube = tubes.setdefault(oid, SimpleTube(oid))
                # None at the frames before this one that had no entry
                tube.qf_tube.extend([None] * (frame_id - 1 - len(tube)))
                tube.append({"query_feat": feat, "cls_id": cat_of[oid]})
            results.append((frame_id, rles, tids))
        total = len(mask_files)
        for tube in tubes.values():
            tube.qf_tube.extend([None] * (total - len(tube)))
        out_dir = os.path.join(work_dir, f"{split}_save_qf", vid)
        data_io.write_masks_txt(
            os.path.join(out_dir, "quantitive", "masks.txt"), results)
        data_io.save_pickle(os.path.join(out_dir, "query_feats.pickle"),
                            list(tubes.values()))
        written.append(out_dir)
    return written
