"""Stage-boundary files: ``masks.txt`` MOTS RLE lines, ``query_feats.pickle``
and ``relations.pickle`` (formats shared with ``openpvsg_tpu`` and the
reference tooling).

masks.txt line format: ``frame id cid imh imw rle``.

A ``query_feats.pickle`` written by ``openpvsg_tpu`` names the class
``openpvsg_tpu.tracker.tubes.SimpleTube`` (VPS) or ``QueryFeatTube`` (IPS).
``load_pickle`` reads each as the port's class of the same name in
``openpvsg_torch.tracker.tubes`` (same attributes), so reading it never
imports the JAX package, and refuses every other ``openpvsg_tpu`` path.
"""
from __future__ import annotations

import os
import pickle
from collections import Counter
from typing import Dict, List, Sequence, Tuple

from openpvsg_torch.data import rle as rle_codec

_JAX_PACKAGE = "openpvsg_tpu"
_TUBE_MODULE = "openpvsg_tpu.tracker.tubes"
_TUBE_CLASSES = ("SimpleTube", "QueryFeatTube")


def write_masks_txt(path: str,
                    results: Sequence[Tuple[int, List[Dict], List[int]]]):
    """results: per frame (frame_id, rles, track_ids) where each rle dict has
    'size', 'counts' and 'class_id'."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for frame_id, rles, track_ids in results:
            for rle, track_id in zip(rles, track_ids):
                if track_id < 0:
                    continue
                imh, imw = rle["size"]
                f.write(f"{frame_id} {track_id} {rle['class_id']} "
                        f"{imh} {imw} {rle['counts']}\n")


def read_masks_txt(path: str) -> List[Dict]:
    """-> list of {fid, tid, cid, rle} (masks not decoded)."""
    out = []
    with open(path, "r") as f:
        for line in f:
            frame_id, track_id, cid, h, w, counts = line.strip().split()
            out.append({
                "fid": int(frame_id), "tid": int(track_id), "cid": int(cid),
                "rle": {"size": (int(h), int(w)), "counts": counts},
            })
    return out


def get_pred_mask_tubes(path: str) -> Dict[int, Dict]:
    """masks.txt -> {track_id: {'cid': majority class, 'mask': [{frame_id-1:
    mask}, ...]}}: masks.txt frame ids are 1-based, the keys 0-based
    (reference: utils/relation_matching.py:65-105)."""
    by_tid: Dict[int, List[Dict]] = {}
    for e in read_masks_txt(path):
        by_tid.setdefault(e["tid"], []).append(e)
    tubes: Dict[int, Dict] = {}
    for tid, items in by_tid.items():
        tube_class = Counter(it["cid"] for it in items).most_common(1)[0][0]
        tubes[tid] = {"cid": tube_class,
                      "mask": [{it["fid"] - 1: rle_codec.decode(it["rle"])}
                               for it in items]}
    return tubes


def save_pickle(path: str, data):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == _TUBE_MODULE and name in _TUBE_CLASSES:
            from openpvsg_torch.tracker import tubes

            return getattr(tubes, name)
        if module.split(".")[0] == _JAX_PACKAGE:
            raise pickle.UnpicklingError(
                f"{module}.{name}: the only classes of {_JAX_PACKAGE} that "
                f"openpvsg_torch reads are {_TUBE_MODULE}."
                f"{{{','.join(_TUBE_CLASSES)}}}")
        return super().find_class(module, name)


def load_pickle(path: str):
    with open(path, "rb") as f:
        return _PortUnpickler(f).load()
