"""pvsg.json schema accessors, the port of ``openpvsg_tpu/data/pvsg.py``.

Schema (reference: notebooks/"Understanding PVSG Dataset"): top-level keys
  objects:   {thing: [115 names], stuff: [11 names]}
  relations: [57 names]
  split:     {vidor|epic_kitchen|ego4d: {train: [vid...], val: [vid...]}}
  data:      [ {video_id, meta, objects: [{object_id, category, ...}],
                relations: [[subj_oid, obj_oid, relation_str,
                             [[start, end], ...]]], ...}, ... ]

Per-frame masks are palette PNGs whose pixel value equals the annotation's
object_id (0 = background/void).
"""
from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Optional, Sequence

DATA_SOURCES = ("vidor", "epic_kitchen", "ego4d")


def data_source_of(video_id: str) -> str:
    """The data source of a video id (reference: utils/rel_metrics.py:72-78
    and utils/relation_matching.py:108-114)."""
    if video_id.startswith("P"):
        return "epic_kitchen"
    head = video_id.split("_")[0]
    if head.isdigit() and len(head) == 4:
        return "vidor"
    return "ego4d"


class PVSGAnnotation:
    """Random access to raw per-video annotations, keyed by video_id
    (reference: datasets/datasets/utils.py:122-137)."""

    def __init__(self, anno_file: str, video_ids: Optional[Sequence[str]] = None):
        with open(anno_file, "r") as f:
            anno = json.load(f)
        self.raw = anno
        self.thing_classes: List[str] = anno["objects"]["thing"]
        self.stuff_classes: List[str] = anno["objects"]["stuff"]
        self.classes: List[str] = self.thing_classes + self.stuff_classes
        self.relations: List[str] = anno["relations"]
        self.split: Dict = anno["split"]
        keep = set(video_ids) if video_ids is not None else None
        self.videos: Dict[str, Dict] = {
            v["video_id"]: v
            for v in anno["data"]
            if keep is None or v["video_id"] in keep
        }

    def video_ids(self, split: str = "train",
                  sources: Sequence[str] = DATA_SOURCES) -> List[str]:
        out: List[str] = []
        for src in sources:
            out.extend(self.split.get(src, {}).get(split, []))
        return [v for v in out if v in self.videos]

    def __contains__(self, vid: str) -> bool:
        return vid in self.videos

    def __getitem__(self, vid: str) -> Dict:
        if vid not in self.videos:
            raise KeyError(vid)
        return self.videos[vid]


class PVSGRelationAnnotation(PVSGAnnotation):
    """Annotation view with category and relation names mapped to dense
    indices (reference: utils/relation_matching.py:15-52)."""

    def __init__(self, anno_file: str, split: str = "train"):
        super().__init__(anno_file)
        self.split_name = split
        self._split_ids = []
        for src in DATA_SOURCES:
            self._split_ids.extend(self.split.get(src, {}).get(split, []))

    @property
    def split_video_ids(self) -> List[str]:
        return list(self._split_ids)

    def __getitem__(self, vid: str) -> Dict:
        info = copy.deepcopy(super().__getitem__(vid))
        objects = []
        for obj in info["objects"]:
            obj = dict(obj)
            obj["category"] = self.classes.index(obj["category"])
            objects.append(obj)
        relations = []
        for rel in info["relations"]:
            if rel[2] in self.relations:
                rel = list(rel)
                rel[2] = self.relations.index(rel[2])
                relations.append(rel)
        return {
            "video_id": vid,
            "objects": objects,
            "relations": relations,
            "relation_str": info["relations"],
            "meta": info.get("meta", {}),
        }


def frame_paths(data_dir: str, video_id: str, kind: str = "frames") -> List[str]:
    """Sorted frame (or mask) paths of a video under the reference layout
    data/{source}/{frames|masks}/{vid}/*.png."""
    root = os.path.join(data_dir, data_source_of(video_id), kind, video_id)
    if not os.path.isdir(root):
        return []
    names = sorted(n for n in os.listdir(root)
                   if n.endswith(".png") or n.endswith(".jpg"))
    return [os.path.join(root, n) for n in names]
