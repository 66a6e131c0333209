"""Datasets over the PVSG filesystem layout, the port of
``openpvsg_tpu/data/datasets.py`` (reference: datasets/datasets/):

  PVSGImageDataset            pvsg_image.py:17-175   (IPS train/eval)
  PVSGVideoDataset            pvsg_video.py:20-253   (VPS train, 2-frame clips)
  PVSGSingleVideoImageDataset pvsg_single_video.py   (IPS tube extraction)
  PVSGVideoSingleVideoDataset pvsg_video_single.py   (VPS tube extraction)
  PVSGRelationDataset         pvsg_relation.py:15-79 (stage-4 training)

Plain Python sequences of numpy dicts (no torch DataLoader): batching and
padding happen in the training CLI. The random reference frames of
``PVSGVideoDataset``'s 'random' mode come from ``random.Random(seed)`` in
the JAX package's draw order.
"""
from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from openpvsg_torch.data import io as data_io
from openpvsg_torch.data.masks import decode_palette_mask, pan_mm2hb
from openpvsg_torch.data.pipeline import load_frame, load_mask
from openpvsg_torch.data.pvsg import (DATA_SOURCES, PVSGAnnotation,
                                      PVSGRelationAnnotation, frame_paths)
from openpvsg_torch.eval.vpq import pq_summary, vpq_eval


class _FrameIndex:
    """Flat index of (video_id, frame_no, img_path, ann_path)."""

    def __init__(self, anno: PVSGAnnotation, data_dir: str, split: str,
                 sources: Sequence[str] = DATA_SOURCES,
                 video_ids: Optional[Sequence[str]] = None):
        self.anno = anno
        self.entries: List[Dict] = []
        vids = list(video_ids) if video_ids else anno.video_ids(split, sources)
        for vid in vids:
            imgs = frame_paths(data_dir, vid, "frames")
            anns = frame_paths(data_dir, vid, "masks")
            n = min(len(imgs), len(anns)) if anns else len(imgs)
            for i in range(n):
                self.entries.append({
                    "video_id": vid, "frame_id": i, "img": imgs[i],
                    "ann": anns[i] if anns else None,
                    "objects": anno[vid]["objects"],
                })


class PVSGImageDataset:
    """Per-frame dataset for IPS training/eval. Items carry the raw RGB
    frame and decoded GT targets; augmentation/normalization is applied by
    the training tool (device-side)."""

    def __init__(self, anno_file: str, data_dir: str, split: str = "train",
                 sources: Sequence[str] = DATA_SOURCES,
                 video_ids: Optional[Sequence[str]] = None):
        self.anno = PVSGAnnotation(anno_file)
        self.class_index = {c: i for i, c in enumerate(self.anno.classes)}
        self.num_classes = len(self.anno.classes)
        self.index = _FrameIndex(self.anno, data_dir, split, sources, video_ids)

    def __len__(self):
        return len(self.index.entries)

    def __getitem__(self, i: int) -> Dict:
        e = self.index.entries[i]
        # "objects" must ride along: decode_palette_mask maps unknown
        # object ids to the void label, so a consumer decoding the
        # augmented mask without it gets all-void GT (silent — found when
        # an IPS model trained to predict only background, DEMO.md)
        out = {"video_id": e["video_id"], "frame_id": e["frame_id"],
               "img": load_frame(e["img"]), "objects": e["objects"]}
        if e["ann"]:
            pan = load_mask(e["ann"])
            out.update(decode_palette_mask(
                pan, e["objects"], self.class_index, self.num_classes))
            out["pan_mask"] = pan
        return out

    def frame_stats(self, results: Sequence[np.ndarray],
                    indices: Optional[Sequence[int]] = None):
        """Per-frame PQ stat tuples for results aligned with `indices`
        (default: 0..len(results)). The tuples element-sum, so multi-host
        eval can compute stats on a strided frame partition per process and
        merge (tools/test.py)."""
        indices = range(len(results)) if indices is None else indices
        stats = []
        for i, pan_result in zip(indices, results):
            gt = self[int(i)]
            pred = pan_mm2hb(pan_result, self.num_classes)
            stats.append(vpq_eval(
                [pred, gt["gt_panoptic_seg"]], num_classes=self.num_classes,
                ign_id=self.num_classes))
        return stats

    def evaluate(self, results: Sequence[np.ndarray]) -> Dict[str, float]:
        """results[i] = mmdet-format pan map for frame i. Computes PQ
        (reference: pvsg_image.py:127-175)."""
        n_thing = len(self.anno.thing_classes)
        n_stuff = len(self.anno.stuff_classes)
        return pq_summary(self.frame_stats(results), n_thing, n_stuff)


class PVSGSingleVideoImageDataset(PVSGImageDataset):
    """All frames of ONE video, ordered (reference: pvsg_single_video.py)."""

    def __init__(self, anno_file: str, data_dir: str, video_name: str,
                 split: str = "val"):
        super().__init__(anno_file, data_dir, split,
                         video_ids=[video_name])
        self.video_name = video_name


class PVSGVideoDataset:
    """Clip dataset for VPS training (reference: pvsg_video.py
    ref_sample_mode semantics):
      'sequence': ref_seq_index [0, 1] yields fixed-offset clips anchored at
                  every frame with valid successors
      'random':   reference frames drawn uniformly within ±ref_seq_range of
                  the key frame, resampled per access
      'test':     fixed windows (see PVSGVideoSingleVideoDataset)
    """

    def __init__(self, anno_file: str, data_dir: str, split: str = "train",
                 ref_seq_index: Sequence[int] = (0, 1),
                 ref_sample_mode: str = "sequence",
                 ref_seq_range: int = 3,
                 num_ref_frames: int = 1,
                 sources: Sequence[str] = DATA_SOURCES,
                 video_ids: Optional[Sequence[str]] = None,
                 seed: int = 0):
        self.anno = PVSGAnnotation(anno_file)
        self.class_index = {c: i for i, c in enumerate(self.anno.classes)}
        self.num_classes = len(self.anno.classes)
        self.ref_seq_index = tuple(ref_seq_index)
        self.ref_sample_mode = ref_sample_mode
        self.ref_seq_range = ref_seq_range
        self.num_ref_frames = num_ref_frames
        self.rng = random.Random(seed)
        self.clips: List[Dict] = []
        vids = list(video_ids) if video_ids else self.anno.video_ids(split, sources)
        for vid in vids:
            imgs = frame_paths(data_dir, vid, "frames")
            anns = frame_paths(data_dir, vid, "masks")
            n = min(len(imgs), len(anns)) if anns else len(imgs)
            if ref_sample_mode == "random":
                for i in range(n):
                    self.clips.append({
                        "video_id": vid, "key": i, "n": n,
                        "imgs": imgs, "anns": anns if anns else None,
                        "objects": self.anno[vid]["objects"],
                    })
            else:
                max_off = max(self.ref_seq_index)
                for i in range(n - max_off):
                    self.clips.append({
                        "video_id": vid,
                        "imgs": [imgs[i + o] for o in self.ref_seq_index],
                        "anns": [anns[i + o] for o in self.ref_seq_index]
                        if anns else None,
                        "objects": self.anno[vid]["objects"],
                    })

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i: int) -> Dict:
        c = self.clips[i]
        if self.ref_sample_mode == "random":
            key, n = c["key"], c["n"]
            lo = max(0, key - self.ref_seq_range)
            hi = min(n - 1, key + self.ref_seq_range)
            refs = [self.rng.randint(lo, hi) for _ in range(self.num_ref_frames)]
            idxs = [key] + refs
            img_paths = [c["imgs"][j] for j in idxs]
            ann_paths = [c["anns"][j] for j in idxs] if c["anns"] else None
        else:
            img_paths = c["imgs"]
            ann_paths = c["anns"]
        frames = np.stack([load_frame(p) for p in img_paths])
        out = {"video_id": c["video_id"], "imgs": frames}
        if ann_paths:
            out["pan_masks"] = np.stack([load_mask(p) for p in ann_paths])
            out["objects"] = c["objects"]
        return out

    def clip_targets(self, pan_masks: np.ndarray, objects) -> Dict:
        """Decode clip GT into per-instance mask tubes keyed by persistent
        instance ids (reference: preprocess_video_panoptic_gt,
        maskformer_video_head.py:138-179)."""
        T = pan_masks.shape[0]
        ids = sorted(set(np.unique(pan_masks)) - {0})
        lut = {obj["object_id"]: self.class_index[obj["category"]]
               for obj in objects if "object_id" in obj}
        labels, tubes = [], []
        for oid in ids:
            if oid - 1 < len(objects):
                labels.append(self.class_index[objects[oid - 1]["category"]])
            elif oid in lut:
                labels.append(lut[oid])
            else:
                continue
            tubes.append((pan_masks == oid).astype(np.uint8))
        return {
            "gt_labels": np.asarray(labels, np.int32),
            "gt_mask_tubes": (np.stack(tubes) if tubes
                              else np.zeros((0, *pan_masks.shape), np.uint8)),
            "gt_instance_ids": np.asarray(ids, np.int32),
        }


class PVSGVideoSingleVideoDataset:
    """Windows of `ref_seq_len_test` frames over ONE video (VPS tube
    extraction; reference: pvsg_video_single.py)."""

    def __init__(self, anno_file: str, data_dir: str, video_name: str,
                 ref_seq_len_test: int = 2):
        self.anno = PVSGAnnotation(anno_file)
        self.video_name = video_name
        self.window = ref_seq_len_test
        self.img_paths = frame_paths(data_dir, video_name, "frames")

    def __len__(self):
        return (len(self.img_paths) + self.window - 1) // self.window

    def __getitem__(self, i: int) -> Dict:
        lo = i * self.window
        paths = self.img_paths[lo:lo + self.window]
        return {
            "video_id": self.video_name,
            "frame_ids": list(range(lo, lo + len(paths))),
            "imgs": np.stack([load_frame(p) for p in paths]),
        }



class PVSGRelationDataset:
    """Stage-4 dataset: ``{work_dir}/{vid}/relations.pickle`` written by
    ``run_rel_set``, for the videos of ``split`` that have one. Tube ids are
    re-indexed densely in sorted order."""

    def __init__(self, anno_file: str, split: str, work_dir: str,
                 return_mask: bool = False):
        self.anno = PVSGRelationAnnotation(anno_file, split)
        self.relations = self.anno.relations
        self.classes = self.anno.classes
        self.work_dir = work_dir
        self.return_mask = return_mask
        self.video_ids = [
            vid for vid in self.anno.split_video_ids
            if os.path.exists(os.path.join(work_dir, vid, "relations.pickle"))
        ]

    def __len__(self):
        return len(self.video_ids)

    def __getitem__(self, i: int) -> Dict:
        vid = self.video_ids[i]
        data = data_io.load_pickle(
            os.path.join(self.work_dir, vid, "relations.pickle"))
        feats_dict: Dict[int, np.ndarray] = data["feats"]
        tube_ids = sorted(feats_dict.keys())
        reindex = {tid: k for k, tid in enumerate(tube_ids)}
        feats = np.stack([feats_dict[tid] for tid in tube_ids]).astype(np.float32)
        relations = []
        for rel in data["relations"]:
            relations.append({
                "subject_index": reindex[rel["subject_index"]],
                "object_index": reindex[rel["object_index"]],
                "relation": rel["relation"],
                "relation_span": np.asarray(rel["relation_span"]),
            })
        out = {"vid": vid, "feats": feats, "relations": relations,
               "tube_ids": tube_ids}
        if self.return_mask:
            # the decoded predicted mask tubes, re-indexed like feats
            # (reference: pvsg_relation.py's return_mask, for rel_test_full)
            tubes = self.get_pred_mask_tubes(vid)
            out["masks"] = {reindex[tid]: tube
                            for tid, tube in tubes.items() if tid in reindex}
        return out

    def get_pred_mask_tubes(self, vid: str):
        return data_io.get_pred_mask_tubes(
            os.path.join(self.work_dir, vid, "quantitive", "masks.txt"))
