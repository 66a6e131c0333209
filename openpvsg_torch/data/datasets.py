"""Dataset over the PVSG filesystem layout: ``PVSGRelationDataset``, the
port of ``openpvsg_tpu/data/datasets.py:241`` (reference:
datasets/datasets/pvsg_relation.py:15-79). The segmenter's datasets are not
ported yet (ROADMAP.md A9b).

A plain Python sequence of numpy dicts (no torch DataLoader): the relation
trainer pads each video itself.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from openpvsg_torch.data import io as data_io
from openpvsg_torch.data.pvsg import PVSGRelationAnnotation


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
