"""Packed preprocessed training cache: decode and resize once, memmap after
(the port of ``openpvsg_tpu/data/packed.py``; a cache written by either
package is byte-identical and readable by both).

The PNG path re-does per-epoch-invariant host work every step: PNG decode,
frame resize to train_scale, nearest mask resize, palette-to-class decoding.
The cache does that work once at pack time and stores memmap-able shards:

  frames.bin  (F, oh, ow, 3) uint8   all frames of all videos, resized
  masks.bin   (F, oh, ow)    uint16  object-id maps, nearest-resized
  index.json  shapes + per-video {video_id, lo, n}
  luts.pkl    per-video object_id -> class-id int32 LUT (void = num_classes)

Per-step host work drops to numpy slicing (flip, crop and pad on uint8) and
a vectorized instance-mask build on the cropped id map; batches ship uint8
and the trainer normalizes them on the device.

As in the JAX package, the pack-time frame resize is PIL's bilinear, not
the PNG path's (``pipeline.preprocess_clip``): a training-augmentation
difference only; crops and flips are exact.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from openpvsg_torch.config import DataConfig
from openpvsg_torch.data.pipeline import (TrainAugmentor, load_mask,
                                          pad_to_divisor, resize_mask_nearest)
from openpvsg_torch.data.pvsg import DATA_SOURCES, PVSGAnnotation, frame_paths

_INDEX = "index.json"
_FRAMES = "frames.bin"
_MASKS = "masks.bin"
_LUTS = "luts.pkl"


def write_packed_cache(anno_file: str, data_dir: str, split: str,
                       out_dir: str,
                       train_scale: Tuple[int, int] = (360, 480),
                       sources: Sequence[str] = DATA_SOURCES,
                       video_ids: Optional[Sequence[str]] = None,
                       log_fn=None) -> Dict:
    """Pack every annotated frame of `split` into memmap shards under
    `out_dir`. Videos without masks are skipped (training needs GT).
    Returns the index dict."""
    from PIL import Image

    anno = PVSGAnnotation(anno_file)
    class_index = {c: i for i, c in enumerate(anno.classes)}
    num_classes = len(anno.classes)
    oh, ow = train_scale

    vids = list(video_ids) if video_ids else anno.video_ids(split, sources)
    plan = []  # (vid, img_paths, ann_paths)
    total = 0
    for vid in vids:
        imgs = frame_paths(data_dir, vid, "frames")
        anns = frame_paths(data_dir, vid, "masks")
        n = min(len(imgs), len(anns))
        if n == 0:
            continue
        plan.append((vid, imgs[:n], anns[:n]))
        total += n
    if not total:
        raise ValueError(f"no annotated frames found for split '{split}' "
                         f"under {data_dir}")

    os.makedirs(out_dir, exist_ok=True)
    frames_mm = np.memmap(os.path.join(out_dir, _FRAMES), np.uint8, "w+",
                          shape=(total, oh, ow, 3))
    masks_mm = np.memmap(os.path.join(out_dir, _MASKS), np.uint16, "w+",
                         shape=(total, oh, ow))
    videos, luts = [], []
    pos = 0
    for vid, imgs, anns in plan:
        objects = anno[vid]["objects"]
        max_oid = len(objects)
        lut = np.full(max_oid + 1, num_classes, np.int32)
        for oid in range(1, max_oid + 1):
            lut[oid] = class_index[objects[oid - 1]["category"]]
        lo = pos
        for img_p, ann_p in zip(imgs, anns):
            img = Image.open(img_p).convert("RGB")
            if img.size != (ow, oh):
                img = img.resize((ow, oh), Image.BILINEAR)
            frames_mm[pos] = np.asarray(img)
            m = load_mask(ann_p)
            if m.shape != (oh, ow):
                m = resize_mask_nearest(m, (oh, ow))
            if m.max() > max_oid:  # ids beyond the objects list are void
                m = np.where(m > max_oid, 0, m)
            masks_mm[pos] = m.astype(np.uint16)
            pos += 1
        videos.append({"video_id": vid, "lo": lo, "n": pos - lo})
        luts.append(lut)
        if log_fn:
            log_fn(f"packed {vid}: {pos - lo} frames ({pos}/{total})")
    frames_mm.flush()
    masks_mm.flush()

    index = {"total_frames": total, "train_scale": [oh, ow],
             "num_classes": num_classes, "videos": videos}
    with open(os.path.join(out_dir, _LUTS), "wb") as f:
        pickle.dump(luts, f)
    with open(os.path.join(out_dir, _INDEX), "w") as f:
        json.dump(index, f, indent=1)
    return index


class PackedTrainCache:
    """Read side: memmap views over the packed shards."""

    def __init__(self, cache_dir: str):
        path = os.path.join(cache_dir, _INDEX)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no packed cache at {cache_dir} (missing {_INDEX}); build "
                f"one with python -m openpvsg_torch.tools.pack_train_cache")
        with open(path) as f:
            self.index = json.load(f)
        self.oh, self.ow = self.index["train_scale"]
        self.num_classes = self.index["num_classes"]
        self.videos = self.index["videos"]
        F = self.index["total_frames"]
        self.frames = np.memmap(os.path.join(cache_dir, _FRAMES), np.uint8,
                                "r", shape=(F, self.oh, self.ow, 3))
        self.masks = np.memmap(os.path.join(cache_dir, _MASKS), np.uint16,
                               "r", shape=(F, self.oh, self.ow))
        with open(os.path.join(cache_dir, _LUTS), "rb") as f:
            self.luts: List[np.ndarray] = pickle.load(f)

    def clip_index(self, ref_seq_index: Sequence[int] = (0, 1)):
        """(video_idx, [global frame idx]) clips, mirroring
        PVSGVideoDataset's 'sequence' mode."""
        clips = []
        max_off = max(ref_seq_index)
        for vi, v in enumerate(self.videos):
            for i in range(v["n"] - max_off):
                clips.append((vi, [v["lo"] + i + o for o in ref_seq_index]))
        return clips

    def image_index(self):
        return [(vi, [v["lo"] + i])
                for vi, v in enumerate(self.videos) for i in range(v["n"])]


class PackedSampler:
    """make_sample over a PackedTrainCache: same item contract as the PNG
    path of the train CLI (images/gt_labels/gt_mask_tubes) except images
    stay uint8: SegmenterTrainer normalizes them on the device."""

    def __init__(self, cache: PackedTrainCache, data_cfg: DataConfig,
                 video: bool, seed: int = 0):
        self.cache = cache
        self.cfg = data_cfg
        self.video = video
        if tuple(data_cfg.train_scale) != (cache.oh, cache.ow):
            raise ValueError(
                f"cache was packed at train_scale ({cache.oh}, {cache.ow}) "
                f"but the config wants {tuple(data_cfg.train_scale)} — "
                f"repack with python -m openpvsg_torch.tools.pack_train_cache")
        self.aug = TrainAugmentor(data_cfg, seed)
        self.index = (cache.clip_index(data_cfg.ref_seq_index) if video
                      else cache.image_index())
        self.ch, self.cw = data_cfg.crop_size
        self.ph, self.pw = pad_to_divisor(self.ch, self.cw,
                                          data_cfg.pad_divisor)

    def __len__(self):
        return len(self.index)

    def _augment_masks(self, masks: np.ndarray, p: Dict) -> np.ndarray:
        m = masks[:, :, ::-1] if p["flip"] else masks
        y, x = p["crop_y"], p["crop_x"]
        return m[:, y:y + self.ch, x:x + self.cw]

    def __call__(self, idx: int) -> Optional[Dict]:
        vi, fidx = self.index[int(idx)]
        masks = np.asarray(self.cache.masks[fidx])          # (T, oh, ow)
        for _ in range(10):  # crop retry (transforms.py:262-267 check_match)
            p = self.aug.sample((self.cache.oh, self.cache.ow))
            mc = self._augment_masks(masks, p)
            # persistent-instance check across the clip
            ids = None
            for m in mc:
                present = set(np.unique(m)) - {0}
                ids = present if ids is None else (ids & present)
            if ids:
                break
        lut = self.cache.luts[vi]
        present = np.unique(mc)
        present = present[(present > 0) & (present < len(lut))]
        present = present[lut[present] < self.cache.num_classes]
        if not present.size:
            return None
        labels = lut[present].astype(np.int32)
        tubes = (mc[None] == present[:, None, None, None]).astype(np.uint8)
        tubes = np.pad(tubes, ((0, 0), (0, 0), (0, self.ph - self.ch),
                               (0, self.pw - self.cw)))

        frames = np.asarray(self.cache.frames[fidx])        # (T, oh, ow, 3)
        f = frames[:, :, ::-1] if p["flip"] else frames
        y, x = p["crop_y"], p["crop_x"]
        fc = f[:, y:y + self.ch, x:x + self.cw]
        images = np.pad(fc, ((0, 0), (0, self.ph - self.ch),
                             (0, self.pw - self.cw), (0, 0)))
        return {"images": images, "gt_labels": labels,
                "gt_mask_tubes": tubes}
