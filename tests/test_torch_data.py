"""The port's data path (openpvsg_torch.data, openpvsg_torch.eval.vpq,
openpvsg_torch.config, openpvsg_torch.utils.logging) against the JAX
package on the CPU: the same seed-made inputs, and the same synthetic PVSG
tree written by each package's generator, go through both.

Tolerances (measured gaps in brackets):
- integer outputs, files and dicts: equal (masks, ids, boxes, LUTs, the
  packed cache's files, dataset items, PQ/VPQ dicts with their nan);
- ``preprocess_clip``: 1e-5 absolute on the normalized frames (4.8e-7 on
  the train path's 360x640 -> 360x480, 6.0e-7 on a small downscale, 3.3e-6
  on a 24x32 -> 40x60 upscale, i.e. 2e-4 of a 0-255 pixel): torch's
  bilinear ``F.interpolate`` and ``jax.image.resize`` weigh the same two
  taps in a different float32 order; ``preprocess_test_frame`` the same
  bound (2.4e-7 measured: XLA rounds the normalization differently in the
  last bit).
"""
import dataclasses
import json
import logging
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

CLIP_TOL = 1e-5


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same synthetic tree from each package's generator: 2 train and 1
    val video of 5 48x64 frames, rich style (2-5 moving things, stuff)."""
    from openpvsg_tpu.data import synthetic as js
    from openpvsg_torch.data import synthetic as ts

    out = {}
    for name, gen in (("jax", js), ("torch", ts)):
        root = str(tmp_path_factory.mktemp(f"synth_{name}"))
        out[name] = (root, gen.make_dataset(root, 2, 1, 5, 48, 64, seed=4,
                                            style="rich"))
    return out


@pytest.mark.parametrize("style", ["simple", "rich"])
def test_synthetic_files_are_byte_identical(tmp_path, style):
    from openpvsg_tpu.data import io as jio, synthetic as js
    from openpvsg_torch.data import io as tio, synthetic as ts

    trees, works = {}, {}
    for name, gen in (("jax", js), ("torch", ts)):
        root = str(tmp_path / name)
        anno = gen.make_dataset(root, 2, 1, 4, 40, 56, seed=7, style=style)
        trees[name] = _tree(root)
        works[name] = [gen.write_oracle_stage2(root, anno, str(tmp_path / f"w_{name}"),
                                               split) for split in ("train", "val")]
    assert trees["jax"] == trees["torch"] and len(trees["jax"]) == 1 + 3 * 4 * 2
    for dirs_j, dirs_t in zip(works["jax"], works["torch"]):
        assert [os.path.basename(d) for d in dirs_j] == [os.path.basename(d) for d in dirs_t]
        for dj, dt in zip(dirs_j, dirs_t):
            assert (_tree(os.path.join(dj, "quantitive"))
                    == _tree(os.path.join(dt, "quantitive")))
            tj = jio.load_pickle(os.path.join(dj, "query_feats.pickle"))
            tt = tio.load_pickle(os.path.join(dt, "query_feats.pickle"))
            assert [t.track_id for t in tj] == [t.track_id for t in tt]
            for a, b in zip(tj, tt):
                assert len(a.qf_tube) == len(b.qf_tube)
                for x, y in zip(a.qf_tube, b.qf_tube):
                    assert (x is None) == (y is None)
                    if x is not None:
                        assert x["cls_id"] == y["cls_id"]
                        np.testing.assert_array_equal(x["query_feat"], y["query_feat"])


def _palette_case(seed):
    rng = np.random.default_rng(seed)
    pan = rng.integers(0, 7, (2, 24, 32)).astype(np.int32)
    pan[:, :4] = 0
    objects = [{"object_id": i + 1, "category": c}
               for i, c in enumerate(["person", "dog", "floor", "cup", "wall"])]
    class_index = {c: i for i, c in enumerate(
        ["person", "dog", "cat", "ball", "cup", "floor", "wall", "table"])}
    return pan, objects, class_index


MASK_CASES = ["decode_palette_mask", "masks_to_boxes", "pan_mm2hb", "pan_hb2mm",
              "panoptic_from_instance_map", "resize_mask_nearest",
              "check_label_consistency"]


@pytest.mark.parametrize("case", MASK_CASES)
def test_mask_helpers_are_bit_identical(case):
    from openpvsg_tpu.data import masks as jm, pipeline as jp
    from openpvsg_torch.data import masks as tm, pipeline as tp

    pan, objects, class_index = _palette_case(3)
    rng = np.random.default_rng(5)
    if case == "decode_palette_mask":
        got = tm.decode_palette_mask(pan[0], objects, class_index, 8)
        want = jm.decode_palette_mask(pan[0], objects, class_index, 8)
    elif case == "masks_to_boxes":
        masks = (rng.random((5, 24, 32)) < 0.05).astype(np.uint8)
        masks[2] = 0
        got, want = tm.masks_to_boxes(masks), jm.masks_to_boxes(masks)
    elif case in ("pan_mm2hb", "pan_hb2mm"):
        ids = rng.integers(0, 126, (24, 32)) + 1000 * rng.integers(0, 5, (24, 32))
        if case == "pan_hb2mm":
            ids = jm.pan_mm2hb(ids, 126)
            got, want = tm.pan_hb2mm(ids), jm.pan_hb2mm(ids)
        else:
            got, want = tm.pan_mm2hb(ids, 126), jm.pan_mm2hb(ids, 126)
    elif case == "panoptic_from_instance_map":
        lut = np.array([8, 0, 1, 5, 4, 6, 8], np.int32)
        got = tm.panoptic_from_instance_map(pan[0], lut)
        want = jm.panoptic_from_instance_map(pan[0], lut)
    elif case == "resize_mask_nearest":
        got = [tp.resize_mask_nearest(pan[0], hw) for hw in ((36, 40), (12, 17))]
        want = [jp.resize_mask_nearest(pan[0], hw) for hw in ((36, 40), (12, 17))]
    else:
        frames = [{"gt_instance_ids": [1, 2], "gt_labels": [0, 1]},
                  {"gt_instance_ids": [2, 3], "gt_labels": [1, 4]}]
        assert tm.check_label_consistency(frames) is None
        frames[1]["gt_labels"] = [2, 4]
        with pytest.raises(ValueError) as e_t:
            tm.check_label_consistency(frames)
        with pytest.raises(ValueError) as e_j:
            jm.check_label_consistency(frames)
        assert str(e_t.value) == str(e_j.value)
        return
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        got, want = [got[k] for k in want], list(want.values())
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_train_augmentor_draws_and_masks_are_equal():
    from openpvsg_tpu.data.pipeline import TrainAugmentor as JAug
    from openpvsg_torch.data.pipeline import TrainAugmentor as TAug

    kw = dict(train_scale=(30, 40), crop_size=(24, 28), flip_prob=0.5)
    ja = JAug(jcfg.DataConfig(**kw), seed=11)
    ta = TAug(tcfg.DataConfig(**kw), seed=11)
    pan = _palette_case(1)[0]
    for _ in range(12):
        p = ta.sample((24, 32))
        assert p == ja.sample((24, 32))
        got, want = ta.apply_to_masks(pan, p), ja.apply_to_masks(pan, p)
        np.testing.assert_array_equal(got, want)
        assert ta.check_match(got) == ja.check_match(want)


@pytest.mark.parametrize("shape,out_hw,crop,flip", [
    ((2, 360, 640), (360, 480), (0, 0, 360, 480), True),
    ((2, 360, 640), (360, 480), (0, 0, 360, 480), False),
    ((1, 40, 56), (30, 44), (3, 5, 24, 32), True),
    ((2, 24, 32), (40, 60), (7, 9, 30, 40), False)])
def test_preprocess_clip_matches_jax(shape, out_hw, crop, flip):
    from openpvsg_tpu.data import pipeline as jp
    from openpvsg_torch.data import pipeline as tp

    frames = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), np.uint8)
    cy, cx, ch, cw = crop
    ph, pw = tp.pad_to_divisor(ch, cw, 32)
    want = np.asarray(jp.preprocess_clip(jnp.asarray(frames), *out_hw, flip,
                                         jnp.int32(cy), jnp.int32(cx), ch, cw, ph, pw))
    got = tp.preprocess_clip(frames, *out_hw, flip, cy, cx, ch, cw, ph, pw,
                             device="cpu")
    assert got.dtype == tp.torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CLIP_TOL)
    frame = frames[0]
    want = np.asarray(jp.preprocess_test_frame(jnp.asarray(frame), *tp.pad_to_divisor(
        *frame.shape[:2])))
    got = tp.preprocess_test_frame(frame, *tp.pad_to_divisor(*frame.shape[:2]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CLIP_TOL)


def _items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kind", ["image", "single_video_image", "video_sequence",
                                  "video_random", "video_single"])
def test_dataset_items_are_equal(roots, kind):
    from openpvsg_tpu.data import datasets as jd
    from openpvsg_torch.data import datasets as td

    root, anno = roots["torch"]
    vid = "1002_synth2"
    make = {
        "image": lambda m: m.PVSGImageDataset(anno, root, "train"),
        "single_video_image": lambda m: m.PVSGSingleVideoImageDataset(anno, root, vid),
        "video_sequence": lambda m: m.PVSGVideoDataset(anno, root, "train", (0, 2)),
        "video_random": lambda m: m.PVSGVideoDataset(
            anno, root, "train", ref_sample_mode="random", num_ref_frames=2, seed=5),
        "video_single": lambda m: m.PVSGVideoSingleVideoDataset(anno, root, vid, 2),
    }[kind]
    dj, dt = make(jd), make(td)
    assert len(dj) == len(dt) > 0
    for i in list(range(len(dt))) * (2 if kind == "video_random" else 1):
        _items_equal(dt[i], dj[i])
    if kind.startswith("video_s") or kind == "video_random":
        if kind != "video_single":
            item = dt[1]
            _items_equal(dt.clip_targets(item["pan_masks"], item["objects"]),
                         dj.clip_targets(item["pan_masks"], item["objects"]))


def test_frame_stats_and_evaluate_are_equal(roots):
    from openpvsg_tpu.data.datasets import PVSGImageDataset as J
    from openpvsg_torch.data.datasets import PVSGImageDataset as T

    root, anno = roots["torch"]
    dj, dt = J(anno, root, "train"), T(anno, root, "train")
    rng = np.random.default_rng(0)
    # predictions: the GT map with a few segments relabeled or shifted
    results = []
    for i in range(len(dt)):
        gt = dt[i]["gt_panoptic_seg"]
        pred = (gt // 10000) + 1000 * (gt % 10000)  # hb -> mmdet
        if i % 2:
            pred = np.roll(pred, int(rng.integers(1, 9)), axis=1)
        results.append(pred)
    for a, b in zip(dt.frame_stats(results), dj.frame_stats(results)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    got, want = dt.evaluate(results), dj.evaluate(results)
    np.testing.assert_array_equal(got.pop("per_class"), want.pop("per_class"))
    assert got == want and got["PQ"] > 0


def test_vpq_dicts_are_equal_nan_included():
    from openpvsg_tpu.eval import vpq as jv
    from openpvsg_torch.eval import vpq as tv

    rng = np.random.default_rng(9)
    T, H, W = 6, 20, 24
    gt = np.zeros((T, H, W), np.int64)
    for t in range(T):
        gt[t, 2:10, 3 + t:12 + t] = 0 * 10000 + 1
        gt[t, 12:, :] = 5 * 10000
        gt[t, :2, :5] = 8 * 10000  # void
    pred = gt.copy()
    pred[3:, 2:10] = np.where(pred[3:, 2:10] == 1, 2, pred[3:, 2:10])  # id switch
    pred[:, 12:14] = 1 * 10000 + 3
    for k in range(T):
        got = tv.vpq_eval([pred[k], gt[k]], num_classes=8)
        want = jv.vpq_eval([pred[k], gt[k]], num_classes=8)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    assert (tv.window_vpq(list(pred), list(gt), 8, 5, 3, ign_id=8)
            == jv.window_vpq(list(pred), list(gt), 8, 5, 3, ign_id=8))
    # only thing classes present: PQ_st is nan in both (the reference's
    # mean over an empty slice)
    stats = [jv.vpq_eval([pred[k], gt[k]], num_classes=8) for k in range(T)]
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        got, want = tv.pq_summary(stats, 8, 0), jv.pq_summary(stats, 8, 0)
    np.testing.assert_array_equal(got.pop("per_class"), want.pop("per_class"))
    assert np.isnan(got["PQ_st"]) and np.isnan(want["PQ_st"])
    assert {k: v for k, v in got.items() if k != "PQ_st"} == \
        {k: v for k, v in want.items() if k != "PQ_st"}
    got, want = tv.pq_summary(stats, 5, 3), jv.pq_summary(stats, 5, 3)
    np.testing.assert_array_equal(got.pop("per_class"), want.pop("per_class"))
    assert got == want


def test_packed_cache_is_byte_identical_and_sampler_items_equal(roots, tmp_path):
    from openpvsg_tpu.data import packed as jpk
    from openpvsg_torch.data import packed as tpk

    root, anno = roots["torch"]
    kw = dict(train_scale=(40, 48))
    for name, m in (("jax", jpk), ("torch", tpk)):
        m.write_packed_cache(anno, root, "train", str(tmp_path / name), **kw)
    tj, tt = _tree(str(tmp_path / "jax")), _tree(str(tmp_path / "torch"))
    assert tj.keys() == tt.keys() == {"frames.bin", "masks.bin", "index.json", "luts.pkl"}
    for f in ("frames.bin", "masks.bin", "index.json"):
        assert tj[f] == tt[f], f
    for a, b in zip(pickle.loads(tj["luts.pkl"]), pickle.loads(tt["luts.pkl"])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    data = dict(train_scale=(40, 48), crop_size=(32, 40))
    for video in (True, False):
        sj = jpk.PackedSampler(jpk.PackedTrainCache(str(tmp_path / "torch")),
                               jcfg.DataConfig(**data), video=video, seed=3)
        st = tpk.PackedSampler(tpk.PackedTrainCache(str(tmp_path / "jax")),
                               tcfg.DataConfig(**data), video=video, seed=3)
        assert len(sj) == len(st) > 0
        for i in range(len(st)):
            a, b = st(i), sj(i)
            assert (a is None) == (b is None)
            if a is not None:
                _items_equal(a, b)
                assert a["images"].dtype == np.uint8


def _loader_case(m, n, batch, fail_at=None, drop=()):
    def make(i):
        if i == fail_at:
            raise OSError(f"corrupt sample {i}")
        return None if i in drop else {"i": i}
    return m.PrefetchLoader(make, list(range(n))[::-1], batch,
                            collate=lambda ss: [s["i"] for s in ss],
                            num_workers=3, prefetch_batches=2)


@pytest.mark.parametrize("case", ["order", "padding", "exception"])
def test_prefetch_loader_matches_jax(case, caplog):
    from openpvsg_tpu.data import loader as jl
    from openpvsg_torch.data import loader as tl

    kw = {"order": dict(n=11, batch=3), "padding": dict(n=12, batch=4, drop=(9, 10, 2)),
          "exception": dict(n=12, batch=4, fail_at=5)}[case]
    if case == "exception":
        for m in (tl, jl):
            with pytest.raises(OSError, match="corrupt sample 5"):
                list(_loader_case(m, **kw))
        return
    with caplog.at_level(logging.WARNING):
        got = list(_loader_case(tl, **kw))
    assert got == list(_loader_case(jl, **kw))
    assert len(got) == len(_loader_case(tl, **kw))
    if case == "order":
        assert got == [[10, 9, 8], [7, 6, 5], [4, 3, 2]]
    else:
        assert got == [[11, 8, 11, 8], [7, 6, 5, 4], [3, 1, 0, 3]]
        assert any("short batch" in r.message for r in caplog.records
                   if r.name == "openpvsg_torch.data.loader")


def test_config_json_reads_both_ways_and_refuses_unported_fields(tmp_path):
    path = str(tmp_path / "config.json")
    for name in ("mask2former_ips", "mask2former_vps", "relation_conv_large"):
        jcfg.save_config(jcfg.get_config(name), path)
        assert tcfg.get_config(path) == tcfg.get_config(name)
        tcfg.save_config(tcfg.get_config(name), path)
        assert jcfg.get_config(path) == jcfg.get_config(name)
    sets = ["train.lr=0.002", "data.crop_size=320,400", "model.num_queries=50",
            "data.flip_prob=0.25", "model.video=false", "train.lr_step_epochs=3,5"]
    want = jcfg.apply_overrides(jcfg.mask2former_vps(), jcfg.parse_set_args(sets))
    got = tcfg.apply_overrides(tcfg.mask2former_vps(), tcfg.parse_set_args(sets))
    jcfg.save_config(want, path)
    assert tcfg.load_config_file(path) == got
    # the tracker is ported: its non-default fields read as they were written
    tracker = {"track_buffer": 30, "remove_layers": ("layer3", "layer4"),
               "feat_size": (8, 16), "model_type": "crw"}
    jcfg.save_config(dataclasses.replace(
        jcfg.mask2former_vps(), tracker=jcfg.TrackerConfig(**tracker)), path)
    assert tcfg.load_config_file(path).tracker == tcfg.TrackerConfig(**tracker)
    jcfg.save_config(dataclasses.replace(
        jcfg.mask2former_vps(),
        model=dataclasses.replace(jcfg.Mask2FormerConfig(), int8_weights=True)), path)
    with pytest.raises(ValueError, match="int8_weights"):
        tcfg.load_config_file(path)
    with pytest.raises(KeyError, match="A12"):
        tcfg.get_config("mask2former_swin_vps")


def test_metrics_logger_writes_the_same_rows(tmp_path, monkeypatch):
    import time as time_mod

    import torch
    from openpvsg_tpu.utils.logging import MetricsLogger as J
    from openpvsg_torch.utils.logging import MetricsLogger as T

    monkeypatch.setattr(time_mod, "time", lambda: 1234.5)
    rows = {}
    for name, cls, scalar in (("jax", J, jnp.float32(2.5)), ("torch", T, torch.tensor(2.5))):
        lg = cls(str(tmp_path / name), use_wandb=True)  # no wandb: JSONL only
        seen = []
        lg.add_hook(lambda row, step: seen.append((row, step)))
        lg.log({"loss": scalar, "epoch": 1, "note": "skipped"}, step=7)
        lg.log({"lr": 1e-4})
        with open(lg.path) as f:
            rows[name] = [json.loads(ln) for ln in f]
        assert [s for _, s in seen] == [7, None]
    assert rows["jax"] == rows["torch"]
    assert rows["torch"][0] == {"time": 1234.5, "step": 7, "loss": 2.5, "epoch": 1.0}
