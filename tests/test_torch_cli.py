"""The port's stage-1 CLIs (``python -m openpvsg_torch.tools.{make_synthetic_data,
pack_train_cache,train,test}``) and the IPS half of its SegmenterInference
against the JAX package on the CPU, at the tests' small size (R-26, 8
queries, 3 decoder layers, 64x64 frames, as tests/test_end2end.py:74), on a
synthetic PVSG tree written by the port's generator (2 train and 1 val video
of 3 frames; 5 thing and 3 stuff classes).

Weights: the port's random weights from a seed (with random BN statistics,
so folding the BN is not the identity, and the void logit pushed down so
that segments are kept), carried to the JAX package by ``to_jax_params``;
for the test CLI, the checkpoint the port's train CLI wrote, edited the
same way.

Tolerances (measured gaps in brackets):
- ``pan_results``, segment ids, the test CLI's result maps and its PQ/VPQ
  dicts: equal;
- per-segment ``query_feats``: 1e-4 absolute (<= 2.4e-6), the bound
  tests/test_torch_stage2.py holds the pickled features to;
- the train CLI's first batch: GT equal; images within the clip tolerance
  of tests/test_torch_data.py, 1e-5 (<= 6.0e-7).
"""
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

FEAT_TOL = 1e-4
CLIP_TOL = 1e-5
MODEL_SETS = ["model.backbone.depth=26", "model.num_queries=8",
              "model.num_things_classes=5", "model.num_stuff_classes=3",
              "model.decoder.num_layers=3", "model.decoder.ffn_channels=64",
              "model.pixel_decoder.encoder_layers=1",
              "model.pixel_decoder.ffn_channels=64"]
KEEP_SETS = ["model.object_mask_thr=0.01", "model.iou_thr=0.1"]
TRAIN_SETS = ["data.train_scale=48,56", "data.crop_size=40,48",
              "train.samples_per_gpu=8", "data.num_workers=1",
              "train.log_interval=1"]


def _cfg(m, preset="mask2former_vps"):
    """The tiny model of either package, from the same --set lines."""
    cfg = m.apply_overrides(m.get_config(preset),
                            m.parse_set_args(MODEL_SETS + KEEP_SETS + TRAIN_SETS))
    return cfg


def _keep_segments(state, seed=2, void_shift=4.0):
    """Random BN statistics and a lower void logit (in place)."""
    rng = np.random.default_rng(seed)
    for k, v in state.items():
        if k.endswith("running_var"):
            state[k] = torch.from_numpy((1.0 + rng.random(v.shape)).astype(np.float32))
        elif k.endswith("running_mean"):
            state[k] = torch.from_numpy((0.1 * rng.standard_normal(v.shape)).astype(np.float32))
    state["head.cls_embed.bias"][-1] -= void_shift
    return state


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from openpvsg_torch.tools import make_synthetic_data

    root = str(tmp_path_factory.mktemp("cli_data"))
    anno = make_synthetic_data.main(["--out", root, "--frames", "3", "--size", "64", "64",
                                     "--seed", "5"])
    return root, anno


def _cli_args(data, work, *extra):
    root, anno = data
    return ["--config", "mask2former_vps", "--data-dir", root, "--anno-file", anno,
            "--work-dir", work, "--device", "cpu",
            "--set", *MODEL_SETS, *TRAIN_SETS, *extra]


@pytest.fixture(scope="module")
def train_runs(data, tmp_path_factory):
    """The port's train CLI: one epoch (2 steps of 2 clips), then
    ``--epochs 2 --auto-resume`` in the same work dir."""
    from openpvsg_torch.tools import train

    work = str(tmp_path_factory.mktemp("cli_work"))
    fresh = train.main(_cli_args(data, work) + ["--epochs", "1"])
    resumed = train.main(_cli_args(data, work) + ["--epochs", "2", "--auto-resume"])
    return {"fresh": fresh, "auto_resume": resumed}


def _jax_first_batch(data, start_epoch):
    """The first batch the JAX package's pieces build from the same seed:
    its dataset, TrainAugmentor, preprocess_clip, clip_targets, the JAX
    CLI's pad_targets, and the data-order stream with ``start_epoch``
    permutations drawn first."""
    from openpvsg_tpu.data.datasets import PVSGVideoDataset
    from openpvsg_tpu.data.pipeline import (TrainAugmentor, pad_to_divisor,
                                            preprocess_clip)
    from tools.train import pad_targets

    cfg = _cfg(jcfg)
    root, anno = data
    ds = PVSGVideoDataset(anno, root, "train", cfg.data.ref_seq_index)
    rng = np.random.default_rng(cfg.train.seed)
    for _ in range(start_epoch):
        rng.permutation(len(ds))
    order = rng.permutation(len(ds))
    aug = TrainAugmentor(cfg.data, cfg.train.seed)
    (oh, ow), (ch, cw) = cfg.data.train_scale, cfg.data.crop_size
    ph, pw = pad_to_divisor(ch, cw, cfg.data.pad_divisor)
    samples = []
    for i in order[:max(cfg.train.samples_per_gpu // 4, 1)]:
        item = ds[int(i)]
        for _ in range(10):
            p = aug.sample(item["imgs"].shape[1:3])
            masks = aug.apply_to_masks(item["pan_masks"], p)
            if aug.check_match(masks):
                break
        imgs = np.asarray(preprocess_clip(
            jnp.asarray(item["imgs"]), oh, ow, p["flip"], jnp.int32(p["crop_y"]),
            jnp.int32(p["crop_x"]), ch, cw, ph, pw))
        tgt = ds.clip_targets(masks, item["objects"])
        tgt["gt_mask_tubes"] = np.pad(tgt["gt_mask_tubes"],
                                      ((0, 0), (0, 0), (0, ph - ch), (0, pw - cw)))
        samples.append({"images": imgs, **tgt})
    return pad_targets(samples, 40)


@pytest.mark.parametrize("run", ["fresh", "auto_resume"])
def test_train_cli_first_batch_matches_jax_pieces(data, train_runs, run):
    out = train_runs[run]
    start = {"fresh": 0, "auto_resume": 1}[run]
    assert out["start_epoch"] == start
    assert [e["epoch"] for e in out["epochs"]] == [start]
    assert out["steps"] == 2 * (start + 1) and out["global_batch"] == 2
    assert all(np.isfinite(out["losses"])) and len(out["losses"]) == 2
    assert not any(out["launches"].values())
    got, want = out["first_batch"], _jax_first_batch(data, start)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if k == "images":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=CLIP_TOL)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    work = out["work_dir"]
    assert os.path.exists(os.path.join(work, f"epoch_{start + 1}"))
    # the dumped config reads back in both packages, to the same values
    path = os.path.join(work, "config.json")
    got_t, got_j = (m.config_to_dict(m.get_config(path)) for m in (tcfg, jcfg))
    assert _flat(got_t).items() <= _flat(got_j).items()
    assert got_t["data"]["crop_size"] == (40, 48) and got_t["data"]["data_dir"] == data[0]


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_packed_cli_trains_from_the_cache_written_like_jax(data, tmp_path):
    from openpvsg_tpu.data.packed import write_packed_cache
    from openpvsg_torch.tools import pack_train_cache, train

    root, anno = data
    out = pack_train_cache.main(["--config", "mask2former_vps", "--data-dir", root,
                                 "--anno-file", anno, "--work-dir", str(tmp_path),
                                 "--set", "data.train_scale=48,56"])
    want = str(tmp_path / "jax_cache")
    write_packed_cache(anno, root, "train", want, train_scale=(48, 56))
    for f in ("frames.bin", "masks.bin", "index.json"):
        with open(os.path.join(out, f), "rb") as a, open(os.path.join(want, f), "rb") as b:
            assert a.read() == b.read(), f
    run = train.main(_cli_args(data, str(tmp_path / "work")) + [
        "--epochs", "1", "--packed-cache", out])
    assert run["steps"] == 2 and all(np.isfinite(run["losses"]))
    assert run["first_batch"]["images"].dtype == np.uint8


@pytest.fixture(scope="module")
def ips_pair():
    """(JAX segmenter, port segmenter) on the port's random weights."""
    from openpvsg_tpu.infer.segmenter import SegmenterInference as JaxSeg
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.weights import random_state_dict, to_jax_params

    tc, jc = _cfg(tcfg).model, _cfg(jcfg).model
    state = _keep_segments(random_state_dict(tc, 3))
    return (JaxSeg(jc, to_jax_params(state, tc)),
            SegmenterInference(tc, state, device="cpu"))


def test_query_feats_by_segment_matches_jax():
    from openpvsg_tpu.models.fusion import query_feats_by_segment as jq
    from openpvsg_torch.models.fusion import query_feats_by_segment as tq

    rng = np.random.default_rng(1)
    fusion = {"query_keep": rng.random(12) < 0.6,
              "segment_id": rng.choice([3, 5, 1003, 2003], 12)}
    feats = rng.standard_normal((12, 16)).astype(np.float32)
    got, want = tq(fusion, feats), jq(fusion, feats)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("hw", [(64, 64), (50, 70)])
def test_infer_frames_ips_matches_jax(ips_pair, hw):
    jax_seg, seg = ips_pair
    rng = np.random.default_rng(hw[1])
    frames = rng.integers(0, 255, (3, *hw, 3), dtype=np.uint8)
    frames[:, 10:30, 12:40] = (250, 30, 30)
    got, want = seg.infer_frames_ips(frames), jax_seg.infer_frames_ips(frames)
    assert len(got) == len(want) == 3
    kept = 0
    for g, w in zip(got, want):
        assert g["pan_results"].shape == hw
        np.testing.assert_array_equal(g["pan_results"], w["pan_results"])
        assert g["query_feats"].keys() == w["query_feats"].keys()
        for k in w["query_feats"]:
            np.testing.assert_allclose(g["query_feats"][k], w["query_feats"][k],
                                       rtol=0, atol=FEAT_TOL)
        kept += len(w["query_feats"])
    assert kept > 0


@pytest.mark.parametrize("weights", ["train_cli_epoch_2", "random_with_segments"])
def test_test_cli_pq_vpq_match_jax(data, train_runs, tmp_path, capsys, weights):
    """The port's test CLI against JAX's SegmenterInference + frame_stats +
    pq_summary / window_vpq on the same converted weights: the checkpoint
    the train CLI wrote (its trained masks are all below 0, so every pixel
    is void), and random weights that keep segments, saved by the trainer's
    save_checkpoint."""
    from openpvsg_tpu.data.datasets import PVSGImageDataset
    from openpvsg_tpu.data.masks import decode_palette_mask, pan_mm2hb
    from openpvsg_tpu.data.pipeline import load_frame, load_mask
    from openpvsg_tpu.data.pvsg import PVSGAnnotation, frame_paths
    from openpvsg_tpu.eval.vpq import pq_summary, window_vpq
    from openpvsg_tpu.infer.segmenter import SegmenterInference as JaxSeg
    from openpvsg_torch.tools import test as test_cli
    from openpvsg_torch.train.checkpoint import load_model_state, save_checkpoint
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import random_state_dict, to_jax_params

    root, anno = data
    tc = _cfg(tcfg)
    if weights == "train_cli_epoch_2":
        ckpt = os.path.join(train_runs["auto_resume"]["work_dir"], "epoch_2")
    else:
        ckpt = str(tmp_path / "epoch_0")
        save_checkpoint(ckpt, SegmenterTrainer(
            tc.model, tc.train, device="cpu",
            state_dict=_keep_segments(random_state_dict(tc.model, 4))))
    state = load_model_state(ckpt)
    out_pkl = str(tmp_path / "results.pkl")
    got = test_cli.main(_cli_args(data, str(tmp_path / "work"), *KEEP_SETS) + [
        "--checkpoint", ckpt, "--eval", "PQ,VPQ", "--out", out_pkl, "--batch-size", "2"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == [str(got["vpq"]), str(got["pq"])]
    assert not any(got["launches"].values())  # plain versions on the CPU

    jc = _cfg(jcfg)
    jseg = JaxSeg(jc.model, to_jax_params(state, tc.model))
    ds = PVSGImageDataset(anno, root, "val")
    results = []
    for lo in range(0, len(ds), 2):
        frames = np.stack([ds[i]["img"] for i in range(lo, min(lo + 2, len(ds)))])
        results.extend(o["pan_results"] for o in jseg.infer_frames_ips(frames))
    with open(out_pkl, "rb") as f:
        for a, b in zip(pickle.load(f), results):
            np.testing.assert_array_equal(a, b)
    if weights == "random_with_segments":
        assert any((r != jc.model.num_classes).any() for r in results)
    want_pq = pq_summary(ds.frame_stats(results), 5, 3)
    want_pq.pop("per_class")
    assert got["pq"] == want_pq
    pa = PVSGAnnotation(anno)
    vid = pa.video_ids("val")[0]
    frames = np.stack([load_frame(p) for p in frame_paths(root, vid, "frames")])
    pred = []
    for lo in range(0, len(frames), 2):
        outs = jseg.infer_windows_vps(frames[lo:lo + 2], 2)
        pred.extend(pan_mm2hb(o["pan_results"], 8) for o in outs)
    gt = [decode_palette_mask(load_mask(p), pa[vid]["objects"], ds.class_index, 8)
          ["gt_panoptic_seg"] for p in frame_paths(root, vid, "masks")]
    want_vpq = window_vpq(pred, gt, 8, 5, 3, ign_id=8)
    assert got["vpq"] == dict(sorted(want_vpq.items()))


@pytest.mark.parametrize("flag", [["--dist-init"], ["--dist-coordinator", "localhost:1"],
                                  ["--n-time", "2"], ["--diff-seed"]])
def test_clis_refuse_multi_process_flags(data, tmp_path, flag, train_runs, monkeypatch):
    """The multi-process flags as the JAX tools take them: ``--dist-init``
    outside torchrun raises naming the missing variables (no hang);
    ``--dist-coordinator`` without a process count and id raises as JAX's
    ``init_distributed``; ``--n-time 2`` raises as JAX's
    ``reject_unused_n_time`` (neither tool scores relations); ``--diff-seed``
    in one process (rank 0) trains the fresh run's steps."""
    from openpvsg_torch.tools import test as test_cli, train

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    if flag == ["--diff-seed"]:
        out = train.main(_cli_args(data, str(tmp_path)) + flag + ["--epochs", "1"])
        want = train_runs["fresh"]
        assert out["losses"] == want["losses"] and out["rank"] == 0
        for k, v in want["first_batch"].items():
            np.testing.assert_array_equal(out["first_batch"][k], v, err_msg=k)
        return
    match = {"--dist-init": "MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK not set",
             "--dist-coordinator": "requires --dist-num-processes and --dist-process-id",
             "--n-time": "only meaningful for tools with a relation scoring stage"}[flag[0]]
    for main in (train.main, test_cli.main):
        with pytest.raises(SystemExit, match=match):
            main(_cli_args(data, str(tmp_path)) + flag)


def test_test_cli_ips_batch_of_two_frame_sizes_raises_as_jax(tmp_path):
    """An IPS batch that spans val videos of different frame sizes raises in
    ``np.stack``, as the JAX tool's does (a limit of the reference, kept)."""
    import json

    from openpvsg_torch.data.synthetic import make_video
    from openpvsg_torch.tools import test as test_cli

    root = str(tmp_path / "data")
    rng = np.random.default_rng(0)
    data = [make_video(root, f"100{i}_synth{i}", 2, h, w, rng)
            for i, (h, w) in enumerate(((64, 64), (48, 80)))]
    anno = os.path.join(root, "pvsg.json")
    with open(anno, "w") as f:
        json.dump({"objects": {"thing": ["person", "dog", "cat", "ball", "cup"],
                               "stuff": ["floor", "wall", "table"]},
                   "relations": ["on"], "data": data,
                   "split": {"vidor": {"train": [], "val": [d["video_id"] for d in data]},
                             "epic_kitchen": {"train": [], "val": []},
                             "ego4d": {"train": [], "val": []}}}, f)
    with pytest.raises(ValueError, match="same shape"):
        test_cli.main(_cli_args((root, anno), str(tmp_path / "work"))
                      + ["--batch-size", "4"])
