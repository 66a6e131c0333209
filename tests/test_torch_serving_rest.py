"""The serving and config remainder of the PyTorch port against the JAX
package on the CPU: ``cosine_warmup_schedule``, ``instance_postprocess``,
``run_query_tube_vps``'s ``windows_per_batch``, the config fields that
select nothing (``fused_fpn``, ``max_per_image``, ``filter_low_score``,
``embed_no_decay``), the relation mAP harness ``eval/metric.py`` and
``utils/profiling.py``.

Tolerances: the schedule 1e-6 relative at every step (float32 cosines of
two libraries); instance labels and masks equal, scores 1e-6 with the
margin between consecutive kept scores shown to exceed it; ``masks.txt``
byte-identical and ``query_feats.pickle`` equal in content (features
1e-4, tests/test_torch_stage2.py's bound); the harness's mAP and recalls
1e-12.
"""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

from test_torch_stage2 import _tiny

H, W, FRAMES = 64, 64, 10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# cosine_warmup_schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(1e-3, 1e-7, 2, 10, 5), (1e-4, 0.0, 0, 3, 4),
                                  (5e-4, 5e-5, 1, 2, 3)])
def test_cosine_warmup_schedule_matches_optax(args):
    """Every step of a short schedule and past its end, against optax's
    values for the int32 step counts the JAX trainer's optimizer passes."""
    from openpvsg_tpu.train.segmenter import cosine_warmup_schedule as jax_sched
    from openpvsg_torch.train.segmenter import cosine_warmup_schedule

    want, got = jax_sched(*args), cosine_warmup_schedule(*args)
    total = max(args[3] * args[4], 2)
    for count in range(total + 5):
        g = got(count)
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.float32(want(jnp.int32(count))),
                                   rtol=1e-6, err_msg=str(count))


# ---------------------------------------------------------------------------
# instance_postprocess
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["untied", "tied"])
def test_instance_postprocess_matches_jax(case):
    """Labels, scores and masks of the top-k things. 'tied' repeats
    queries and classes so that many scores are exactly equal: the order
    among them is ``lax.top_k``'s (lower flat index first)."""
    from openpvsg_tpu.models.fusion import instance_postprocess as jax_post
    from openpvsg_torch.models.fusion import instance_postprocess

    rng = np.random.default_rng(4)
    Q, K, things = 12, 7, 4
    cls = rng.standard_normal((Q, K + 1)).astype(np.float32)
    masks = rng.standard_normal((Q, 16, 20)).astype(np.float32)
    if case == "tied":
        cls[6:] = cls[:6]          # equal queries
        cls[:, 2] = cls[:, 1]      # equal classes within a query
    for k in (5, 30, Q * K):
        want = jax_post(cls, masks, things, max_per_image=k)
        got = instance_postprocess(torch.from_numpy(cls), torch.from_numpy(masks),
                                   things, max_per_image=k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got[2], want[2])
        assert got[0].dtype.kind == "i" and got[2].dtype == bool
    # the order of unequal scores cannot turn on a 1e-6 difference
    scores = np.sort(np.asarray(jax.nn.softmax(cls, -1))[:, :-1].ravel())
    gaps = np.diff(scores)
    assert gaps[gaps > 0].min() > 2e-6 * scores.max()
    if case == "tied":
        assert (gaps == 0).sum() >= Q * K // 2


# ---------------------------------------------------------------------------
# windows_per_batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def segmenters():
    """tests/test_torch_stage2.py's (JAX segmenter, port segmenter), the JAX
    one on its default unfused chain."""
    from openpvsg_tpu.infer.segmenter import SegmenterInference as JaxSeg
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.weights import from_jax_params

    variables = jax.jit(JaxM2F(_tiny(jcfg)).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, H, W, 3)))
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.default_rng(2)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: ((1.0 + rng.random(v.shape)) if path[-1].key == "var"
                         else 0.1 * rng.standard_normal(v.shape)).astype(np.float32),
        variables["batch_stats"])
    params = variables["params"]
    params["head"]["cls_embed"]["bias"][-1] -= 4.0
    variables = {"params": params, "batch_stats": stats}
    return (JaxSeg(_tiny(jcfg), variables), variables,
            SegmenterInference(_tiny(tcfg), from_jax_params(variables, _tiny(tcfg)),
                               device="cpu"))


@pytest.fixture(scope="module")
def frame_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("wpb_frames")
    rng = np.random.default_rng(0)
    paths = []
    for t in range(FRAMES):
        img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        img[8:24, 8 + 2 * t:24 + 2 * t] = [250, 30, 30]
        img[40:56, 40 - 2 * t:56 - 2 * t] = [30, 30, 250]
        img[56:, :] = [30, 250, 30]
        paths.append(str(root / f"{t:04d}.png"))
        Image.fromarray(img).save(paths[-1])
    return paths


def _outputs(root):
    with open(os.path.join(root, "quantitive", "masks.txt"), "rb") as f:
        txt = f.read()
    with open(os.path.join(root, "query_feats.pickle"), "rb") as f:
        return txt, pickle.load(f)


def _same_tubes(got, want):
    assert [t.track_id for t in got] == [t.track_id for t in want]
    for gt, wt in zip(got, want):
        assert len(gt.qf_tube) == len(wt.qf_tube) == FRAMES
        for g, w in zip(gt.qf_tube, wt.qf_tube):
            assert (g is None) == (w is None)
            if g is not None:
                assert g["cls_id"] == w["cls_id"]
                np.testing.assert_allclose(g["query_feat"], w["query_feat"],
                                           atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("chain", [False, True])
def test_windows_per_batch_match_serial_and_jax(segmenters, frame_files, tmp_path,
                                                chain):
    """10 frames in windows of 2 at 1, 2 and 4 windows per forward (4: a
    batch of 8 frames, then a ragged one of 2), at pipeline depths 2 and
    1: ``masks.txt`` byte-identical to the serial run's and to JAX's
    ``run_query_tube_vps(..., windows_per_batch=4)``; the pickles equal the
    serial run's in tube and class ids with features within 1e-5 (JAX's
    own contract, tests/test_parallel.py:244-260: a batched GEMM may add in
    another order), and JAX's in content."""
    from openpvsg_tpu.infer import stages as jax_stages
    from openpvsg_torch.infer import stages

    jax_seg, _, seg = segmenters
    jax_stages.run_query_tube_vps(jax_seg, frame_files, str(tmp_path / "jax"),
                                  window=2, chain_windows=chain,
                                  windows_per_batch=4)
    want_txt, want_tubes = _outputs(str(tmp_path / "jax"))
    assert len(want_txt.splitlines()) >= FRAMES, "too few kept segments"
    runs = {}
    for wpb, depth in ((1, 2), (2, 2), (4, 2), (4, 1)):
        root = str(tmp_path / f"torch_{wpb}_{depth}")
        stages.run_query_tube_vps(seg, frame_files, root, window=2,
                                  chain_windows=chain, pipeline_depth=depth,
                                  windows_per_batch=wpb)
        runs[wpb, depth] = _outputs(root)
    serial_txt, serial_tubes = runs[1, 2]
    assert serial_txt == want_txt
    _same_tubes(serial_tubes, want_tubes)
    for (txt, tubes) in runs.values():
        assert txt == serial_txt
        assert [t.track_id for t in tubes] == [t.track_id for t in serial_tubes]
        for a, b in zip(tubes, serial_tubes):
            for x, y in zip(a.qf_tube, b.qf_tube):
                assert (x is None) == (y is None)
                if x is not None:
                    assert x["cls_id"] == y["cls_id"]
                    np.testing.assert_allclose(x["query_feat"], y["query_feat"],
                                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the config fields that select nothing
# ---------------------------------------------------------------------------

def test_config_fields_load_and_change_nothing(segmenters, tmp_path):
    """A JAX ``config.json`` with ``fused_fpn`` True, ``max_per_image`` 50,
    ``filter_low_score`` False, ``embed_no_decay`` False, ``int8_weights``
    True and other pixel-decoder ``strides`` loads into the port with those
    values (the port has every field of the JAX schema), and a segmenter
    (with ``int8_weights`` turned off, the one field here that selects
    something: the int8 segmenter is held to JAX's in
    tests/test_torch_remainder.py) and a trainer built from it give the
    defaults' outputs bit for bit."""
    import dataclasses

    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.train.segmenter import SegmenterTrainer, param_groups
    from openpvsg_torch.weights import from_jax_params

    assert not hasattr(tcfg, "JAX_ONLY_FIELDS")
    jm = dataclasses.replace(
        _tiny(jcfg), max_per_image=50, filter_low_score=False, int8_weights=True,
        pixel_decoder=dataclasses.replace(_tiny(jcfg).pixel_decoder, fused_fpn=True,
                                          strides=(8, 16, 32, 64)))
    path = str(tmp_path / "config.json")
    jcfg.save_config(jcfg.PVSGConfig(
        model=jm, train=dataclasses.replace(jcfg.TrainConfig(), embed_no_decay=False)),
        path)
    cfg = tcfg.load_config_file(path)
    assert cfg.model.pixel_decoder.fused_fpn and cfg.model.max_per_image == 50
    assert not cfg.model.filter_low_score and not cfg.train.embed_no_decay
    assert cfg.model.int8_weights and cfg.model.pixel_decoder.strides == (8, 16, 32, 64)
    _, variables, seg = segmenters
    state = from_jax_params(variables, cfg.model)
    assert SegmenterInference(cfg.model, state, device="cpu").int8_weights
    other = SegmenterInference(cfg.model, state, device="cpu", int8_weights=False)
    frames = np.random.default_rng(1).integers(0, 255, (3, H, W, 3), dtype=np.uint8)
    for a, b in zip(seg.forward_frames(frames), other.forward_frames(frames)):
        assert torch.equal(a, b)
    groups = [param_groups(SegmenterTrainer(m, t, device="cpu").model, t)
              for m, t in ((_tiny(tcfg), tcfg.TrainConfig()), (cfg.model, cfg.train))]
    assert ([(g["label"], g["weight_decay"], len(g["params"])) for g in groups[0]]
            == [(g["label"], g["weight_decay"], len(g["params"])) for g in groups[1]])


# ---------------------------------------------------------------------------
# eval/metric.py
# ---------------------------------------------------------------------------

def _random_results(rng, n_videos=5):
    """GT and predicted ``Result``s of random mask tubes and triplets: each
    prediction copies, jitters or invents GT relations, with random
    scores, so hits, misses and ties of classes all occur."""
    out = []
    for v in range(n_videos):
        T, h, w = int(rng.integers(4, 9)), 12, 16
        gt_tubes = {i: rng.random((T, h, w)) < 0.3 for i in range(1, 5)}
        pred_tubes = {10 + i: np.where(rng.random((T, h, w)) < 0.1, ~m, m)
                      for i, m in gt_tubes.items()}
        pred_tubes[99] = rng.random((T, h, w)) < 0.3

        def dur():
            a = int(rng.integers(1, T + 1))
            return [[a, int(rng.integers(a, T + 1))]]

        gt_rel = [{"triplet": ((s, int(rng.integers(0, 3))), (o, int(rng.integers(0, 3))),
                               int(rng.integers(0, 4))), "durs": dur()}
                  for s, o in rng.integers(1, 5, (int(rng.integers(0, 6)), 2))]
        pred_rel = []
        for g in gt_rel:
            (s, sc), (o, oc), r = g["triplet"]
            for _ in range(int(rng.integers(0, 3))):
                pred_rel.append({"triplet": ((10 + s, sc), (10 + o, oc), r),
                                 "durs": g["durs"] if rng.random() < 0.6 else dur(),
                                 "score": float(rng.random())})
        for _ in range(int(rng.integers(0, 8))):
            pred_rel.append({"triplet": ((int(rng.choice([11, 12, 99])), int(rng.integers(0, 3))),
                                         (int(rng.choice([13, 14, 99])), int(rng.integers(0, 3))),
                                         int(rng.integers(0, 4))),
                             "durs": dur(), "score": float(rng.random())})
        out.append((f"v{v}", gt_tubes, gt_rel, pred_tubes, pred_rel))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_harness_matches_jax(seed):
    from openpvsg_tpu.eval import metric as jm
    from openpvsg_torch.eval import metric as tm

    data = _random_results(np.random.default_rng(seed))
    res = {}
    for m in (jm, tm):
        gts = [m.Result(vid=v, seg_masks=g, relations=gr) for v, g, gr, _, _ in data]
        preds = [m.Result(vid=v, seg_masks=p, relations=pr) for v, _, _, p, pr in data]
        res[m] = m.evaluate(gts, preds, viou_threshold=0.3)
    (map_j, rec_j), (map_t, rec_t) = res[jm], res[tm]
    assert rec_t.keys() == rec_j.keys() == {10, 20, 50}
    np.testing.assert_allclose(map_t, map_j, rtol=0, atol=1e-12)
    for k in rec_j:
        np.testing.assert_allclose(rec_t[k], rec_j[k], rtol=0, atol=1e-12)
    assert 0 < map_t < 1 and any(0 < r < 1 for r in rec_t.values())
    for v, g, gr, p, pr in data[:2]:
        got = tm.eval_relations_of_single_video(tm.Result(vid=v, seg_masks=g, relations=gr),
                                                tm.Result(vid=v, seg_masks=p, relations=pr))
        want = jm.eval_relations_of_single_video(jm.Result(vid=v, seg_masks=g, relations=gr),
                                                 jm.Result(vid=v, seg_masks=p, relations=pr))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_metric_harness_cases():
    """tests/test_aux.py's cases on the port's copy, plus ``voc_ap``'s 2007
    11-point rule and ``relation_indicator``."""
    from openpvsg_tpu.eval import metric as jm
    from openpvsg_torch.eval.metric import (Result, evaluate, relation_indicator,
                                            viou_over_whole_length_video, voc_ap)

    T, h, w = 4, 8, 8
    tube_a = np.zeros((T, h, w), bool)
    tube_a[:, :4] = True
    tube_b = np.zeros((T, h, w), bool)
    tube_b[:, 4:] = True
    gt = Result(vid="v", seg_masks={1: tube_a, 2: tube_b},
                relations=[{"triplet": ((1, 0), (2, 3), 5), "durs": [[1, 4]]}])
    good = Result(vid="v", seg_masks={10: tube_a, 20: tube_b},
                  relations=[{"triplet": ((10, 0), (20, 3), 5), "durs": [[1, 4]],
                              "score": 0.9}])
    mean_ap, rec = evaluate([gt], [good], viou_threshold=0.5)
    assert mean_ap == pytest.approx(1.0) and rec[10] == pytest.approx(1.0)
    bad = Result(vid="v", seg_masks={10: tube_b},
                 relations=[{"triplet": ((10, 0), (10, 3), 5), "durs": [[1, 4]],
                             "score": 0.9}])
    assert evaluate([gt], [bad], viou_threshold=0.5)[0] == 0.0
    assert gt.vid == "v" and gt.seg_masks[1] is tube_a
    np.testing.assert_array_equal(relation_indicator(6, [[2, 3], [5, 5]]),
                                  [False, True, True, False, True, False])
    assert viou_over_whole_length_video(tube_a, [[1, 2]], tube_a, [[2, 4]]) == \
        jm.viou_over_whole_length_video(tube_a, [[1, 2]], tube_a, [[2, 4]]) == 0.25
    rec_, prec = np.array([0.2, 0.5, 0.5, 1.0]), np.array([1.0, 0.8, 0.6, 0.5])
    for use_07 in (False, True):
        assert voc_ap(rec_, prec, use_07) == jm.voc_ap(rec_, prec, use_07)


# ---------------------------------------------------------------------------
# utils/profiling.py
# ---------------------------------------------------------------------------

def test_profiling_surfaces(tmp_path):
    from openpvsg_torch.utils.profiling import RECORDER, Recorder, Timer, trace

    t = Timer()
    for _ in range(3):
        t.tic()
        t.toc()
    assert t.calls == 3 and t.diff >= 0
    assert t.average_time == pytest.approx(t.total_time / 3)
    assert t.toc(average=False) == t.diff
    t.clear()
    assert t.calls == 0 and t.total_time == 0.0
    rec = Recorder()
    with rec.span("a"):
        rec.count("n")
        rec.copy(torch.device("cpu"), 8)
    assert rec.snapshot() == {"spans": [], "counters": {}}    # no profiler running
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for name in ("a", "b", "a"):
            with rec.span(name):
                pass
        request = rec.begin_request()
        rec.batch = 2
        with rec.span("b"):
            rec.count("n")
            rec.count("n", 4)
            rec.copy(torch.device("cpu"), 12)
        rec.end_request()
    snap = rec.snapshot()
    assert [s[0] for s in snap["spans"]] == ["a", "b", "a", "b"]
    assert [s[3:] for s in snap["spans"]] == [(-1, -1)] * 3 + [(request, 2)]
    assert all(s[1] <= s[2] for s in snap["spans"])
    assert snap["counters"] == {"n": 5, "copies": 1, "copy_bytes": 12, "copies_drained": 1}
    totals = rec.totals()
    assert totals["a"]["calls"] == 2 and totals["b"]["calls"] == 2
    assert totals["a"]["total_s"] == pytest.approx(
        sum(s[2] - s[1] for s in snap["spans"] if s[0] == "a") * 1e-9)
    assert rec.begin_request() == request + 1
    rec.reset()
    assert rec.snapshot() == {"spans": [], "counters": {}}
    with trace(None):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        RECORDER.count("before")                  # trace() starts from nothing
    log_dir = str(tmp_path / "trace")
    with trace(log_dir):
        with RECORDER.span("mm"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        RECORDER.count("n")
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        text = f.read()
    assert '"traceEvents"' in text and "aten::mm" in text and "openpvsg.mm" in text
    with open(os.path.join(log_dir, "spans.json")) as f:
        spans = json.load(f)
    assert [s[0] for s in spans["spans"]] == ["mm"] and spans["counters"] == {"n": 1}
    RECORDER.reset()


def test_vps_cli_traces_the_first_video(tmp_path):
    """``prepare_query_tube_vps --trace-dir`` traces the first video alone:
    its trace and spans files, and the summary's spans and counters, with
    the second video's outputs written untraced."""
    from openpvsg_torch.tools import make_synthetic_data, prepare_query_tube_vps

    data, work, traced = (str(tmp_path / d) for d in ("data", "work", "traced"))
    anno = make_synthetic_data.main(["--out", data, "--train-videos", "0",
                                     "--val-videos", "2", "--frames", "4",
                                     "--size", "32", "32"])
    summary = prepare_query_tube_vps.main([
        "--config", "mask2former_vps", "--data-dir", data, "--anno-file", anno,
        "--work-dir", work, "--split", "val", "--device", "cpu", "--trace-dir", traced,
        "--set", "model.backbone.depth=26", "model.num_queries=8",
        "model.num_things_classes=5", "model.num_stuff_classes=3",
        "model.decoder.num_layers=1", "model.decoder.ffn_channels=32",
        "model.pixel_decoder.encoder_layers=1", "model.pixel_decoder.ffn_channels=32",
        "model.object_mask_thr=0.0"])
    assert summary["videos"] == 2 and summary["frames"] == 8
    with open(os.path.join(traced, "spans.json")) as f:
        spans = json.load(f)
    assert {s[3] for s in spans["spans"]} == {spans["spans"][0][3]}    # one video
    assert spans["counters"] == summary["counters"]
    assert summary["counters"]["frames"] == 4 and summary["counters"]["batches"] == 2
    assert summary["spans"]["segmenter.fetch"]["calls"] == 10
    assert summary["spans"]["stages.write_tubes"]["calls"] == 1
    assert os.path.exists(os.path.join(traced, "trace.json"))
    assert len(os.listdir(os.path.join(work, "val_save_qf"))) >= 2
