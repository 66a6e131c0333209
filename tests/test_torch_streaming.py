"""The port's serving path against the JAX package on the CPU:
``SegmenterInference.infer_window_vps`` and ``StreamingPVSG`` (both history
backends, bounded and unbounded history) on the same weights and frames, at
the shapes of tests/test_streaming.py (R-26, 8 queries, 1 encoder layer, 2
decoder layers, 64x64 frames; the relation head at the stage-2 features'
256 channels with 2 heads and FFN 64).

Weights: the port's random weights from a seed, with random BN statistics
(so folding the BN is not the identity) and the void logit pushed down (so
segments are kept), carried to the JAX package by ``to_jax_params`` and
``relation_to_jax_params``. The JAX side runs its default (unfused) FPN
chain and fusion, the plain references of its Pallas kernels.

Tolerances:
- ``pan_results``, frame ids, tube ids, classes and the tube summary:
  equal;
- ``query_feats`` and the returned embeddings: 1e-5 of their scale;
- emitted triplets: equal wherever adjacent scores are more than 1e-4
  apart (``streaming.triplets_agree``: entries whose probabilities are
  closer than that may come in either order; the scores are the port's
  device backend's at the same scoring). The relation head's outputs differ
  from JAX's by ~1e-6 on these inputs.

With a history bound, the port's ring ages a tube out when none of its
detections is retained, as both packages' host backends do; the JAX ring
keeps it one window longer, so there the port's ring is held to JAX's host
backend.
"""
import jax
import numpy as np
import pytest
import torch

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

H = W = 64
N_FRAMES = 20
RANK_TOL = 1e-4
FEAT_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One torch thread for this module: its many small CPU ops only wait
    on a thread pool when the suite's workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

def _tiny(m):
    return m.Mask2FormerConfig(
        num_things_classes=3, num_stuff_classes=2, num_queries=8,
        backbone=m.BackboneConfig(depth=26),
        pixel_decoder=m.PixelDecoderConfig(encoder_layers=1, ffn_channels=32),
        decoder=m.TransformerDecoderConfig(num_layers=2, ffn_channels=32),
        object_mask_thr=0.01, iou_thr=0.1)


def _rel_cfg(m):
    return m.RelationHeadConfig(encoder_heads=2, encoder_ffn=64,
                                temporal_heads=2, temporal_ffn=64)


def _frames(n, seed):
    """Random frames with two moving blocks and a floor, so segments
    persist across windows."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (n, H, W, 3)).astype(np.uint8)
    for t in range(n):
        x = (3 * t) % 40
        frames[t, 8:24, x:x + 16] = [250, 30, 30]
        frames[t, 30:44, 40 - x // 2:56 - x // 2] = [30, 30, 250]
        frames[t, 48:] = [30, 250, 30]
    return frames


@pytest.fixture(scope="module")
def parts():
    """The JAX and port segmenters and relation models on the same
    weights."""
    from openpvsg_tpu.infer.segmenter import SegmenterInference as JaxSeg
    from openpvsg_tpu.models.relation.heads import RelationModel as JaxRel
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.weights import (random_relation_state_dict,
                                        random_state_dict, relation_to_jax_params,
                                        to_jax_params)

    state = random_state_dict(_tiny(tcfg), 0)
    rng = np.random.default_rng(2)
    for k, v in state.items():
        if k.endswith("running_var"):
            state[k] = torch.from_numpy((1.0 + rng.random(v.shape)).astype(np.float32))
        elif k.endswith("running_mean"):
            state[k] = torch.from_numpy((0.1 * rng.standard_normal(v.shape)).astype(np.float32))
    state["head.cls_embed.bias"][-1] -= 4.0
    rel_state = random_relation_state_dict(_rel_cfg(tcfg), 3)
    rel = RelationModel.from_config(_rel_cfg(tcfg))
    rel.load_state_dict(rel_state)
    return {"jax_seg": JaxSeg(_tiny(jcfg), to_jax_params(state, _tiny(tcfg))),
            "seg": SegmenterInference(_tiny(tcfg), state, device="cpu"),
            "jax_rel": JaxRel.from_config(_rel_cfg(jcfg)),
            "jax_rel_params": jax.tree_util.tree_map(
                np.asarray, relation_to_jax_params(rel_state, _rel_cfg(tcfg))),
            "rel": rel.eval()}


def _assert_feats_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k], w, atol=FEAT_TOL * scale, rtol=0)


@pytest.mark.parametrize("chained", [False, True])
def test_infer_window_vps_matches_jax(parts, chained):
    """One window (3 frames) with and without the previous window's
    embeddings: pan_results equal, query features and the returned
    embeddings within 1e-5 of their scale."""
    frames = _frames(5, seed=7)
    prev = {}
    if chained:
        _, prev["jax"] = parts["jax_seg"].infer_window_vps(frames[:2], return_embds=True)
        _, prev["port"] = parts["seg"].infer_window_vps(frames[:2], return_embds=True)
        scale = max(1.0, float(np.abs(prev["jax"]).max()))
        np.testing.assert_allclose(prev["port"], prev["jax"], atol=FEAT_TOL * scale, rtol=0)
    want, want_e = parts["jax_seg"].infer_window_vps(
        frames[2:], prev_embds=prev.get("jax"), return_embds=True)
    got, got_e = parts["seg"].infer_window_vps(
        frames[2:], prev_embds=prev.get("port"), return_embds=True)
    assert len(got) == len(want) == 3
    kept = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["pan_results"], np.asarray(w["pan_results"]))
        _assert_feats_close(g["query_feats"], w["query_feats"])
        kept += len(w["query_feats"])
    assert kept > 0
    scale = max(1.0, float(np.abs(want_e).max()))
    np.testing.assert_allclose(got_e, np.asarray(want_e), atol=FEAT_TOL * scale, rtol=0)


def _run(engine, frames):
    """Every window's result and finish()'s summary, with the port device
    backend's scores of each scoring (None elsewhere)."""
    windows, scores = [], []
    for f in frames:
        r = engine.push(f)
        if r is not None:
            windows.append(r)
            scores.append(getattr(engine, "last_scores", None)
                          if r["triplets"] is not None else None)
    final = engine.finish()
    scores.append(getattr(engine, "last_scores", None))
    return {"windows": windows, "final": final, "scores": scores}


@pytest.fixture(scope="module")
def streams(parts):
    """stream(package, max_history, device_history): one stream's results,
    computed once per module."""
    cache = {}

    def stream(package, max_history, device_history):
        key = (package, max_history, device_history)
        if key not in cache:
            kw = dict(window=2, relation_interval=4, num_top_pairs=5,
                      max_history=max_history, device_history=device_history)
            if package == "jax":
                from openpvsg_tpu.infer.streaming import StreamingPVSG as JaxStreaming

                engine = JaxStreaming(parts["jax_seg"], parts["jax_rel"],
                                      parts["jax_rel_params"], **kw)
            else:
                from openpvsg_torch.infer.streaming import StreamingPVSG

                engine = StreamingPVSG(parts["seg"], parts["rel"], **kw)
            cache[key] = _run(engine, _frames(N_FRAMES, seed=3))
        return cache[key]

    return stream


def _assert_streams_agree(got, want, scores):
    from openpvsg_torch.infer.streaming import triplets_agree

    assert len(got["windows"]) == len(want["windows"]) == N_FRAMES // 2
    fired = 0
    for i, (g, w) in enumerate(zip(got["windows"], want["windows"])):
        assert g["frames"] == w["frames"]
        for a, b in zip(g["pan_results"], w["pan_results"]):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert (g["triplets"] is None) == (w["triplets"] is None), i
        if w["triplets"] is not None:
            fired += 1
            assert triplets_agree(g["triplets"], w["triplets"], scores[i], RANK_TOL), i
    assert fired >= 3
    gf, wf = got["final"], want["final"]
    assert {k: gf[k] for k in ("num_frames", "num_tubes", "tube_classes")} == \
        {k: wf[k] for k in ("num_frames", "num_tubes", "tube_classes")}
    assert gf["num_frames"] == N_FRAMES and gf["triplets"]
    assert triplets_agree(gf["triplets"], wf["triplets"], scores[-1], RANK_TOL)


@pytest.mark.parametrize("device_history", [True, False])
@pytest.mark.parametrize("max_history", [None, 8])
def test_streaming_matches_jax(streams, max_history, device_history):
    """Per-window pan_results and frame ids, every emitted triplet list and
    finish()'s summary against the JAX engine with the same backend."""
    got = streams("port", max_history, device_history)
    want = streams("jax", max_history, device_history)
    scores = streams("port", max_history, True)["scores"]
    if device_history and max_history is not None:
        # JAX's ring dates a tube's last detection to the end of its window,
        # so a tube seen only in a window's first frame keeps its slot, on
        # zero features, one window after the host backend dropped it
        # (ROADMAP.md C): on this stream JAX's two backends differ, and the
        # port's ring is held to JAX's host backend, the documented result
        host = streams("jax", max_history, False)
        assert any(w["triplets"] != h["triplets"]
                   for w, h in zip(want["windows"], host["windows"]))
        want = host
    _assert_streams_agree(got, want, scores)


@pytest.mark.parametrize("max_history", [None, 8])
def test_streaming_device_host_parity(streams, max_history):
    """The port's ring emits what its host backend emits, at every scoring
    (tests/test_streaming.py:143 holds the JAX package to the same)."""
    dev = streams("port", max_history, True)
    host = streams("port", max_history, False)
    _assert_streams_agree(host, dev, dev["scores"])


@pytest.mark.parametrize("device_history", [False, True])
def test_streaming_bounded_history(parts, device_history):
    """tests/test_streaming.py:96's invariants on the port: with a bound of
    8 frames over 40, stored features never exceed the window, each live
    tube owns one slot, spans come back in absolute frame ids inside the
    retained window, and the tube summary counts aged-out tubes."""
    from openpvsg_torch.infer.streaming import StreamingPVSG

    K = 8
    engine = StreamingPVSG(parts["seg"], parts["rel"], window=2,
                           relation_interval=4, num_top_pairs=5,
                           max_history=K, device_history=device_history)
    last_fired = None
    for f in _frames(40, seed=2):
        r = engine.push(f)
        if device_history:
            ring = engine._ring
            assert ring.t_valid <= ring.C == K
            assert ring.lo >= engine._frame_id - K
            assert sorted(ring._slot_of.values()) == sorted(ring._tid_of)
            assert ring.hist.shape == (ring.S, K, 256)
            # aged-out slots hold zeros: a reused slot never leaks features
            free = [s for s in range(ring.S) if s not in ring._tid_of]
            assert not ring.hist[free].any()
        else:
            for d in engine._tubes.values():
                assert len(d) <= K
                assert all(f_id >= engine._frame_id - K for f_id in d)
        if r is not None and r["triplets"]:
            last_fired = (engine._frame_id, r["triplets"])
    assert last_fired is not None, "relation refresh never fired"
    t_at, triplets = last_fired
    for t in triplets:
        if t["span"] is not None:
            assert t_at - K <= t["span"][0] <= t["span"][1] < t_at
    final = engine.finish()
    assert final["num_frames"] == 40
    assert final["num_tubes"] >= len(
        engine._ring.live_tids() if device_history else engine._tubes)


def test_streaming_tail_window_and_history_bound(parts):
    """A partial tail window is padded by repeating its last frame; a bound
    below the window raises the JAX engine's ValueError."""
    from openpvsg_torch.infer.streaming import StreamingPVSG

    engine = StreamingPVSG(parts["seg"], None, window=2)
    for f in _frames(3, seed=1):
        engine.push(f)
    final = engine.finish()
    assert final["num_frames"] == 4 and final["triplets"] == []
    with pytest.raises(ValueError, match=r"max_history \(1\) must be >= window \(2\)"):
        StreamingPVSG(parts["seg"], parts["rel"], window=2, max_history=1)


def test_device_ring_grows_slots_and_capacity(parts):
    """The ring's slot rows grow through SLOT_BUCKETS with zero padding and
    its unbounded capacity doubles from max(128 // window, 1) * window,
    keeping every column it held."""
    from openpvsg_torch.infer.streaming import SLOT_BUCKETS, _DeviceRing

    ring = _DeviceRing(parts["rel"], window=4, feat_dim=8, max_history=None,
                       num_top_pairs=5, device=torch.device("cpu"))
    assert (ring.S, ring.C) == (SLOT_BUCKETS[0], 128)
    rng = np.random.default_rng(0)
    written = {}
    for w in range(40):  # 160 frames: the capacity doubles once
        feats = {tid: [(o, rng.standard_normal(8).astype(np.float32)) for o in range(4)]
                 for tid in range(1 + w, 1 + w + 3)}
        ring.update(feats, 4 * (w + 1))
        for tid, entries in feats.items():
            for o, f in entries:
                written[(tid, 4 * w + o)] = f
    assert ring.C == 256 and ring.t_valid == 160 and ring.lo == 0
    assert ring.S == 50  # 42 tubes: grown past 20 to the next bucket
    hist = ring.hist.numpy()
    for (tid, frame), f in written.items():
        np.testing.assert_array_equal(hist[ring._slot_of[tid], frame], f)
    assert not hist[:, 160:].any()
