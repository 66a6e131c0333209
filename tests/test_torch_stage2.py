"""The port's main path against the JAX package on the CPU: the full
forward (forward_frames) and VPS stage 2 (run_query_tube_vps) on the same
weights (flax init -> from_jax_params) and the same frames.

The JAX side runs SegmenterInference(fused_fpn=True), which reaches the
Pallas FPN kernel in interpret mode, as tests/test_fpn_kernel.py does.
Tolerances: cls 1e-4, masks 1e-3, query 1e-4 — the bounds that
tests/test_fpn_kernel.py:82-87 holds the Pallas path to.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

H, W, T_FRAMES = 64, 64, 6


def _tiny(m):
    """The tiny_model_cfg of tests/test_end2end.py, from either package."""
    return m.Mask2FormerConfig(
        num_things_classes=3, num_stuff_classes=2, num_queries=8,
        backbone=m.BackboneConfig(depth=26),
        pixel_decoder=m.PixelDecoderConfig(encoder_layers=1, ffn_channels=64),
        decoder=m.TransformerDecoderConfig(num_layers=3, ffn_channels=64),
        object_mask_thr=0.01, iou_thr=0.1)


@pytest.fixture(scope="module")
def segmenters():
    """(JAX segmenter, port segmenter) on the same weights; BN statistics
    are randomized so folding the BN into the convs is not the identity."""
    from openpvsg_tpu.infer.segmenter import SegmenterInference as JaxSeg
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.weights import from_jax_params

    variables = jax.jit(JaxM2F(_tiny(jcfg)).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, H, W, 3)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(2)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: ((1.0 + rng.random(v.shape)) if path[-1].key == "var"
                         else 0.1 * rng.standard_normal(v.shape)).astype(np.float32),
        variables["batch_stats"])
    # a flax init predicts the void class for every query, so nothing would
    # be kept: push the void logit down so fusion and RLE do real work
    params = jax.tree_util.tree_map(np.array, variables["params"])
    params["head"]["cls_embed"]["bias"][-1] -= 4.0
    variables = {"params": params, "batch_stats": stats}
    jax_seg = JaxSeg(_tiny(jcfg), variables, fused_fpn=True)
    assert jax_seg.cfg.pixel_decoder.fused_fpn
    seg = SegmenterInference(_tiny(tcfg), from_jax_params(variables, _tiny(tcfg)),
                             device="cpu")
    assert seg.cfg.backbone.norm == "folded"
    return jax_seg, seg


@pytest.fixture(scope="module")
def frame_files(tmp_path_factory):
    """Moving-block PNG frames, drawn as tests/test_end2end.py:41-49 does."""
    root = tmp_path_factory.mktemp("torch_frames")
    rng = np.random.default_rng(0)
    paths = []
    for t in range(T_FRAMES):
        img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        img[8:24, 8 + 2 * t:24 + 2 * t] = [250, 30, 30]
        img[48:, :] = [30, 250, 30]
        paths.append(str(root / f"{t:04d}.png"))
        Image.fromarray(img).save(paths[-1])
    return paths


def test_forward_frames_matches_jax(segmenters, rng):
    jax_seg, seg = segmenters
    frames = rng.integers(0, 255, (2, H, W, 3)).astype(np.uint8)
    want = jax_seg.forward_frames(frames)
    got = seg.forward_frames(frames)
    assert got[0].shape == (2, 8, 6) and got[1].shape == (2, 8, H // 4, W // 4)
    assert got[2].shape == (2, 8, 256)
    for g, w, tol in zip(got, want, (1e-4, 1e-3, 1e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, rtol=tol)


def _read_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("chain", [False, True])
def test_stage2_vps_matches_jax(segmenters, frame_files, tmp_path, chain):
    """run_query_tube_vps, port against JAX on the same weights and PNG
    frames: masks.txt byte-identical; query_feats.pickle equal in content
    (track ids and class ids exact, features within 1e-4). The pickles
    cannot be byte-equal: the tube class lives in another package."""
    from openpvsg_tpu.infer import stages as jax_stages
    from openpvsg_torch.infer import stages

    jax_seg, seg = segmenters
    n_jax = jax_stages.run_query_tube_vps(jax_seg, frame_files,
                                          str(tmp_path / "jax"), window=2,
                                          chain_windows=chain)
    n = stages.run_query_tube_vps(seg, frame_files, str(tmp_path / "torch"),
                                  window=2, chain_windows=chain)
    with open(tmp_path / "jax" / "quantitive" / "masks.txt", "rb") as f:
        want_txt = f.read()
    with open(tmp_path / "torch" / "quantitive" / "masks.txt", "rb") as f:
        got_txt = f.read()
    assert len(want_txt.splitlines()) >= T_FRAMES, "too few kept segments"
    assert got_txt == want_txt
    assert n == n_jax
    want = _read_pickle(tmp_path / "jax" / "query_feats.pickle")
    got = _read_pickle(tmp_path / "torch" / "query_feats.pickle")
    assert type(got[0]).__module__ == "openpvsg_torch.tracker.tubes"
    assert [t.track_id for t in got] == [t.track_id for t in want]
    for gt, wt in zip(got, want):
        assert len(gt.qf_tube) == len(wt.qf_tube) == T_FRAMES
        for g, w in zip(gt.qf_tube, wt.qf_tube):
            assert (g is None) == (w is None)
            if g is not None:
                assert g["cls_id"] == w["cls_id"]
                assert g["query_feat"].dtype == np.float32
                np.testing.assert_allclose(g["query_feat"], w["query_feat"],
                                           atol=1e-4, rtol=1e-4)


def test_stage2_takes_decoded_frames(segmenters, frame_files, tmp_path):
    """uint8 arrays are taken as already-decoded frames: the same outputs
    as the PNG paths they were decoded from."""
    from openpvsg_torch.data.pipeline import load_frame
    from openpvsg_torch.infer import stages

    _, seg = segmenters
    stages.run_query_tube_vps(seg, frame_files, str(tmp_path / "paths"))
    stages.run_query_tube_vps(seg, [load_frame(p) for p in frame_files],
                              str(tmp_path / "arrays"), pipeline_depth=1)
    with open(tmp_path / "paths" / "quantitive" / "masks.txt", "rb") as a, \
            open(tmp_path / "arrays" / "quantitive" / "masks.txt", "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# spans and counters of run_query_tube_vps (utils/profiling.RECORDER)
# ---------------------------------------------------------------------------

SPANS = {"stages.stack", "segmenter.upload", "segmenter.forward", "segmenter.fetch",
         "segmenter.stitch", "segmenter.align_fuse", "segmenter.feats", "stages.tubes",
         "stages.write_masks", "stages.write_tubes"}
VIDEOS, PER_BATCH = 2, 2             # two videos of T_FRAMES, one window of 2 per batch


def _stage2_files(root):
    with open(root / "quantitive" / "masks.txt", "rb") as a, \
            open(root / "query_feats.pickle", "rb") as b:
        return a.read(), b.read()


@pytest.fixture(scope="module")
def traced_stage2(segmenters, frame_files, tmp_path_factory):
    """Two videos run under ``torch.profiler`` and one without it: the
    recorder's snapshot, the profiler's events and the output roots."""
    import torch

    from openpvsg_torch.infer import stages
    from openpvsg_torch.utils.profiling import RECORDER

    _, seg = segmenters
    root = tmp_path_factory.mktemp("traced_stage2")
    stages.run_query_tube_vps(seg, frame_files, str(root / "off"), window=PER_BATCH)
    RECORDER.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for v in range(VIDEOS):
            stages.run_query_tube_vps(seg, frame_files, str(root / f"on{v}"),
                                      window=PER_BATCH)
    snap = RECORDER.snapshot()
    RECORDER.reset()
    events = [(e.name()[len("openpvsg."):], e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("openpvsg.")]
    return snap, events, root


def test_stage2_records_nothing_without_a_profiler(segmenters, frame_files, tmp_path,
                                                   monkeypatch):
    """With no profiler running, no span or counter records, opens a
    profiler range or asks a CUDA stream anything."""
    import torch

    from openpvsg_torch.infer import stages
    from openpvsg_torch.utils import profiling

    def forbidden(*a, **k):
        raise AssertionError("called with tracing off")

    for owner, name in ((profiling, "_HostRange"), (torch.profiler, "record_function"),
                        (torch.autograd.profiler, "record_function"),
                        (torch.cuda, "current_stream")):
        monkeypatch.setattr(owner, name, forbidden)
    profiling.RECORDER.reset()
    _, seg = segmenters
    stages.run_query_tube_vps(seg, frame_files, str(tmp_path / "out"), window=PER_BATCH)
    assert profiling.RECORDER.snapshot() == {"spans": [], "counters": {}}
    assert profiling.RECORDER.request == profiling.RECORDER.batch == -1


def test_stage2_spans_are_flat_and_cover_the_table(traced_stage2):
    """Every span of the table appears; none overlaps another on the thread;
    the spans of one call share one request, those of a batch its index,
    and the files' spans come once per call outside every batch."""
    snap, _, _ = traced_stage2
    spans = sorted(snap["spans"], key=lambda s: s[1])
    assert {s[0] for s in spans} == SPANS
    for a, b in zip(spans, spans[1:]):
        assert a[1] <= a[2] <= b[1], (a, b)
    requests = sorted({s[3] for s in spans})
    assert len(requests) == VIDEOS and requests[0] >= 1
    batches = -(-T_FRAMES // PER_BATCH)
    for r in requests:
        mine = [s for s in spans if s[3] == r]
        assert {s[4] for s in mine} == {-1, *range(batches)}
        assert [s[0] for s in mine if s[4] == -1] == ["stages.write_masks",
                                                      "stages.write_tubes"]
        for b in range(batches):
            names = [s[0] for s in mine if s[4] == b]
            assert names[:3] == ["stages.stack", "segmenter.upload", "segmenter.forward"]
            assert names.count("segmenter.fetch") == 5 and names[-1] == "stages.tubes"
    # the calls follow one another: one request's spans all end before the next's
    assert max(s[2] for s in spans if s[3] == requests[0]) \
        <= min(s[1] for s in spans if s[3] == requests[1])


def test_stage2_counters(segmenters, traced_stage2):
    """One upload and five fetches per batch at one replica, their bytes,
    and frames, batches and segments as the outputs count them (a CPU
    device has no stream, so each of its copies counts as drained, and no
    batch counts as overlapped)."""
    _, seg = segmenters
    snap, _, root = traced_stage2
    c = snap["counters"]
    batches = VIDEOS * -(-T_FRAMES // PER_BATCH)
    assert c["batches"] == batches and c["frames"] == VIDEOS * T_FRAMES
    assert c["copies"] == c["copies_drained"] == 6 * batches
    assert "segmenter.overlapped_batches" not in c
    lines = sum(len(_stage2_files(root / f"on{v}")[0].splitlines()) for v in range(VIDEOS))
    assert c["segments"] == lines > 0
    Q, C = seg.cfg.num_queries, seg.cfg.decoder.feat_channels
    per_frame = (H * W * 3                 # the uint8 upload
                 + 2 * Q * C * 4           # the embeddings for the stitch, the aligned query
                 + H * W * 4 + Q + Q * 4)  # pan_seg, query_keep, segment_id
    assert c["copy_bytes"] == VIDEOS * T_FRAMES * per_frame


def test_stage2_cpu_forwards_run_eagerly(segmenters, traced_stage2):
    """On the CPU every forward runs eagerly: no graph is kept, and of the
    forward's three counters only ``segmenter.eager_forwards`` counts, once
    per batch."""
    _, seg = segmenters
    snap, _, _ = traced_stage2
    c = snap["counters"]
    assert c["segmenter.eager_forwards"] == c["batches"] == VIDEOS * -(-T_FRAMES // PER_BATCH)
    assert "segmenter.graph_replays" not in c and "segmenter.graph_captures" not in c
    assert seg.replicas[0].graphs == {}


def test_stage2_spans_share_the_profilers_clock(traced_stage2):
    """Each recorded span lies within 1 ms of its ``openpvsg.<name>``
    profiler event, at both ends: one clock for both."""
    snap, events, _ = traced_stage2
    assert len(events) == len(snap["spans"])
    for name in SPANS:
        got = sorted(s[1:3] for s in snap["spans"] if s[0] == name)
        want = sorted(e[1:] for e in events if e[0] == name)
        assert len(got) == len(want) > 0
        for (s0, s1), (e0, e1) in zip(got, want):
            assert abs(s0 - e0) < 1e6 and abs(s1 - e1) < 1e6, name


def test_stage2_outputs_do_not_change_under_tracing(traced_stage2):
    _, _, root = traced_stage2
    off = _stage2_files(root / "off")
    assert all(_stage2_files(root / f"on{v}") == off for v in range(VIDEOS))
