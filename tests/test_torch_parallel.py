"""The multi-device half of the PyTorch port (openpvsg_torch.parallel, the
mesh paths of SegmenterInference, the relation evaluation and
DataParallelRelationTrainer) on meshes of CPU replicas, against the JAX
executors on conftest's 8-device virtual CPU mesh, with the same weights
and the same seeded numpy inputs.

Size: the tiny segmenter of tests/test_parallel.py (R-26, 4 queries, one
decoder layer) on 34x46 frames; the relation head at d 32 with 9
relations, T = 7 frames on a (4, 2) mesh (7 does not divide: it pads to 8,
the shape of tests/test_parallel.py:120).

Tolerances (tests/test_parallel.py's, and tests/test_torch_relation.py's
for Adam): panoptic maps and segment ids bit-identical, query features
1e-4; the sharded forward's class logits 1e-4 and mask logits 1e-3; the
relation outputs 1e-4 absolute; the device-gather and host-gather modes
equal; parameters after the data-parallel trainer's applies 1e-4 of their
tensor's scale plus 1e-6 (attention key-projection biases, whose exact
gradient is zero, within 3 Adam steps each way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small ops: torch at one intra-op thread, restored after (as
    tests/test_torch_streaming.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _seg_cfg(m):
    return m.Mask2FormerConfig(
        num_things_classes=3, num_stuff_classes=2, num_queries=4,
        backbone=m.BackboneConfig(depth=26),
        pixel_decoder=m.PixelDecoderConfig(encoder_layers=1, ffn_channels=32),
        decoder=m.TransformerDecoderConfig(num_layers=1, ffn_channels=32),
        object_mask_thr=0.01, iou_thr=0.1)


@pytest.fixture(scope="module")
def seg_weights():
    """(flax variables, port state dict) of the same random weights, BN
    statistics randomized and the void logit lowered so fusion keeps
    segments."""
    from openpvsg_torch.weights import random_state_dict, to_jax_params

    sd = random_state_dict(_seg_cfg(tcfg), 0)
    rng = np.random.default_rng(2)
    for k, v in sd.items():
        if k.endswith("running_var"):
            sd[k] = torch.from_numpy((1.0 + rng.random(v.shape)).astype(np.float32))
        elif k.endswith("running_mean"):
            sd[k] = torch.from_numpy((0.1 * rng.standard_normal(v.shape)).astype(np.float32))
    sd["head.cls_embed.bias"][-1] -= 4.0
    variables = jax.tree_util.tree_map(np.asarray, to_jax_params(sd, _seg_cfg(tcfg)))
    return variables, sd


def test_mesh_axes_and_shard_batch_match_jax():
    from openpvsg_tpu.parallel.mesh import make_mesh as jax_mesh
    from openpvsg_tpu.parallel.mesh import shard_batch as jax_shard
    from openpvsg_torch.parallel.mesh import make_mesh, shard_batch

    mesh, jm = make_mesh(n_data=4, n_time=2, devices=CPU8), jax_mesh(n_data=4, n_time=2)
    assert mesh.axis_names == jm.axis_names == ("data", "time")
    assert mesh.shape == dict(jm.shape) and mesh.size == 8
    assert make_mesh(devices=CPU8).shape == {"data": 8, "time": 1}
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    parts = shard_batch(mesh, {"x": x})
    want = jax_shard(jm, {"x": x})["x"]
    blocks = sorted({(s.index[0].start, s.index[0].stop) for s in want.addressable_shards})
    assert [(lo, hi) for lo, hi in blocks] == [(2 * i, 2 * i + 2) for i in range(4)]
    for (lo, hi), p in zip(blocks, parts):
        np.testing.assert_array_equal(p["x"].numpy(), x[lo:hi])
    with pytest.raises(ValueError, match="divide"):
        shard_batch(mesh, x[:7])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(n_data=2)


def test_pad_frames_for_mesh_matches_jax():
    from openpvsg_tpu.parallel.sp import pad_frames_for_mesh as jax_pad
    from openpvsg_torch.parallel.sp import pad_frames_for_mesh

    frames = np.random.default_rng(0).random((5, 4, 4, 3)).astype(np.float32)
    want, n = jax_pad(frames, 4)
    got, m = pad_frames_for_mesh(frames, 4)
    got_t, k = pad_frames_for_mesh(torch.from_numpy(frames), 4)
    assert n == m == k == 5 and got.shape[0] == 8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert pad_frames_for_mesh(frames[:4], 4)[0].shape[0] == 4


def test_segmenter_inference_mesh_matches_jax(seg_weights, rng):
    """SegmenterInference on 4 replicas against JAX's on a 4-device mesh,
    raw uint8 frames at a count that does not divide (5): the panoptic maps
    and segment ids bit-identical (to the port's one-device run too), query
    features 1e-4."""
    from openpvsg_tpu.infer.segmenter import SegmenterInference as JaxSeg
    from openpvsg_tpu.parallel.mesh import make_mesh as jax_mesh
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.parallel.mesh import make_mesh

    variables, sd = seg_weights
    frames = rng.integers(0, 255, (5, 34, 46, 3)).astype(np.uint8)
    want = JaxSeg(_seg_cfg(jcfg), variables, mesh=jax_mesh(n_data=4)).infer_frames_ips(frames)
    seg = SegmenterInference(_seg_cfg(tcfg), sd, device="cpu",
                             mesh=make_mesh(n_data=4, devices=CPU8[:4]))
    assert len(seg.replicas) == 4
    got = seg.infer_frames_ips(frames)
    one = SegmenterInference(_seg_cfg(tcfg), sd, device="cpu").infer_frames_ips(frames)
    assert len(got) == len(want) == len(one) == 5
    assert any(o["query_feats"] for o in got)
    for g, w, o in zip(got, want, one):
        assert g["pan_results"].shape == (34, 46)
        np.testing.assert_array_equal(g["pan_results"], w["pan_results"])
        np.testing.assert_array_equal(g["pan_results"], o["pan_results"])
        assert set(g["query_feats"]) == set(w["query_feats"]) == set(o["query_feats"])
        for sid, f in g["query_feats"].items():
            np.testing.assert_allclose(f, w["query_feats"][sid], rtol=0, atol=1e-4)


def test_sharded_frame_forward_matches_jax(seg_weights, rng):
    """ShardedFrameForward over 8 replicas against JAX's over 8 devices:
    each frame its own clip; class logits 1e-4, mask logits 1e-3."""
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F
    from openpvsg_tpu.parallel.mesh import make_mesh as jax_mesh
    from openpvsg_tpu.parallel.sp import ShardedFrameForward as JaxSFF
    from openpvsg_torch.models.mask2former import Mask2Former
    from openpvsg_torch.parallel.mesh import make_mesh
    from openpvsg_torch.parallel.sp import ShardedFrameForward

    variables, sd = seg_weights
    frames = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    jmodel = JaxM2F(_seg_cfg(jcfg))

    def jax_fn(v, fr):
        out = jmodel.apply(v, fr[:, None])
        return out["cls_preds"][-1], out["mask_preds"][-1]

    want_cls, want_masks = JaxSFF(jax_mesh(n_data=8), jax_fn, variables)(frames)
    model = Mask2Former(_seg_cfg(tcfg))
    model.load_state_dict(sd)

    def fn(m, x):
        cls, masks, _ = m(x)
        return cls, masks

    sff = ShardedFrameForward(make_mesh(n_data=8, devices=CPU8), fn, model.eval())
    cls, masks = sff(frames)
    np.testing.assert_allclose(cls.numpy(), np.asarray(want_cls), rtol=0, atol=1e-4)
    np.testing.assert_allclose(masks.numpy(), np.asarray(want_masks)[:, :, 0],
                               rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="not divisible"):
        sff(frames[:7])


# ---------------------------------------------------------------------------
# relation head
# ---------------------------------------------------------------------------

HEADS = ["vanilla", "filter", "conv", "transformer"]


def _rel_cfg(m, name="transformer", **kw):
    return m.RelationHeadConfig(model_name=name, d_model=32, encoder_heads=2,
                                encoder_ffn=48, temporal_heads=2, temporal_ffn=40,
                                num_relations=9, **kw)


def _rel_models(name, seed=1):
    """(JAX model, flax params, port model) on the same random weights."""
    from openpvsg_tpu.models.relation.heads import RelationModel as JaxRel
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.weights import (random_relation_state_dict,
                                        relation_to_jax_params)

    tc = _rel_cfg(tcfg, name)
    sd = random_relation_state_dict(tc, seed)
    model = RelationModel.from_config(tc)
    model.load_state_dict(sd)
    params = jax.tree_util.tree_map(np.asarray, relation_to_jax_params(sd, tc))
    return JaxRel.from_config(_rel_cfg(jcfg, name)), params, model.eval()


def test_sharded_pair_predict_matches_jax(rng):
    from openpvsg_tpu.models.relation.heads import RelationModel as JaxRel
    from openpvsg_tpu.parallel.mesh import make_mesh as jax_mesh
    from openpvsg_tpu.parallel.sp import ShardedPairPredict as JaxSPP
    from openpvsg_torch.parallel.mesh import make_mesh
    from openpvsg_torch.parallel.sp import ShardedPairPredict

    jmodel, params, model = _rel_models("transformer")
    pair_feats = rng.standard_normal((5, 6, 64)).astype(np.float32)

    def jax_predict(p, x):
        return jmodel.apply({"params": p}, x, method=JaxRel.predict)

    want_span, want_prob = JaxSPP(jax_mesh(n_data=8), jax_predict, params)(pair_feats)
    span, prob = ShardedPairPredict(make_mesh(n_data=8, devices=CPU8),
                                    lambda m, x: m.predict(x), model)(pair_feats)
    assert span.shape == (5, 6, 9) and prob.shape == (5, 9)
    np.testing.assert_allclose(span.numpy(), np.asarray(want_span), rtol=0, atol=1e-4)
    np.testing.assert_allclose(prob.numpy(), np.asarray(want_prob), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", HEADS)
def test_time_sharded_relation_matches_jax(name, rng):
    """(data, time) = (4, 2), T = 7 (padded to 8): the pair matrix, the
    encoders' outputs, spans and relation logits against JAX's
    TimeShardedRelation, 1e-4."""
    from openpvsg_tpu.parallel.mesh import make_mesh as jax_mesh
    from openpvsg_tpu.parallel.tp import TimeShardedRelation as JaxTSR
    from openpvsg_torch.parallel.mesh import make_mesh
    from openpvsg_torch.parallel.tp import TimeShardedRelation

    jmodel, params, model = _rel_models(name)
    n, t, d = 5, 7, 32
    feats = rng.standard_normal((n, t, d)).astype(np.float32)
    pair_feats = rng.standard_normal((6, t, 2 * d)).astype(np.float32)
    jts = JaxTSR(jax_mesh(n_data=4, n_time=2), jmodel, params)
    ts = TimeShardedRelation(make_mesh(n_data=4, n_time=2, devices=CPU8), model)
    want_out, got_out = jts.propose(feats), ts.propose(feats)
    want_span, want_prob = jts.predict(pair_feats)
    span, prob = ts.predict(pair_feats)
    assert [p.shape[1] for p in got_out["sub_feats"].parts] == [4, 4]
    np.testing.assert_allclose(got_out["pred_matrix"].numpy(),
                               np.asarray(want_out["pred_matrix"]), rtol=0, atol=1e-4)
    for k in ("sub_feats", "obj_feats"):
        np.testing.assert_allclose(got_out[k].full().numpy(), np.asarray(want_out[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(span.numpy(), np.asarray(want_span), rtol=0, atol=1e-4)
    np.testing.assert_allclose(prob.numpy(), np.asarray(want_prob), rtol=0, atol=1e-4)


def test_time_sharded_two_conv_layers_match_one_device(rng):
    """Two learned conv layers: the second layer's halo and zero padding
    past the input hold against the one-device model (JAX's executor runs
    the padded frames through the first layer, so it is held to the
    port's one-device run here, and to JAX at one layer above)."""
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.parallel.mesh import make_mesh
    from openpvsg_torch.parallel.tp import TimeShardedRelation
    from openpvsg_torch.weights import random_relation_state_dict

    tc = _rel_cfg(tcfg, "conv", temporal_layers=2)
    model = RelationModel.from_config(tc)
    model.load_state_dict(random_relation_state_dict(tc, 3))
    pair_feats = rng.standard_normal((6, 7, 64)).astype(np.float32)
    span, prob = TimeShardedRelation(make_mesh(n_data=2, n_time=4, devices=CPU8),
                                     model.eval()).predict(pair_feats)
    with torch.no_grad():
        want_span, want_prob = model.predict(torch.from_numpy(pair_feats))
    np.testing.assert_allclose(span.numpy(), want_span.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(prob.numpy(), want_prob.numpy(), rtol=0, atol=1e-5)


def test_time_sharded_device_gather_parity(rng):
    """evaluate_video over the executor: the device gather
    (``predict_pairs``) and the host gather give the same pairs, triplets
    and spans, and the pairs JAX's executor picks."""
    from openpvsg_tpu.eval.rel_eval import evaluate_video as jax_eval_video
    from openpvsg_tpu.parallel.mesh import make_mesh as jax_mesh
    from openpvsg_tpu.parallel.tp import TimeShardedRelation as JaxTSR
    from openpvsg_torch.eval.rel_eval import evaluate_video
    from openpvsg_torch.parallel.mesh import make_mesh
    from openpvsg_torch.parallel.tp import TimeShardedRelation

    jmodel, params, model = _rel_models("transformer")
    feats = rng.standard_normal((5, 7, 32)).astype(np.float32)
    ts = TimeShardedRelation(make_mesh(n_data=4, n_time=2, devices=CPU8), model)
    p_host, r_host = evaluate_video(model, feats, num_top_pairs=6, executor=ts,
                                    device_gather=False)
    p_dev, r_dev = evaluate_video(model, feats, num_top_pairs=6, executor=ts,
                                  device_gather=True)
    p_one, _ = evaluate_video(model, feats, num_top_pairs=6)
    p_jax, _ = jax_eval_video(jmodel, params, feats, num_top_pairs=6,
                              executor=JaxTSR(jax_mesh(n_data=4, n_time=2), jmodel, params))
    assert p_host == p_dev == p_one == p_jax
    assert len(r_host) == len(r_dev) > 0
    for h, d in zip(r_host, r_dev):
        assert (h["subject_index"], h["object_index"], h["relation"]) == \
               (d["subject_index"], d["object_index"], d["relation"])
        np.testing.assert_array_equal(h["relation_span"], d["relation_span"])


# ---------------------------------------------------------------------------
# data-parallel relation training
# ---------------------------------------------------------------------------

def _videos(seed, n, num_relations=9):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = (20, 30, 140)[i % 3]  # two frame buckets: 128 and 256
        feats = rng.standard_normal((4 + i % 3, t, 32)).astype(np.float32)
        rels = [{"subject_index": 0, "object_index": 1, "relation": i % num_relations,
                 "relation_span": np.ones(t)},
                {"subject_index": 2, "object_index": 1,
                 "relation": (i + 3) % num_relations,
                 "relation_span": (np.arange(t) < t // 2).astype(np.float64)}]
        out.append((feats, rels))
    return out


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_data_parallel_relation_trainer_matches_jax():
    """7 videos over a 4-wide mesh at accumulation_steps 4: the losses of
    every queue that ran and the parameters after ``flush`` (which drains
    the partial queues) against JAX's DataParallelRelationTrainer."""
    from openpvsg_tpu.parallel.mesh import make_mesh as jax_mesh
    from openpvsg_tpu.train.relation import DataParallelRelationTrainer as JaxDP
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.parallel.mesh import make_mesh
    from openpvsg_torch.train.relation import DataParallelRelationTrainer
    from openpvsg_torch.weights import relation_from_jax_params, relation_to_jax_params

    jc, tc = _rel_cfg(jcfg, accumulation_steps=4), _rel_cfg(tcfg, accumulation_steps=4)
    counts = np.random.default_rng(7).integers(1, 40, 9).astype(np.float32)
    jt = JaxDP(jc, counts, jax_mesh(n_data=4), rng_seed=0)
    m = RelationModel.from_config(tc)
    m.load_state_dict(relation_from_jax_params(jax.tree_util.tree_map(np.asarray, jt.params), tc))
    pt = DataParallelRelationTrainer(tc, counts, make_mesh(n_data=4, devices=CPU8[:4]),
                                     rng_seed=0, state_dict=m.state_dict())
    assert len(pt.replicas) == 4
    ran = 0
    for feats, rels in _videos(1, 7):
        want, got = jt.step(feats, rels), pt.step(feats, rels)
        assert (want is None) == (got is None)
        if got is not None:
            ran += 1
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
            for k, v in want[1].items():
                np.testing.assert_allclose(got[1][k], v, rtol=1e-5, err_msg=k)
    assert ran >= 1 and any(pt._queues.values())
    assert pt._accum_count == jt._accum_count
    jt.flush()
    pt.flush()
    assert pt._accum_count == 0 and not any(pt._queues.values())
    got = dict(_flat(relation_to_jax_params(pt.model.state_dict(), tc)))
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, jt.params)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        atol = (2 * 3 * jc.lr if path[-2:] == ("k_proj", "bias")
                else 1e-4 * np.abs(w).max() + 1e-6)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol, err_msg="/".join(path))
    # the replicas took the applied weights
    for rep in pt.replicas[1:]:
        for p, q in zip(pt.model.parameters(), rep.parameters()):
            assert torch.equal(p, q)


def test_data_parallel_relation_accumulates_what_the_sequential_trainer_does():
    """The zero-weight padding of a partial queue adds nothing: one video in
    a 3-wide mesh accumulates the sequential trainer's gradients."""
    from openpvsg_torch.parallel.mesh import make_mesh
    from openpvsg_torch.train.relation import (DataParallelRelationTrainer,
                                               RelationTrainer)

    tc = _rel_cfg(tcfg, accumulation_steps=100)
    counts = np.ones(9, np.float32)
    seq = RelationTrainer(tc, counts, rng_seed=0, device="cpu")
    dp = DataParallelRelationTrainer(tc, counts, make_mesh(n_data=3, devices=CPU8[:3]),
                                     rng_seed=0, state_dict=seq.model.state_dict())
    feats, rels = _videos(4, 1)[0]
    seq.step(feats, rels)
    assert dp.step(feats, rels) is None
    dp._run_queue(next(iter(dp._queues)))
    assert dp._accum_count == seq._accum_count == 1
    for a, b in zip(seq._accum, dp._accum):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=1e-6 * max(a.abs().max().item(), 1e-30))
