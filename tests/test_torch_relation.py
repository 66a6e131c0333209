"""The relation head of the PyTorch port (openpvsg_torch.models.relation,
openpvsg_torch.train.relation) against the JAX package on the CPU: the same
weights (a flax init passed through relation_from_jax_params) and the same
seeded numpy inputs go through both.

Weights: the port's random weights from a seed in the flax layout, or a
flax init (the JAX trainer's own). Size: d 32, 2 encoder heads, ffn 48, pair MLP 1024, temporal 2 heads, ffn
40, 7 relations; videos of 5-14 tubes and 12-40 frames, padded to 8-20
tubes and 16-128 frames.

Tolerances (measured gaps in brackets):
- model outputs 1e-5 absolute against JAX (<= 1.2e-6), and 1e-5 between a
  padded and an unpadded run of the port (0 for the encoders, <= 4.8e-7 for
  the temporal transformer, whose attention sums over another length);
- the 1-D sine encoding 1e-6 absolute at 16 frames, 1e-4 at 900 (3.1e-5
  measured: sin and cos of float32 arguments up to 899);
- losses 1e-6 relative;
- the trainer's loss 1e-5 relative and every gradient 1e-4 of its tensor's
  scale plus 1e-7 absolute, against ``make_loss_fn``'s value_and_grad in
  float32 on the CPU (the relation head has LayerNorm and no batch
  statistics, so float32 JAX gradients are a reference);
- parameters after 3 Adam applies 1e-4 of their tensor's scale plus 1e-6
  absolute, as tests/test_torch_train.py: optax and torch round the same
  formula differently, and Adam divides each gradient element by its own
  magnitude, so an element far below its tensor's scale passes its
  relative error on to its update (3.2e-6 measured on one element of a
  0.37-scale kernel; all others within 1e-6). The attention key-projection biases, whose exact gradient
  is zero, get rounding noise that Adam scales to steps of up to lr: they
  are held within 3 steps each way (6e-4);
- batches, numpy helpers and RNG draws: equal.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

D, R = 32, 7
HEADS = ["vanilla", "filter", "conv", "transformer"]


def _cfg(m, name="transformer", pair_interaction=False, **kw):
    return m.RelationHeadConfig(
        model_name=name, d_model=D, encoder_heads=2, encoder_ffn=48,
        temporal_heads=2, temporal_ffn=40, num_relations=R,
        pair_interaction=pair_interaction, **kw)


def _jax_model(cfg):
    from openpvsg_tpu.models.relation.heads import RelationModel

    return RelationModel.from_config(cfg)


def _init(cfg, seed=1):
    """flax params of the model: the port's random weights in the flax
    layout (no flax init to compile; the layout walk is held to a flax init
    in test_relation_weights_raise_on_missing_and_extra_keys)."""
    from openpvsg_torch.weights import (random_relation_state_dict,
                                        relation_to_jax_params)

    tc = tcfg.RelationHeadConfig(**dataclasses.asdict(cfg))
    return relation_to_jax_params(random_relation_state_dict(tc, seed), tc)


def _port_model(params, cfg):
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.weights import relation_from_jax_params

    m = RelationModel.from_config(cfg)
    m.load_state_dict(relation_from_jax_params(params, cfg))
    return m


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _relations(rng, n, t, count):
    rels = []
    for _ in range(count):
        s, o = rng.choice(n, 2, replace=False)
        span = np.zeros(t)
        a = int(rng.integers(0, t - 3))
        span[a:a + int(rng.integers(3, t - a + 1))] = 1
        rels.append({"subject_index": int(s), "object_index": int(o),
                     "relation": int(rng.integers(0, R)), "relation_span": span})
    return rels


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair_interaction", [False, True])
@pytest.mark.parametrize("name", HEADS)
def test_relation_model_matches_jax(name, pair_interaction):
    """Every output of the four heads, with and without the pair-interaction
    input, on padded tubes and frames; and the port's padded run against
    its unpadded run."""
    jc, tc = _cfg(jcfg, name, pair_interaction), _cfg(tcfg, name, pair_interaction)
    params = _init(jc)
    model = _port_model(params, tc)
    rng = np.random.default_rng(0)
    n, t, nb, tb, P, pb = 5, 12, 8, 16, 4, 6
    feats = np.zeros((nb, tb, D), np.float32)
    feats[:n, :t] = rng.standard_normal((n, t, D))
    pair = np.zeros((pb, tb, 2 * D), np.float32)
    pair[:P, :t] = rng.standard_normal((P, t, 2 * D))
    tv, fv = np.arange(nb) < n, np.arange(tb) < t
    want = jax.jit(_jax_model(jc).apply)(
        {"params": params}, jnp.asarray(feats), jnp.asarray(pair),
        tube_valid=jnp.asarray(tv), frame_valid=jnp.asarray(fv))
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(pair),
                    tube_valid=torch.from_numpy(tv), frame_valid=torch.from_numpy(fv))
        bare = model(torch.from_numpy(feats[:n, :t]), torch.from_numpy(pair[:P, :t]))
    assert set(got) == set(want) == {"sub_feats", "obj_feats", "pred_matrix",
                                     "span_pred", "prob"}
    valid = {"sub_feats": np.s_[:n, :t], "obj_feats": np.s_[:n, :t],
             "pred_matrix": np.s_[:n, :n], "span_pred": np.s_[:P, :t],
             "prob": np.s_[:P]}
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k][valid[k]].numpy(), bare[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=f"padded {k}")


def test_sine_embed_1d_matches_jax():
    from openpvsg_tpu.models.position_encoding import sine_embed_1d as jax_pe
    from openpvsg_torch.models.position_encoding import sine_embed_1d

    # sin and cos of float32 arguments up to 899 (ulp 6.1e-5): the two
    # libraries' range reductions differ by up to half an ulp there
    for length, dim, atol in ((16, 64, 1e-6), (900, 512, 1e-4)):
        np.testing.assert_allclose(sine_embed_1d(length, dim).numpy(),
                                   np.asarray(jax_pe(length, dim)), rtol=0, atol=atol)


def test_losses_match_jax():
    from openpvsg_tpu.models.relation import losses as jl
    from openpvsg_torch.models.relation import losses as tl

    rng = np.random.default_rng(2)
    y = (rng.random((6, 9, R)) < 0.3).astype(np.float32)
    x = (3 * rng.standard_normal((6, 9, R))).astype(np.float32)
    counts = rng.integers(1, 50, R).astype(np.float32)
    T = torch.from_numpy
    np.testing.assert_allclose(float(tl.zlpr_loss(T(y), T(x))),
                               float(jl.zlpr_loss(y, x)), rtol=1e-6)
    np.testing.assert_allclose(float(tl.rew_bce_loss(T(y), T(x), T(counts))),
                               float(jl.rew_bce_loss(y, x, counts)), rtol=1e-6)


# ---------------------------------------------------------------------------
# host helpers and batching
# ---------------------------------------------------------------------------

def test_numpy_helpers_match_jax():
    from openpvsg_tpu.models.relation import utils as ju
    from openpvsg_torch.models.relation import utils as tu

    rng = np.random.default_rng(3)
    n, t = 9, 20
    rels = _relations(rng, n, t, 12)
    pm = rng.standard_normal((n, n)).astype(np.float32)
    assert tu.pick_top_pairs(rels, pm, 30) == ju.pick_top_pairs(rels, pm, 30)
    assert (tu.get_gt_pairs(rels, 5, random.Random(4))
            == ju.get_gt_pairs(rels, 5, random.Random(4)))
    pairs = tu.pick_top_pairs_eval(pm, 20)
    assert pairs == ju.pick_top_pairs_eval(pm, 20)
    sub, obj = rng.standard_normal((2, n, t, D)).astype(np.float32)
    np.testing.assert_array_equal(tu.concatenate_sub_obj(sub, obj, pairs),
                                  ju.concatenate_sub_obj(sub, obj, pairs))
    span, prob = (tu.generate_gt_matrix(rels, pairs, (len(pairs), 10, R), (5, 15)))
    for a, b in zip((span, prob), ju.generate_gt_matrix(rels, pairs, (len(pairs), 10, R), (5, 15))):
        np.testing.assert_array_equal(a, b)
    pred = rng.standard_normal(span.shape).astype(np.float32)
    for a, b in zip(tu.reshape_and_filter(span, pred), ju.reshape_and_filter(span, pred)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tu.filter_span_mask(span), ju.filter_span_mask(span))
    probs = rng.standard_normal((len(pairs), R)).astype(np.float32)
    for gen in ("generate_results", "generate_pairwise_results"):
        got = getattr(tu, gen)(pred, probs, pairs)
        want = getattr(ju, gen)(pred, probs, pairs)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            assert all(np.array_equal(g[k], w[k]) for k in g)


@pytest.mark.parametrize("n,t", [(5, 12), (14, 40), (9, 300)])
def test_subsample_and_build_batch_match_jax(n, t):
    """Tube subsampling (N > max_tubes), frame windows (T > max_frames) and
    the padded batch: equal arrays, and the same RNG state after."""
    from openpvsg_tpu.train import relation as jr
    from openpvsg_torch.train import relation as tr

    rng = np.random.default_rng(n * 100 + t)
    feats = rng.standard_normal((n, t, D)).astype(np.float32)
    rels = _relations(rng, n, t, 14)
    kw = dict(max_tubes=10, max_frames=200, num_top_pairs=12)
    jc, tc = _cfg(jcfg, **kw), _cfg(tcfg, **kw)
    for seed in range(3):
        out = {}
        for name, mod, cfg in (("jax", jr, jc), ("port", tr, tc)):
            r = random.Random(seed)
            f, g, span = mod.subsample_video(feats, rels, cfg, r)
            b = mod.build_batch(f, g, span, cfg, r)
            out[name] = (f, g, span, b, r.getstate())
        (fj, gj, sj, bj, rj), (fp, gp, sp, bp, rp) = out["jax"], out["port"]
        np.testing.assert_array_equal(fp, fj)
        assert sp == sj and rp == rj and len(gp) == len(gj)
        for a, b in zip(gp, gj):
            assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        assert tr.TUBE_BUCKETS == jr.TUBE_BUCKETS
        assert tr.FRAME_BUCKETS == jr.FRAME_BUCKETS
        assert tr.PAIR_BUCKETS == jr.PAIR_BUCKETS
        for field in ("feats", "tube_valid", "frame_valid", "pair_feats",
                      "pair_valid", "gt_matrix", "gt_span", "gt_prob"):
            a, b = getattr(bp, field), getattr(bj, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _video(seed, n=12, t=60, count=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, t, D)).astype(np.float32),
            _relations(rng, n, t, count))


@pytest.mark.parametrize("name,pair_interaction", [("transformer", False),
                                                   ("conv", True)])
def test_trainer_loss_and_every_grad(name, pair_interaction):
    """One padded video: the port's loss and the gradient of every
    parameter against make_loss_fn's value_and_grad."""
    from openpvsg_tpu.train import relation as jr
    from openpvsg_torch.train import relation as tr
    from openpvsg_torch.weights import relation_to_jax_params

    jc = _cfg(jcfg, name, pair_interaction)
    tc = _cfg(tcfg, name, pair_interaction)
    params = _init(jc)
    counts = np.random.default_rng(5).integers(1, 40, R).astype(np.float32)
    feats, rels = _video(6, n=9, t=50, count=5)
    batch = jr.build_batch(*jr.subsample_video(feats, rels, jc, random.Random(0)),
                           jc, random.Random(0))
    loss_fn = jr.make_loss_fn(_jax_model(jc), counts, jc.loss_prob_weight)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jr.RelationTrainer._to_device_batch(None, batch))

    trainer = tr.RelationTrainer(tc, counts, device="cpu",
                                 state_dict=_port_model(params, tc).state_dict())
    loss, aux, grads = trainer.loss_and_grads(batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-5, err_msg=k)
    names = [k for k, _ in trainer.model.named_parameters()]
    got = dict(_flat(relation_to_jax_params(dict(zip(names, grads)), tc)))
    want = dict(_flat(jgrads))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-7,
                                   err_msg="/".join(path))


def _jax_trainer(cfg, counts):
    from openpvsg_tpu.train.relation import RelationTrainer

    return RelationTrainer(cfg, counts, rng_seed=0)


def test_trainer_three_applies_match_jax():
    """6 videos at accumulation_steps 2: the same losses step by step and
    the same parameters after 3 Adam applies."""
    from openpvsg_torch.train.relation import RelationTrainer
    from openpvsg_torch.weights import relation_to_jax_params

    jc = _cfg(jcfg, accumulation_steps=2)
    tc = _cfg(tcfg, accumulation_steps=2)
    counts = np.random.default_rng(7).integers(1, 40, R).astype(np.float32)
    jt = _jax_trainer(jc, counts)
    pt = RelationTrainer(tc, counts, device="cpu",
                         state_dict=_port_model(jt.params, tc).state_dict())
    for i in range(6):
        feats, rels = _video(10 + i, n=8 + i, t=40 + 10 * i)
        (jl, jaux), (pl, paux) = jt.step(feats, rels), pt.step(feats, rels)
        np.testing.assert_allclose(pl, jl, rtol=1e-5, err_msg=f"step {i}")
    assert pt._accum is None and jt._accum is None
    got = dict(_flat(relation_to_jax_params(pt.model.state_dict(), tc)))
    want = dict(_flat(jt.params))
    assert got.keys() == want.keys()
    for path, w in want.items():
        # a key-projection bias has an exact gradient of zero (the softmax
        # over keys ignores it): both sides get rounding noise, which Adam
        # scales to steps of up to lr each, in either direction
        if path[-2:] == ("k_proj", "bias"):
            atol = 2 * 3 * jc.lr
        else:
            atol = 1e-4 * np.abs(w).max() + 1e-6
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol,
                                   err_msg="/".join(path))


@pytest.fixture
def one_intra_op_thread():
    """Run the test at one intra-op thread, restoring the count after. With
    more, torch's CPU backward of advanced indexing (``index_put_`` with
    accumulate, float32, at least 32768 elements) adds atomically in
    parallel, so two identical steps can differ in the last bits when the
    host is loaded."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def test_checkpoint_resume_takes_the_same_next_step(tmp_path, one_intra_op_thread):
    """Save in the middle of an accumulation cycle; a trainer resumed from
    the file takes the same next steps, bitwise on the CPU at one intra-op
    thread."""
    from openpvsg_torch.train.checkpoint import (load_relation_checkpoint,
                                                 save_relation_checkpoint)
    from openpvsg_torch.train.relation import RelationTrainer

    tc = _cfg(tcfg, accumulation_steps=2, max_frames=40)
    counts = np.ones(R, np.float32)
    videos = [_video(20 + i, n=8, t=30 + 10 * i) for i in range(5)]
    a = RelationTrainer(tc, counts, rng_seed=3, device="cpu")
    for v in videos[:3]:
        a.step(*v)
    path = str(tmp_path / "rel.pt")
    save_relation_checkpoint(path, a)
    b = RelationTrainer(tc, counts, rng_seed=9, device="cpu")
    load_relation_checkpoint(path, b)
    assert b._accum_count == a._accum_count == 1
    for v in videos[3:]:
        assert a.step(*v) == b.step(*v)
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
    assert a.rng.getstate() == b.rng.getstate()


def test_relation_weights_raise_on_missing_and_extra_keys():
    from openpvsg_torch.weights import (relation_from_jax_params,
                                        relation_to_jax_params)

    cfg = _cfg(tcfg, "conv")
    params = jax.tree_util.tree_map(np.asarray, jax.jit(_jax_model(_cfg(jcfg, "conv")).init)(
        jax.random.PRNGKey(0), jnp.zeros((3, 5, D)), jnp.zeros((2, 5, 2 * D)))["params"])
    state = relation_from_jax_params(params, cfg)
    back = dict(_flat(relation_to_jax_params(state, cfg)))
    for path, v in _flat(params):
        np.testing.assert_array_equal(back[path], v)
    extra = {**params, "temporal": {**params["temporal"],
                                    "conv_1": params["temporal"]["conv_0"]}}
    with pytest.raises(ValueError, match=r"^relation_from_jax_params: \d+ keys "
                                         r"the configured model does not use[^;]*$"):
        relation_from_jax_params(extra, cfg)
    missing = {k: v for k, v in params.items() if k != "pair_proposal"}
    with pytest.raises(ValueError, match=r"^relation_from_jax_params: \d+ keys "
                                         r"the tree lacks[^;]*$"):
        relation_from_jax_params(missing, cfg)
    with pytest.raises(ValueError, match="shape mismatches"):
        relation_from_jax_params(params, _cfg(tcfg, "conv", conv_kernel=3))


def test_presets_match_jax():
    from dataclasses import asdict

    for name in HEADS:
        t, j = tcfg.relation_head(name), jcfg.relation_head(name)
        assert asdict(t.relation) == asdict(j.relation) and t.name == j.name
    for fn in ("relation_conv_interact", "relation_conv_large"):
        t, j = getattr(tcfg, fn)(), getattr(jcfg, fn)()
        assert asdict(t.relation) == asdict(j.relation) and t.name == j.name
    assert asdict(tcfg.RelationHeadConfig()) == asdict(jcfg.RelationHeadConfig())
