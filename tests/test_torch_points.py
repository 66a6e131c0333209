"""The reference's training objective in the PyTorch port against the JAX
package on the CPU: point-sampled matching costs and losses
(``loss_sampling='points'``) and the thing/stuff query split
(``split_thing_stuff``), down to one trainer step of the MSDA model.

JAX draws its points from threefry keys, which a torch generator cannot
reproduce, so the port's draws come from an injectable source
(``openpvsg_torch.ops.sampling.Draw``) and these tests replay JAX's draws
through it (``jax_draws``: the assignment's
``split(split(fold_in(rng, l))[0], B)[b]``, then per layer
``split(split(fold_in(rng, l))[1])`` for the candidates and the random
points). With the same points the costs, assignments and losses are
compared; the draws themselves never are.

Tolerances: costs 1e-5 absolute and assignments bit-identical; the points
loss's logs rel 1e-5 and its prediction gradients 1e-5 absolute against
JAX in float64; one trainer step's loss rel 1e-4 and every gradient rel
1e-4 of its scale plus 1e-6, against the JAX trainer computing in float64
(tests/test_torch_train.py's bounds and reasons).
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

from test_torch_train import (MEAN, STD, _batch, _blob_masks, _close_to_scale,
                              _port_grads, one_intra_op_thread)  # noqa: F401

L, B, Q, K, N, T, HM = 2, 2, 8, 5, 3, 2, 16  # K classes: 3 things, 2 stuff
P = 64


def jax_draws(key, n_layers, n_items, n_queries, num_points, oversample=3.0,
              importance=0.75):
    """The uniform draws of JAX's points mode in the port's order: the
    assignment's (L, B, P, 2), then each layer's candidates and random
    points (float64 under ``jax.enable_x64``, as JAX then draws them)."""
    assign = np.stack([
        np.stack([np.asarray(jax.random.uniform(k, (1, num_points, 2)))[0]
                  for k in jax.random.split(jax.random.split(
                      jax.random.fold_in(key, layer))[0], n_items)])
        for layer in range(n_layers)])
    out = [assign]
    for layer in range(n_layers):
        _, r_pts = jax.random.split(jax.random.fold_in(key, layer))
        k1, k2 = jax.random.split(r_pts)
        n = n_items * n_queries
        out.append(np.asarray(jax.random.uniform(k1, (n, int(num_points * oversample), 2))))
        out.append(np.asarray(jax.random.uniform(
            k2, (n, num_points - int(importance * num_points), 2))))
    return out


class Replay:
    """A ``Draw`` that hands out recorded draws in order, as float32."""

    def __init__(self, draws):
        self.queue = list(draws)

    def __call__(self, shape):
        a = self.queue.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(np.array(a, np.float32))


def _preds(seed=0):
    """Layer predictions where query j reproduces target j (j < N) and the
    rest are noise. Target 0 of each item is stuff (label 3) and taken by
    thing query 0, so the split must move it to a stuff query."""
    rng = np.random.default_rng(seed)
    masks = np.stack([_blob_masks(rng, N, T, HM, HM) for _ in range(B)])
    cls = rng.standard_normal((L, B, Q, K + 1)).astype(np.float32)
    mp = rng.standard_normal((L, B, Q, T, HM, HM)).astype(np.float32)
    for j in range(N):
        mp[:, :, j] = np.where(masks[None, :, j] > 0, 6.0, -6.0) + 0.5 * mp[:, :, j]
    labels = np.array([[3, 0, 1], [3, 2, 4]], np.int32)
    valid = np.ones((B, N), bool)
    valid[1, 2] = False
    return cls, mp, labels, masks.astype(np.float32), valid


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_split_kw(split):
    return dict(split_thing_stuff=split, num_things_classes=3, num_stuff_classes=2)


def _port_split_kw(split):
    return dict(num_stuff_queries=2 if split else 0, num_things_classes=3)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_uncertainty_sampled_points_equal_jax():
    from openpvsg_tpu.ops.sampling import uncertainty_sampled_points as jax_pts
    from openpvsg_torch.ops.sampling import uncertainty_sampled_points

    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((6, 20, 12))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_pts(key, logits, 32, 3.0, 0.75))
    k1, k2 = jax.random.split(key)
    draws = Replay([np.asarray(jax.random.uniform(k1, (6, 96, 2))),
                    np.asarray(jax.random.uniform(k2, (6, 8, 2)))])
    got = uncertainty_sampled_points(draws, torch.from_numpy(logits), 32, 3.0, 0.75)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["ties", "zero_region"])
def test_top_k_breaks_ties_as_lax_top_k(case):
    """Among equal uncertainties the lower candidate index wins, as in
    ``lax.top_k``: on values with many exact ties, and through
    ``uncertainty_sampled_points`` on logits that are exactly 0 (the most
    uncertain) over a region holding more candidates than are kept."""
    from openpvsg_tpu.ops.sampling import uncertainty_sampled_points as jax_pts
    from openpvsg_torch.ops.sampling import (top_k_indices,
                                             uncertainty_sampled_points)

    rng = np.random.default_rng(2)
    if case == "ties":
        values = rng.integers(0, 4, (5, 40)).astype(np.float32)
        _, want = jax.lax.top_k(values, 13)
        got = top_k_indices(torch.from_numpy(values), 13)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    logits = (2 + rng.random((3, 16, 16))).astype(np.float32)
    logits[:, :, 3:13] = 0.0
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_pts(key, logits, 32, 3.0, 0.75))
    k1, k2 = jax.random.split(key)
    draws = Replay([np.asarray(jax.random.uniform(k1, (3, 96, 2))),
                    np.asarray(jax.random.uniform(k2, (3, 8, 2)))])
    got = uncertainty_sampled_points(draws, torch.from_numpy(logits), 32, 3.0, 0.75)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# matching and loss
# ---------------------------------------------------------------------------

def _jax_point_costs(key, cls, mp, labels, masks, valid):
    """(L, B, Q, N) costs as ``_make_single``'s points branch
    (openpvsg_tpu/train/assign.py:230-244) computes them."""
    from openpvsg_tpu.ops.sampling import point_sample
    from openpvsg_tpu.train import assign as ja

    @jax.jit
    def single(k, cls_p, mask_p, lab, tgt, ok):
        pts = jax.random.uniform(k, (1, P, 2))
        mp_pts = point_sample(mask_p.reshape(Q, T * HM, HM)[..., None],
                              jnp.broadcast_to(pts, (Q, P, 2)))[..., 0]
        mt_pts = point_sample(tgt.reshape(N, T * HM, HM)[..., None],
                              jnp.broadcast_to(pts, (N, P, 2)))[..., 0]
        cost = (2.0 * ja.classification_cost(cls_p, lab)
                + 5.0 * ja.mask_bce_cost(mp_pts, mt_pts)
                + 5.0 * ja.dice_cost(mp_pts, mt_pts))
        return jnp.where(ok[None], cost, ja.BIG_COST)

    out = np.zeros((L, B, Q, N), np.float32)
    for layer in range(L):
        keys = jax.random.split(jax.random.split(jax.random.fold_in(key, layer))[0], B)
        for b in range(B):
            out[layer, b] = single(keys[b], cls[layer, b], mp[layer, b], labels[b],
                                   masks[b], valid[b])
    return out


def test_point_costs_match_jax():
    from openpvsg_torch.train.assign import assignment_costs

    cls, mp, labels, masks, valid = _preds()
    key = jax.random.PRNGKey(0)
    want = _jax_point_costs(key, cls, mp, labels, masks, valid)
    tc, tm, tmask, tvalid = _t(cls, mp, masks, valid)
    got = assignment_costs(tc, tm, torch.from_numpy(labels).long(), tmask, tvalid,
                           num_points=P, draw=Replay(jax_draws(key, L, B, Q, P)[:1]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("split", [False, True])
def test_point_assignments_bit_identical(split):
    from openpvsg_tpu.train.losses import _assign_all_layers
    from openpvsg_torch.train.assign import hungarian_assign_layers

    cls, mp, labels, masks, valid = _preds()
    key = jax.random.PRNGKey(0)
    want = np.asarray(_assign_all_layers(
        key, cls, mp, labels, masks, valid, P, 3 if split else None,
        2 if split else None))
    tc, tm, tmask, tvalid = _t(cls, mp, masks, valid)
    got = hungarian_assign_layers(tc, tm, torch.from_numpy(labels).long(), tmask, tvalid,
                                  num_points=P, draw=Replay(jax_draws(key, L, B, Q, P)[:1]),
                                  **_port_split_kw(split))
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0).sum(-1) == valid.sum(-1)[None]).all()
    # the stuff target 0 goes to a stuff query exactly when split
    assert ((got[:, :, 6:] == 0).any(-1) == split).all()


@pytest.mark.parametrize("split", [False, True])
def test_points_loss_logs_and_prediction_grads(split):
    """The points loss (assignment included) against JAX's in float64, the
    same draws replayed; logs rel 1e-5, gradients 1e-5 absolute."""
    from openpvsg_tpu.train.losses import mask2former_loss as jax_loss
    from openpvsg_torch.train.losses import mask2former_loss

    cls, mp, labels, masks, valid = _preds()
    key = jax.random.PRNGKey(0)

    def f(c, m):
        return jax_loss(key, c, m, labels, masks, valid, K, num_points=P,
                        assigner="hungarian", **_jax_split_kw(split))

    with jax.enable_x64(True):
        (want, want_logs), (g_cls, g_mp) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(cls.astype(np.float64), mp.astype(np.float64))
        draws = jax_draws(key, L, B, Q, P)
    tc, tm = (torch.from_numpy(a).requires_grad_() for a in (cls, mp))
    got, logs = mask2former_loss(tc, tm, torch.from_numpy(labels).long(),
                                 *_t(masks, valid), K, num_points=P,
                                 draw=Replay(draws), **_port_split_kw(split))
    got.backward()
    assert logs.keys() == want_logs.keys()
    for k in logs:
        np.testing.assert_allclose(logs[k].item(), float(want_logs[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(g_cls), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(g_mp), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the trainer: MSDA, points and split
# ---------------------------------------------------------------------------

def _tiny(m, **kw):
    """tests/test_torch_train.py's model with the MSDA encoder, points mode
    (64 points), the split, and one decoder layer."""
    base = dict(loss_sampling="points", num_points=P, split_thing_stuff=True)
    return m.Mask2FormerConfig(
        num_things_classes=3, num_stuff_classes=2, num_queries=8,
        backbone=m.BackboneConfig(depth=26, norm="sync_bn"),
        pixel_decoder=m.PixelDecoderConfig(encoder="msda", encoder_layers=1,
                                           ffn_channels=64),
        decoder=m.TransformerDecoderConfig(num_layers=1, ffn_channels=64),
        **{**base, **kw})


@pytest.fixture(scope="module")
def variables():
    """The JAX trainer's flax init, float32 parameters."""
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F

    model = JaxM2F(_tiny(jcfg), train=True, dtype=jnp.float64)
    with jax.enable_x64(True):
        variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, T, 64, 64, 3)))
    variables = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                       dict(variables))
    # flax starts the offsets on whole pixels, where bilinear sampling has a
    # kink: the two packages' roundings would pick different one-sided
    # derivatives there. Trained offsets are off the grid; so are these.
    attn = variables["params"]["pixel_decoder"]["encoder_layer_0_attn"]
    attn["sampling_offsets"]["bias"] += np.random.default_rng(9).uniform(
        -0.3, 0.3, attn["sampling_offsets"]["bias"].shape).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def jax_step(variables):
    """One step's loss, logs and gradients on ``variables`` from the JAX
    trainer's loss function computing in float64, rng PRNGKey(0)."""
    import openpvsg_tpu.train.segmenter as jseg
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F
    from openpvsg_tpu.train.losses import mask2former_loss

    cfg = _tiny(jcfg, assigner="hungarian")
    model = JaxM2F(cfg, train=True, dtype=jnp.float64)

    def loss_fn(params, batch_stats, batch):
        images = (batch["images"].astype(jnp.float32) - MEAN) / STD
        out, _ = model.apply({"params": params, "batch_stats": batch_stats},
                             images, mutable=["batch_stats"])
        return mask2former_loss(
            jax.random.PRNGKey(0), out["cls_preds"], out["mask_preds"],
            batch["gt_labels"], batch["gt_masks"].astype(jnp.float32),
            batch["gt_valid"], cfg.num_classes, num_points=cfg.num_points,
            oversample_ratio=cfg.oversample_ratio,
            importance_sample_ratio=cfg.importance_sample_ratio,
            assigner="hungarian", **_jax_split_kw(True))

    assert jseg.resolve_assigner(cfg) == "hungarian"
    with jax.enable_x64(True):
        (loss, logs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], _batch())
        draws = jax_draws(jax.random.PRNGKey(0), 2, B, Q, P)
    return {"loss": float(loss), "draws": draws,
            "logs": {k: float(v) for k, v in logs.items()},
            "grads": {path: np.asarray(g) for path, g in _flat(grads)}}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _port_trainer(variables, **kw):
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import from_jax_params

    return SegmenterTrainer(_tiny(tcfg), tcfg.TrainConfig(warmup_iters=1),
                            steps_per_epoch=10, device="cpu",
                            state_dict=from_jax_params(variables, _tiny(tcfg)), **kw)


def test_trainer_step_msda_points_split_matches_jax(variables, jax_step):
    trainer = _port_trainer(variables)
    trainer.draw = Replay(jax_step["draws"])
    loss, logs = trainer.loss_and_grads(_batch())
    np.testing.assert_allclose(loss.item(), jax_step["loss"], rtol=1e-4)
    for k, v in jax_step["logs"].items():
        np.testing.assert_allclose(logs[k].item(), v, rtol=1e-4, atol=1e-6, err_msg=k)
    got = _port_grads(trainer)
    assert got.keys() == jax_step["grads"].keys()
    for path, g in jax_step["grads"].items():
        _close_to_scale(got[path], g, 1e-4, atol=1e-6, msg="/".join(path))
    assert any("encoder_layer_0_attn" in p for p in got)
    assert (trainer.last_assigned[:, :, 6:] >= 0).any()


def test_points_checkpoint_round_trip_is_bitwise(variables, tmp_path, one_intra_op_thread):
    """A resumed points-mode trainer takes the same next step, its points
    generator's state included (the second trainer starts from another
    seed)."""
    from openpvsg_torch.train.checkpoint import load_checkpoint, save_checkpoint

    batch = _batch()
    a = _port_trainer(variables)
    a.step(batch)
    path = os.path.join(tmp_path, "ckpt.pt")
    save_checkpoint(path, a)
    logs_a = a.step(batch)
    b = _port_trainer(variables, seed=1)
    assert not torch.equal(a.generator.get_state(), b.generator.get_state())
    assert load_checkpoint(path, b) == 1
    logs_b = b.step(batch)
    assert logs_a == logs_b
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,value", [
    ("loss_sampling", "points"), ("split_thing_stuff", True), ("num_points", 32),
    ("oversample_ratio", 2.0), ("importance_sample_ratio", 0.5)])
def test_training_values_now_train(field, value):
    """Each value that now trains builds a trainer, and changes its loss
    as it changes JAX's: the trainer's objective on fixed predictions, with
    JAX's draws replayed, equals JAX's loss for the same configuration with
    the value and without it (dense, no split, 64 points, oversampling 3,
    importance 0.75), and the two differ."""
    from openpvsg_torch.train.segmenter import SegmenterTrainer

    base = dict(loss_sampling="dense", num_points=P, split_thing_stuff=False)
    if field not in ("loss_sampling", "split_thing_stuff"):
        base["loss_sampling"] = "points"
    cls, mp, labels, masks, valid = _preds()
    losses = {}
    for name, kw in (("base", base), ("value", {**base, field: value})):
        cfg = _tiny(tcfg, **kw)
        trainer = SegmenterTrainer(cfg, tcfg.TrainConfig(), device="cpu")
        points = cfg.num_points if cfg.loss_sampling == "points" else 0
        knobs = (points, cfg.oversample_ratio, cfg.importance_sample_ratio)
        trainer.draw = Replay(jax_draws(jax.random.PRNGKey(0), L, B, Q, *knobs)
                              if points else [])
        got, _ = trainer.loss(*_t(cls, mp), torch.from_numpy(labels).long(),
                              *_t(masks, valid))
        want = _jax_loss(*knobs, cfg.split_thing_stuff)
        np.testing.assert_allclose(got.item(), want, rtol=1e-5, err_msg=name)
        losses[name] = got.item()
    assert losses["value"] != losses["base"]


@functools.lru_cache(maxsize=None)
def _jax_loss(num_points, oversample_ratio, importance_sample_ratio, split):
    """JAX's loss of ``_preds()`` for one configuration, rng PRNGKey(0)."""
    from openpvsg_tpu.train.losses import mask2former_loss

    loss, _ = jax.jit(functools.partial(
        mask2former_loss, num_classes=K, num_points=num_points,
        oversample_ratio=oversample_ratio,
        importance_sample_ratio=importance_sample_ratio, assigner="hungarian",
        **_jax_split_kw(split)))(jax.random.PRNGKey(0), *_preds())
    return float(loss)


@pytest.mark.parametrize("field,value", [("match_downsample", 2), ("loss_layout", "target")])
def test_points_combinations_raise_as_jax(field, value):
    """The two combinations the JAX package refuses with points raise its
    errors; without points the values are still refused, naming A9c."""
    from openpvsg_tpu.train.segmenter import check_assigner_capacity
    from openpvsg_torch.config import check_training_config

    with pytest.raises(ValueError) as want:
        check_assigner_capacity(jcfg.Mask2FormerConfig(
            loss_sampling="points", assigner="hungarian", **{field: value}), 0)
    with pytest.raises(ValueError) as got:
        check_training_config(tcfg.Mask2FormerConfig(loss_sampling="points",
                                                     **{field: value}))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=rf"model\.{field}=.*ROADMAP\.md A9c"):
        check_training_config(tcfg.Mask2FormerConfig(**{field: value}))
