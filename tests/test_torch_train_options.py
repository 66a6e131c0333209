"""The segmenter trainer's options in the PyTorch port against the JAX
package on the CPU: the device assigners (LAPJV, greedy), pooled matching
(``match_downsample``), the target loss layout, the focal classification
loss, the semantic head's loss and bfloat16 mask logits.

Assignments of the device solvers are held bit-identical to JAX's on random
costs, with ties (small integer costs), invalid padded targets, N = Q and
N = 0; LAPJV's objective to the host Hungarian's. The loss pieces are held
to JAX as tests/test_torch_train.py holds the dense loss (logs rel 1e-5,
prediction gradients 1e-5 absolute).

One trainer step per option: the port's float32 step against the JAX
trainer's objective in float64, which is its loss of its model's
predictions. The JAX side is computed in two pieces, sharing one compiled
model: the model's forward and VJP (float64 compute, float32 parameters,
as the JAX trainer of tests/test_torch_train.py), and the option's loss
and its gradient with respect to the predictions. Their chain is the JAX
trainer's gradient. The model carries the semantic head in every case
(``with_sem_seg``); its loss is added only where the batch has
``gt_semantic``. Tolerances: tests/test_torch_train.py's, loss rel 1e-4
and every gradient rel 1e-4 of its scale plus 1e-6; with bfloat16 mask
logits, bfloat16's: rel 1e-2 for the loss and of each gradient's scale
(bfloat16 keeps 8 significant bits, a relative rounding of 2^-9 = 2e-3;
the two sides round a float32 and a float64 sum, so an element on a
rounding boundary differs by one bfloat16 step).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

from test_torch_train import (B, H, MEAN, STD, T, W, _batch, _close_to_scale,
                              _flat, _port_grads, _separated_preds,
                              _train_cfg)

BF16_REL = 1e-2


def _cfg(m, **kw):
    """tests/test_torch_train.py's tiny VPS model with the semantic head."""
    return m.Mask2FormerConfig(
        num_things_classes=3, num_stuff_classes=2, num_queries=8,
        backbone=m.BackboneConfig(depth=26, norm="sync_bn"),
        pixel_decoder=m.PixelDecoderConfig(encoder_layers=1, ffn_channels=64),
        decoder=m.TransformerDecoderConfig(num_layers=3, ffn_channels=64),
        with_sem_seg=True, **kw)


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# the device assigners
# ---------------------------------------------------------------------------

def _costs(case, rng, P=6):
    """(P, Q, N) float32 costs of a named case, BIG_COST at invalid targets."""
    from openpvsg_torch.train.assign import BIG_COST

    Q, N = {"square": (7, 7), "empty": (8, 0)}.get(case, (9, 5))
    if case == "ties":  # small integers: many equal costs and paths
        c = rng.integers(0, 4, (P, Q, N)).astype(np.float32)
    else:
        c = (rng.standard_normal((P, Q, N)) * 3).astype(np.float32)
    if case == "padded":
        for p in range(P):
            c[p, :, rng.permutation(N)[:p % 3 + 1]] = BIG_COST
        c[0] = BIG_COST  # every target padded
    return c


@pytest.mark.parametrize("method", ["lapjv", "greedy"])
@pytest.mark.parametrize("case", ["random", "ties", "padded", "square", "empty"])
def test_device_assigners_bit_identical_to_jax(method, case, rng):
    from openpvsg_tpu.train import assign as jassign
    from openpvsg_torch.train import assign

    c = _costs(case, rng)
    P, Q, N = c.shape
    if method == "lapjv":
        got = assign.lapjv_assign_from_cost(torch.from_numpy(c), check_every=3)
        jax_fn = jassign.lapjv_assign_from_cost
    else:
        got = assign.greedy_assign_from_cost(torch.from_numpy(c), min(Q, N))
        jax_fn = functools.partial(jassign.greedy_assign_from_cost,
                                   n_iters=min(Q, N))
    if N == 0:
        # JAX's solvers cannot trace an empty target axis (LAPJV reads
        # column 0, greedy's argmin is over nothing); the port leaves every
        # query unassigned, as the host Hungarian does
        with pytest.raises((IndexError, ValueError)):
            jax_fn(jnp.asarray(c[0]))
        want = np.stack([assign._host_lap(c[p]) for p in range(P)])
        assert (want == -1).all()
    else:
        want = jax.jit(jax.vmap(jax_fn))(c)
    assert got.dtype == torch.int32 and tuple(got.shape) == (P, Q)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    valid = c[:, 0, :] < assign.BIG_COST / 2 if N else np.zeros((P, 0), bool)
    for p in range(P):  # one-to-one onto the valid targets
        a = _np(got[p])
        taken = a[a >= 0]
        assert len(set(taken)) == len(taken) and valid[p, taken].all()
        if method == "lapjv":
            assert len(taken) == valid[p].sum()


def test_lapjv_objective_equals_host_hungarian(rng):
    from openpvsg_torch.train.assign import _host_lap, lapjv_assign_from_cost

    for case in ("random", "ties", "padded", "square"):
        c = _costs(case, rng, P=10)
        got = _np(lapjv_assign_from_cost(torch.from_numpy(c)))
        for p in range(c.shape[0]):
            ref = _host_lap(c[p])
            assert (got[p] >= 0).sum() == (ref >= 0).sum()
            cost = lambda a: sum(float(c[p, q, a[q]]) for q in np.flatnonzero(a >= 0))
            np.testing.assert_allclose(cost(got[p]), cost(ref), rtol=1e-6, atol=1e-5)


def test_chip_smoke_lapjv_tie_rule(rng):
    """chip_smoke.py's rule for LAPJV against the host Hungarian: a problem
    where the two assignments differ passes only at the host's optimum
    within LAPJV_TIE_TOL and one-to-one onto the valid targets. LAPJV's own
    choices pass; a swap of two rows of random costs and a dropped target
    do not."""
    import chip_smoke
    from openpvsg_torch.train.assign import _host_lap, lapjv_assign_from_cost

    for case in ("random", "ties", "padded", "square"):
        c = _costs(case, rng, P=10)
        got = _np(lapjv_assign_from_cost(torch.from_numpy(c)))[None]
        host = np.stack([_host_lap(p) for p in c])[None]
        assert all(r["ok"] for r in chip_smoke.lapjv_ties(np, c[None], got, host))
    c = _costs("random", rng, P=1)[None]
    got = _np(lapjv_assign_from_cost(torch.from_numpy(c[0])))[None]
    host = _host_lap(c[0, 0])[None, None]
    swapped, dropped = got.copy(), got.copy()
    i, j = np.flatnonzero(got[0, 0] >= 0)[:2]
    swapped[0, 0, [i, j]] = got[0, 0, [j, i]]
    dropped[0, 0, i] = -1
    for bad in (swapped, dropped):
        rows = chip_smoke.lapjv_ties(np, c, bad, host)
        assert len(rows) == 1 and not rows[0]["ok"], rows


def test_lapjv_capacity_raises_as_jax(rng):
    """N > Q raises; with the split, the stuff queries are one problem
    whose Q is checked, so 3 targets over 2 stuff queries raise as JAX's
    split assigner does."""
    from openpvsg_tpu.train import assign as jassign
    from openpvsg_tpu.train.losses import _assign_all_layers
    from openpvsg_torch.train import assign

    c = rng.standard_normal((4, 6)).astype(np.float32)
    with pytest.raises(ValueError) as want:
        jassign.lapjv_assign_from_cost(jnp.asarray(c))
    with pytest.raises(ValueError) as got:
        assign.lapjv_assign_from_cost(torch.from_numpy(c)[None])
    assert str(got.value) == str(want.value)

    cls, mp, labels, masks, valid = _separated_preds(rng)
    kw = dict(num_things_classes=3)
    with pytest.raises(ValueError) as want:
        _assign_all_layers(jax.random.PRNGKey(0), cls, mp, labels, masks, valid,
                           0, kw["num_things_classes"], 2, method="lapjv")
    with pytest.raises(ValueError) as got:
        assign.hungarian_assign_layers(
            *(torch.from_numpy(a) for a in (cls, mp)),
            torch.from_numpy(labels).long(), torch.from_numpy(masks),
            torch.from_numpy(valid), num_stuff_queries=2, method="lapjv", **kw)
    assert str(got.value) == str(want.value) == "lapjv assigner needs N <= Q, got (Q=2, N=3)"


@pytest.mark.parametrize("method", ["lapjv", "greedy"])
@pytest.mark.parametrize("split", [False, True])
def test_layer_assignments_match_jax(method, split, rng):
    """hungarian_assign_layers by method, with and without the split,
    against JAX's ``_assign_all_layers`` on the same predictions."""
    from openpvsg_tpu.train.losses import _assign_all_layers
    from openpvsg_torch.train.assign import hungarian_assign_layers

    cls, mp, labels, masks, valid = _separated_preds(rng)
    n_stuff = 4 if split else 0
    want = _assign_all_layers(jax.random.PRNGKey(0), cls, mp, labels, masks,
                              valid, 0, 3 if split else None,
                              n_stuff if split else None, method=method)
    got = hungarian_assign_layers(*(torch.from_numpy(a) for a in (cls, mp)),
                                  torch.from_numpy(labels).long(),
                                  torch.from_numpy(masks), torch.from_numpy(valid),
                                  num_stuff_queries=n_stuff, num_things_classes=3,
                                  method=method)
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# pooled matching, the target layout, focal, semantic
# ---------------------------------------------------------------------------

def test_pool_masks_and_pooled_assignment_match_jax(rng):
    from openpvsg_tpu.train import assign as jassign
    from openpvsg_torch.train import assign

    x = rng.standard_normal((2, 3, 2, 8, 12)).astype(np.float32)
    for d in (1, 2, 4):
        np.testing.assert_allclose(_np(assign.pool_masks(torch.from_numpy(x), d)),
                                   np.asarray(jassign.pool_masks(x, d)),
                                   rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="must divide"):
        assign.pool_masks(torch.from_numpy(x), 3)
    cls, mp, labels, masks, valid = _separated_preds(rng)
    keys = jnp.zeros((cls.shape[0], B, 2), jnp.uint32)
    want = jassign.hungarian_assign_layers(keys, cls, mp, labels, masks, valid,
                                           num_points=0, match_downsample=2)
    got = assign.hungarian_assign_layers(
        *(torch.from_numpy(a) for a in (cls, mp)), torch.from_numpy(labels).long(),
        torch.from_numpy(masks), torch.from_numpy(valid), match_downsample=2)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_invert_assignment_matches_jax():
    from openpvsg_tpu.train.losses import invert_assignment as jax_inv
    from openpvsg_torch.train.losses import invert_assignment

    a = np.array([[2, -1, 0, -1, 4], [-1, -1, -1, -1, -1], [0, 1, 2, 3, 4]], np.int32)
    got = invert_assignment(torch.from_numpy(a), 5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(jax_inv(a, 5)))


def _loss_pair(rng, jax_kw, port_kw, sem=False):
    """JAX's and the port's mask2former_loss on the same predictions: (JAX
    logs, JAX prediction gradients, port logs, port gradients)."""
    from openpvsg_tpu.train.losses import mask2former_loss as jax_loss
    from openpvsg_torch.train.losses import mask2former_loss

    cls, mp, labels, masks, valid = _separated_preds(rng)
    K = cls.shape[-1] - 1
    sem_logits = rng.standard_normal((B, T, 16, 16, K + 1)).astype(np.float32)
    gt_sem = rng.integers(0, K + 1, (B, T, 16, 16)).astype(np.int32)

    def f(c, m, s):
        return jax_loss(jax.random.PRNGKey(0), c, m, labels, masks, valid, K,
                        num_points=0, assigner="hungarian",
                        sem_seg_logits=s if sem else None,
                        gt_semantic=gt_sem if sem else None, **jax_kw)

    (_, want_logs), want_grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(cls, mp, sem_logits)
    tc, tm, ts = (torch.from_numpy(a).requires_grad_() for a in (cls, mp, sem_logits))
    got, logs = mask2former_loss(
        tc, tm, torch.from_numpy(labels).long(), torch.from_numpy(masks),
        torch.from_numpy(valid), K,
        sem_seg_logits=ts if sem else None,
        gt_semantic=torch.from_numpy(gt_sem) if sem else None, **port_kw)
    got.backward()
    logs["loss"] = got
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in (tc, tm, ts)]
    return want_logs, want_grads, logs, grads


@pytest.mark.parametrize("option", ["target", "focal", "sem_seg"])
def test_option_losses_match_jax(option, rng):
    """Each option's logs and prediction gradients against JAX; the target
    layout also against the port's own query layout (the same sums)."""
    kw = {"target": dict(loss_layout="target"),
          "focal": dict(focal=True, focal_gamma=1.5, focal_alpha=0.3),
          "sem_seg": dict(sem_seg_weight=0.7)}[option]
    want_logs, want_grads, logs, grads = _loss_pair(rng, kw, kw,
                                                    sem=option == "sem_seg")
    assert set(logs) - {"loss"} == set(want_logs)
    assert ("loss_sem_seg" in logs) == (option == "sem_seg")
    for k, v in want_logs.items():
        np.testing.assert_allclose(logs[k].item(), float(v), rtol=1e-5, err_msg=k)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=1e-5)
    if option == "target":
        _, _, q_logs, q_grads = _loss_pair(np.random.default_rng(0), {}, {})
        _, _, t_logs, t_grads = _loss_pair(np.random.default_rng(0), kw, kw)
        for k, v in q_logs.items():
            np.testing.assert_allclose(t_logs[k].item(), v.item(), rtol=1e-6, err_msg=k)
        for g, w in zip(t_grads, q_grads):
            np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=1e-7)


@pytest.mark.parametrize("train", [False, True])
def test_bf16_mask_logits_are_the_float32_logits_rounded(train):
    """``mask_logits_dtype='bfloat16'`` stores the float32-accumulated
    logits rounded to bfloat16, in the eval and the train forward; nothing
    else changes."""
    from openpvsg_torch.models.mask2former import Mask2Former
    from openpvsg_torch.weights import random_state_dict

    cfg = _cfg(tcfg)
    state = random_state_dict(cfg, 0)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, T, H, W, 3) if train else (2, H, W, 3)).astype(np.float32))
    outs = []
    for dtype in ("float32", "bfloat16"):
        model = Mask2Former(dataclasses.replace(cfg, mask_logits_dtype=dtype), train=train)
        model.load_state_dict(state)
        with torch.no_grad():
            outs.append(model(x, return_sem_seg=True))
    (cls32, m32, q32, sem32), (cls16, m16, q16, sem16) = outs
    assert m16.dtype == torch.bfloat16 and m32.dtype == torch.float32
    assert torch.equal(m16, m32.to(torch.bfloat16))
    for a, b in ((cls16, cls32), (q16, q32), (sem16, sem32)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# one trainer step per option
# ---------------------------------------------------------------------------

OPTIONS = {
    "lapjv": dict(assigner="lapjv"),
    "greedy": dict(assigner="greedy"),
    "match_downsample": dict(match_downsample=2),
    "target_layout": dict(loss_layout="target"),
    "focal": dict(focal_cls=True, focal_gamma=1.5, focal_alpha=0.3),
    "sem_seg": dict(sem_seg_weight=0.7),
    "bf16_mask_logits": dict(mask_logits_dtype="bfloat16"),
}


def _gt_semantic():
    return np.random.default_rng(9).integers(0, 6, (B, T, H // 4, W // 4)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_model():
    """The tiny model with the semantic head in the JAX package: float32
    parameters from a jitted flax init, the batch's images, and one jitted
    function of cotangents -> (predictions, parameter gradients), computing
    in float64: the VJP of the JAX trainer's forward."""
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F

    model = JaxM2F(_cfg(jcfg), train=True, dtype=jnp.float64)
    images = (_batch()["images"].astype(np.float32) - MEAN) / STD
    with jax.enable_x64(True):
        variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, T, H, W, 3)))
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), variables)

    def fwd(params):
        out, _ = model.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             images, mutable=["batch_stats"])
        return out["cls_preds"], out["mask_preds"], out["sem_seg"]

    @jax.jit
    def fwd_vjp(cts):
        out, vjp = jax.vjp(fwd, variables["params"])
        return out, vjp(cts)[0]

    with jax.enable_x64(True):
        zeros = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype),
                                       jax.eval_shape(fwd, variables["params"]))
        preds, _ = fwd_vjp(zeros)
    return variables, preds, fwd_vjp


def _jax_option_step(jax_model, cfg, gt_semantic):
    """(loss, logs, assignment, gradients by flax path) of the JAX trainer's
    objective for ``cfg`` on tests/test_torch_train.py's batch: its loss
    function (``openpvsg_tpu/train/segmenter.py:235-288``) differentiated
    with respect to the predictions, then pulled back through the model."""
    from openpvsg_tpu.train.losses import _assign_all_layers, mask2former_loss

    _, (cls, masks, sem), fwd_vjp = jax_model
    batch = _batch()
    bf16 = cfg.mask_logits_dtype == "bfloat16"
    gt_masks = jnp.asarray(batch["gt_masks"]).astype(
        jnp.bfloat16 if bf16 else jnp.float32)
    method = "hungarian" if cfg.assigner == "auto" else cfg.assigner

    def stored(m):  # the model stores the mask logits in bfloat16 with the knob
        return m.astype(jnp.bfloat16) if bf16 else m

    def loss_fn(c, m, s):
        return mask2former_loss(
            jax.random.PRNGKey(0), c, stored(m), batch["gt_labels"], gt_masks,
            batch["gt_valid"], cfg.num_classes, num_points=0, assigner=method,
            match_downsample=cfg.match_downsample, loss_layout=cfg.loss_layout,
            focal=cfg.focal_cls, focal_gamma=cfg.focal_gamma,
            focal_alpha=cfg.focal_alpha, sem_seg_logits=s,
            gt_semantic=gt_semantic, sem_seg_weight=cfg.sem_seg_weight,
            cls_weight=cfg.loss_cls_weight, mask_weight=cfg.loss_mask_weight,
            dice_weight=cfg.loss_dice_weight, bg_cls_weight=cfg.bg_cls_weight)

    with jax.enable_x64(True):
        (loss, logs), cts = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1, 2), has_aux=True))(cls, masks, sem)
        _, grads = fwd_vjp(cts)
        assigned = _assign_all_layers(
            jax.random.PRNGKey(0), cls, stored(masks), batch["gt_labels"],
            gt_masks, batch["gt_valid"], 0, method=method,
            match_downsample=cfg.match_downsample)
    return (float(loss), {k: float(v) for k, v in logs.items()},
            np.asarray(assigned), dict(_flat(grads)))


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_trainer_step_matches_jax(jax_model, option):
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import from_jax_params

    variables = jax_model[0]
    jax_cfg = _cfg(jcfg, **OPTIONS[option])
    gt_semantic = _gt_semantic() if option == "sem_seg" else None
    loss_w, logs_w, assigned_w, grads_w = _jax_option_step(jax_model, jax_cfg,
                                                           gt_semantic)
    cfg = _cfg(tcfg, **OPTIONS[option])
    trainer = SegmenterTrainer(cfg, _train_cfg(tcfg), steps_per_epoch=10,
                               device="cpu",
                               state_dict=from_jax_params(variables, cfg))
    batch = _batch()
    if gt_semantic is not None:
        batch["gt_semantic"] = gt_semantic
    loss, logs = trainer.loss_and_grads(batch)
    np.testing.assert_array_equal(trainer.last_assigned, assigned_w)
    rel = BF16_REL if option == "bf16_mask_logits" else 1e-4
    np.testing.assert_allclose(loss.item(), loss_w, rtol=rel)
    assert set(logs) == set(logs_w) | {"loss"}
    for k, v in logs_w.items():
        np.testing.assert_allclose(logs[k].item(), v, rtol=rel, atol=1e-6, err_msg=k)
    got = _port_grads(trainer)
    assert got.keys() == grads_w.keys()
    for path, g in grads_w.items():
        _close_to_scale(got[path], g, rel, atol=1e-6, msg="/".join(path))
    sem_grad = got[("sem_seg_head", "kernel")]
    assert (np.abs(sem_grad).max() > 0) == (option == "sem_seg")
