"""Stage-1 training in bfloat16 compute (``model.backbone.dtype``) in the
PyTorch port against the JAX package's bfloat16 trainer on the CPU: the
same float32 weights (a flax init through ``from_jax_params``) and the same
numpy batch, R-26, 8 queries, 64x64 clips of T=2, B=2, N=3
(tests/test_torch_train.py's model).

The JAX side is ``SegmenterTrainer(..., compute_dtype=jnp.bfloat16)``'s
model and loss: flax mixed precision, float32 parameters. XLA's CPU
backend keeps some intermediates in float32 where the port rounds them to
bfloat16 (excess precision), and the tiny random model's attention masks
(logits >= 0) flip under such rounding, so the two packages' bfloat16
results differ by the size of bfloat16's own error, not by float32's.
Each comparison is therefore held to that error: the port's distance to
JAX's bfloat16 result may be at most twice JAX's bfloat16 distance to the
float32 result plus 1e-2 of the quantity's scale (``_within_bf16``). The
float32 result is the port's float32 trainer, which
tests/test_torch_train.py holds to the JAX trainer in float64 at 1e-4 of
scale. The loss is also held to 1e-2 relative. Predictions, loss and
gradients are compared under the assignment JAX's loss made; the
gradients of the last decoder layer need up to six times JAX's own error
(``test_bf16_every_gradient``). The assignments are compared on their own:
both packages' assigners on the same bfloat16 predictions, and the
trainer's own assignment with the margins of its near-ties. One AdamW
apply on the port's gradients equals optax's. The MSDA + points + split
and the Swin-T models are compared by forward and loss in
tests/test_torch_train_bf16_models.py.
"""
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

from test_torch_train import (MEAN, STD, T, H, W, B, _batch, _flat,
                              _port_grads, _tiny, _train_cfg)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread (and bitwise-repeatable CPU
    backwards of advanced indexing), restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _within_bf16(got, want, ref, msg=""):
    """|got - want| <= 2 |want - ref| + 1e-2 * scale, each the largest
    elementwise value: got is the port's bfloat16 result, want JAX's, ref
    the float32 one."""
    got, want, ref = (np.asarray(a, np.float64) for a in (got, want, ref))
    scale = np.abs(ref).max()
    gap, own = np.abs(got - want).max(), np.abs(want - ref).max()
    assert gap <= 2 * own + 1e-2 * scale, (msg, gap, own, scale)


def _bf16(cfg):
    return tcfg.apply_overrides(cfg, {"backbone.dtype": "bfloat16"})


def _init(cfg):
    """The JAX model's flax init as float32 numpy, jitted."""
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F

    variables = jax.jit(JaxM2F(cfg, train=True).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, T, H, W, 3)))
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), dict(variables))


def _jax_loss_fn(cfg, dtype):
    """The JAX trainer's loss function (``segmenter.py:237-291``) at the
    compute dtype, returning the predictions too."""
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F
    from openpvsg_tpu.train.losses import mask2former_loss

    model = JaxM2F(cfg, train=True, dtype=dtype)

    def loss_fn(params, batch_stats, batch):
        images = (batch["images"].astype(jnp.float32) - MEAN) / STD
        out, _ = model.apply({"params": params, "batch_stats": batch_stats},
                             images, mutable=["batch_stats"])
        loss, logs = mask2former_loss(
            jax.random.PRNGKey(0), out["cls_preds"], out["mask_preds"],
            batch["gt_labels"], batch["gt_masks"].astype(jnp.float32),
            batch["gt_valid"], cfg.num_classes,
            num_points=cfg.num_points if cfg.loss_sampling == "points" else 0,
            oversample_ratio=cfg.oversample_ratio,
            importance_sample_ratio=cfg.importance_sample_ratio,
            assigner="hungarian", split_thing_stuff=cfg.split_thing_stuff,
            num_things_classes=cfg.num_things_classes,
            num_stuff_classes=cfg.num_stuff_classes)
        return loss, (logs, out["cls_preds"], out["mask_preds"])

    return loss_fn


def _port_trainer(cfg, variables, bf16=True, train_cfg=None):
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import from_jax_params

    return SegmenterTrainer(_bf16(cfg) if bf16 else cfg,
                            train_cfg or _train_cfg(tcfg),
                            steps_per_epoch=10, device="cpu",
                            state_dict=from_jax_params(variables, cfg))


def _jax_assignment(cfg, cls, masks, batch):
    """The assignment JAX's loss makes of its predictions (rng PRNGKey(0),
    which points mode draws from)."""
    from openpvsg_tpu.train.losses import _assign_all_layers

    split = cfg.split_thing_stuff
    return np.asarray(_assign_all_layers(
        jax.random.PRNGKey(0), cls, masks, batch["gt_labels"],
        batch["gt_masks"].astype(np.float32), batch["gt_valid"],
        cfg.num_points if cfg.loss_sampling == "points" else 0,
        cfg.num_things_classes if split else None,
        cfg.num_stuff_classes if split else None, method="hungarian"))


def _port_first(trainer, assigned, draws=()):
    """The port trainer's forward and its objective's loss, logs and
    gradients under ``assigned`` (L, B, Q): the trainer's ``loss`` with
    the assignment given instead of solved. Points mode replays ``draws``
    (the layers' candidates and random points)."""
    from openpvsg_torch.train.losses import mask2former_loss
    from test_torch_points import Replay

    cfg = trainer.cfg
    images, gt_labels, gt_masks, gt_valid = trainer.device_batch(_batch())
    cls, masks, _ = trainer.model(images)
    loss, logs = mask2former_loss(
        cls, masks, gt_labels, gt_masks, gt_valid, cfg.num_classes,
        cls_weight=cfg.loss_cls_weight, mask_weight=cfg.loss_mask_weight,
        dice_weight=cfg.loss_dice_weight, bg_cls_weight=cfg.bg_cls_weight,
        assigned=assigned,
        num_points=cfg.num_points if cfg.loss_sampling == "points" else 0,
        oversample_ratio=cfg.oversample_ratio,
        importance_sample_ratio=cfg.importance_sample_ratio,
        draw=Replay(draws), num_stuff_queries=(cfg.num_stuff_classes
                                               if cfg.split_thing_stuff else 0),
        num_things_classes=cfg.num_things_classes)
    trainer.optimizer.zero_grad(set_to_none=False)
    loss.backward()
    return {"loss": loss.item(), "logs": {k: v.item() for k, v in logs.items()},
            "cls": cls.detach().float().numpy(), "masks": masks.detach().numpy(),
            "cls_dtype": cls.dtype, "masks_dtype": masks.dtype,
            "grads": _port_grads(trainer)}


@pytest.fixture(scope="module")
def axial():
    """The R-26 axial model: its init, JAX's bfloat16 first step (loss,
    logs, predictions, gradients from a jitted value-and-grad, and the
    assignment its loss made), and the port's first step in bfloat16 and
    in float32 (the reference) under that assignment."""
    variables = _init(_tiny(jcfg))
    fn = jax.jit(jax.value_and_grad(
        _jax_loss_fn(_tiny(jcfg, assigner="hungarian"), jnp.bfloat16),
        has_aux=True))
    (loss, (logs, cls, masks)), grads = fn(variables["params"],
                                           variables["batch_stats"], _batch())
    assigned = _jax_assignment(_tiny(jcfg), cls, masks, _batch())
    return {"variables": variables, "loss": float(loss), "assigned": assigned,
            "logs": {k: float(v) for k, v in logs.items()},
            "cls": np.asarray(cls), "masks": np.asarray(masks),
            "grads": dict(_flat(grads)),
            "port": {name: _port_first(_port_trainer(_tiny(tcfg), variables, bf16),
                                       assigned)
                     for name, bf16 in (("bf16", True), ("f32", False))}}


def test_bf16_forward_matches_jax(axial):
    """cls logits (bfloat16, as flax's Dense returns them) and the float32
    mask logits of all L+1 layers."""
    bf, ref = axial["port"]["bf16"], axial["port"]["f32"]
    assert bf["cls_dtype"] == torch.bfloat16 and str(axial["cls"].dtype) == "bfloat16"
    assert bf["masks_dtype"] == torch.float32 and axial["masks"].dtype == np.float32
    assert bf["cls"].shape == axial["cls"].shape == (4, B, 8, 6)
    _within_bf16(bf["cls"], axial["cls"].astype(np.float32), ref["cls"], "cls")
    _within_bf16(bf["masks"], axial["masks"], ref["masks"], "masks")
    assert np.abs(bf["cls"] - ref["cls"]).max() > 0  # bfloat16 did compute


def test_bf16_loss_and_logs(axial):
    """Under JAX's assignment: the loss to 1e-2 relative, each log key by
    ``_within_bf16``."""
    bf, ref = axial["port"]["bf16"], axial["port"]["f32"]
    np.testing.assert_allclose(bf["loss"], axial["loss"], rtol=1e-2)
    assert bf["logs"].keys() == axial["logs"].keys()
    for k, v in axial["logs"].items():
        _within_bf16(bf["logs"][k], v, ref["logs"][k], k)


def test_bf16_assignment_of_bf16_predictions():
    """Both packages' assigners on the same bfloat16 class logits (flax's
    Dense output) and float32 mask logits, separated as
    tests/test_torch_train.py's ``_separated_preds``: bit-identical, and
    every problem's optimum beats the next-best assignment by more than
    twice what the class cost's bfloat16 rounding can move a total (the
    port's softmax widens the logits to float32, JAX's stays in
    bfloat16)."""
    from openpvsg_tpu.train.assign import hungarian_assign_layers as jax_assign
    from openpvsg_torch.train.assign import (assignment_costs,
                                             hungarian_assign_layers)
    from test_torch_train import _separated_preds

    cls, mp, labels, masks, valid = _separated_preds(np.random.default_rng(11))
    cls_bf = jnp.asarray(cls, jnp.bfloat16)
    want = np.asarray(jax_assign(jnp.zeros((cls.shape[0], B, 2), jnp.uint32),
                                 cls_bf, mp, labels, masks, valid, num_points=0,
                                 method="hungarian"))
    args = (torch.from_numpy(np.asarray(cls_bf, np.float32)).to(torch.bfloat16),
            torch.from_numpy(mp), torch.from_numpy(labels).long(),
            torch.from_numpy(masks), torch.from_numpy(valid))
    np.testing.assert_array_equal(hungarian_assign_layers(*args), want)
    costs = assignment_costs(*args).numpy()
    for layer, b in itertools.product(range(cls.shape[0]), range(B)):
        cols = np.flatnonzero(valid[b])
        totals = sorted(costs[layer, b][list(rows), cols].sum() for rows in
                        itertools.permutations(range(cls.shape[2]), len(cols)))
        # the class cost is 2 * softmax, rounded to bfloat16 in JAX: < 2**-8
        # per entry, so a total moves by less than N * 2**-8
        assert totals[1] - totals[0] > 2 * len(cols) * 2.0 ** -8


def test_bf16_trainer_assignment(axial):
    """The bfloat16 trainer's own assignment against the one JAX's loss made
    of its predictions: the tiny random model's queries are close to one
    another, and the two packages' bfloat16 predictions differ by
    bfloat16's error (``test_bf16_forward_matches_jax``), so a problem may
    be a near-tie that the two order differently. At least half of the
    eight (layer, item) problems are equal (five here). In each other one the port's choice
    costs, under the costs of JAX's predictions, at most twice what the
    difference of the two packages' costs can move a total (N times its
    largest entry) above JAX's optimum: the margin JAX's choice had there
    was smaller than that difference."""
    from openpvsg_torch.train.assign import assignment_costs

    trainer = _port_trainer(_tiny(tcfg), axial["variables"])
    trainer.loss_and_grads(_batch())
    got, want = trainer.last_assigned, axial["assigned"]
    batch = _batch()
    mine, theirs = (assignment_costs(
        torch.from_numpy(c.astype(np.float32)).to(torch.bfloat16),
        torch.from_numpy(m), torch.from_numpy(batch["gt_labels"]).long(),
        torch.from_numpy(batch["gt_masks"]).float(),
        torch.from_numpy(batch["gt_valid"])).numpy()
        for c, m in ((axial["port"]["bf16"]["cls"], axial["port"]["bf16"]["masks"]),
                     (axial["cls"], axial["masks"])))
    equal = 0
    for layer, b in itertools.product(range(4), range(B)):
        if np.array_equal(got[layer, b], want[layer, b]):
            equal += 1
            continue
        cols = np.flatnonzero(batch["gt_valid"][b])
        moved = len(cols) * np.abs(mine[layer, b][:, cols]
                                   - theirs[layer, b][:, cols]).max()
        c = theirs[layer, b]
        total = [c[np.flatnonzero(a >= 0), a[a >= 0]].sum()
                 for a in (got[layer, b], want[layer, b])]
        assert 0 <= total[0] - total[1] <= 2 * moved, (layer, b, total, moved)
    assert equal >= 4


def test_bf16_every_gradient(axial):
    """Under JAX's assignment, every parameter's float32 gradient. With
    ``gap`` the port's largest distance to JAX's bfloat16 gradient, ``own``
    JAX's to the float32 one and ``scale`` the float32 gradient's largest
    magnitude: at least 90% of the tensors have gap <= 2 own + 1e-2 scale +
    1e-6, and every one gap <= 6 own + 1e-2 scale + 1e-6. The wide bound
    is met by the last decoder layer's attention and FFN, whose attention
    masks (logits >= 0 of the previous layer's mask embedding) flip
    differently under the port's strict bfloat16 rounding than under XLA's
    excess precision; the key-projection biases (an exact gradient of zero)
    carry rounding noise only, hence the 1e-6."""
    got, ref = axial["port"]["bf16"]["grads"], axial["port"]["f32"]["grads"]
    assert got.keys() == axial["grads"].keys()
    within_2 = 0
    for path, g in axial["grads"].items():
        assert got[path].dtype == np.float32
        gap = np.abs(got[path].astype(np.float64) - g).max()
        own = np.abs(g.astype(np.float64) - ref[path]).max()
        floor = 1e-2 * np.abs(ref[path]).max() + 1e-6
        assert gap <= 6 * own + floor, ("/".join(path), gap, own, floor)
        within_2 += gap <= 2 * own + floor
    assert within_2 >= 0.9 * len(got)


def test_bf16_adamw_apply_matches_optax(axial):
    """The bfloat16 step's gradients through the port's clip and AdamW
    groups against optax's chain (``make_optimizer``) on the same
    gradients, at the full lr (``warmup_ratio`` 1): each parameter's update
    to 1e-5 of its largest plus two float32 spacings of the parameter.
    Parameters, BN statistics and optimizer state stay float32."""
    import optax
    from openpvsg_tpu.train.segmenter import make_optimizer
    from openpvsg_torch.weights import to_jax_params

    kw = dict(warmup_iters=1, warmup_ratio=1.0)
    trainer = _port_trainer(_tiny(tcfg), axial["variables"],
                            train_cfg=tcfg.TrainConfig(**kw))
    trainer.loss_and_grads(_batch())
    params = axial["variables"]["params"]
    grads = jax.tree_util.tree_map(lambda a: a, params)  # new containers
    for path, g in _port_grads(trainer).items():
        node = grads
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = g
    tx = make_optimizer(jcfg.TrainConfig(**kw), params, 10)
    want = dict(_flat(jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(grads, params)))
    trainer.apply_updates()
    got = dict(_flat(to_jax_params(trainer.model.state_dict(), _tiny(tcfg))["params"]))
    before = dict(_flat(params))
    moved = 0
    for path, w_ in want.items():
        assert got[path].dtype == np.float32
        step = np.asarray(w_, np.float64) - before[path]
        np.testing.assert_array_less(
            np.abs(got[path].astype(np.float64) - w_),
            1e-5 * np.abs(step).max() + 2 * np.spacing(np.abs(w_)) + 1e-30,
            err_msg=str(path))
        moved += not np.array_equal(got[path], before[path])
    assert moved == len(want)
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert all(b.dtype == torch.float32 for b in trainer.model.buffers()
               if b.is_floating_point())
    assert all(t.dtype == torch.float32
               for s in trainer.optimizer.state.values() for t in s.values()
               if torch.is_tensor(t) and t.is_floating_point())


def test_bf16_checkpoint_round_trip_is_bitwise(axial, tmp_path):
    """A checkpoint of a bfloat16 trainer holds float32 tensors only, and a
    trainer resumed from it takes the same next step."""
    from openpvsg_torch.train.checkpoint import load_checkpoint, save_checkpoint

    batch = _batch()
    a = _port_trainer(_tiny(tcfg), axial["variables"])
    a.step(batch)
    path = os.path.join(tmp_path, "ckpt.pt")
    save_checkpoint(path, a)
    saved = torch.load(path, weights_only=False)
    assert all(t.dtype != torch.bfloat16 for t in _tensors(saved))
    logs_a = a.step(batch)
    b = _port_trainer(_tiny(tcfg), axial["variables"])
    assert load_checkpoint(path, b) == 1
    assert b.step(batch) == logs_a
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def _tensors(obj):
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def test_bf16_step_reduces_in_float32_and_restores_the_flags():
    """Inside a bfloat16 trainer's forward and backward, cuBLAS's
    reduced-precision bfloat16 reductions and TF32 are off; the caller's
    settings come back after the step."""
    from openpvsg_torch.train.segmenter import SegmenterTrainer

    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn

    def flags():
        return (matmul.allow_bf16_reduced_precision_reduction,
                matmul.allow_tf32, cudnn.allow_tf32)

    tr = SegmenterTrainer(_bf16(_tiny(tcfg)), _train_cfg(tcfg), device="cpu")
    seen = []
    tr.model.register_forward_pre_hook(lambda *_: seen.append(flags()))
    tr.params[0].register_hook(lambda g: seen.append(flags()))
    saved = flags()
    try:
        (matmul.allow_bf16_reduced_precision_reduction, matmul.allow_tf32,
         cudnn.allow_tf32) = (True, True, True)
        tr.step(_batch())
        assert seen == [(False, False, False)] * 2
        assert flags() == (True, True, True)
    finally:
        (matmul.allow_bf16_reduced_precision_reduction, matmul.allow_tf32,
         cudnn.allow_tf32) = saved


@pytest.mark.parametrize("value", ["float16", "bf16", "float64"])
def test_other_compute_dtypes_raise(value):
    """'float32' and 'bfloat16' train; any other value raises in the
    words of the ``mask_logits_dtype`` check (the JAX trainer would run it
    in float32)."""
    from openpvsg_torch.config import check_training_config
    from openpvsg_torch.train.segmenter import SegmenterTrainer

    check_training_config(_bf16(_tiny(tcfg)))
    cfg = tcfg.apply_overrides(_tiny(tcfg), {"backbone.dtype": value})
    with pytest.raises(ValueError, match=(
            rf"^model\.backbone\.dtype must be 'float32' or 'bfloat16', "
            rf"got '{value}'$")):
        SegmenterTrainer(cfg, _train_cfg(tcfg), device="cpu")
