"""Stage-1 training of the PyTorch port (openpvsg_torch.train) against the
JAX package on the CPU: the same weights (a flax init passed through
from_jax_params) and the same numpy batch go through both.

Size: R-26, 8 queries, 3 decoder layers, 64x64 frames, clips of T=2, B=2,
N=3 (tests/test_end2end.py:74-79), backbone 'sync_bn' in training mode.

The JAX side of the model runs in float64 (``jax.enable_x64`` and the
trainer's own ``compute_dtype``; parameters and optimizer state stay
float32), so the port's float32 is held to the exact gradients: the JAX
package's float32 CPU path is no reference for them (the train-mode
backbone's gradients through BatchNorm are ill-conditioned in float32, and
its own rounding lands further from its float64 result than these
tolerances).

Tolerances, relative to each tensor's largest magnitude ("scale"): the 3-D
encoding 1e-6 absolute (elementwise float32 formulas); the train-mode
backbone rel 1e-5 and its batch statistics 1e-5; the model's predictions
1e-4 absolute (as tests/test_torch_modules.py); costs 1e-5 and assignments
bit-identical; loss logs rel 1e-5 and their gradients 1e-5 absolute; one
trainer step's loss rel 1e-4 and every gradient rel 1e-4 of its scale plus
1e-6 (key-projection biases have an exact gradient of zero and carry
rounding noise); parameters and statistics after 3 steps rel 1e-4 of their
scale plus 1e-6, 1% of one Adam step at the full lr of 1e-4 (Adam divides
each gradient element by its own magnitude, so an element far below its
tensor's scale passes its relative error on to its update).
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

H, W, T, B, N = 64, 64, 2, 2, 3
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


def _tiny(m, **kw):
    """The tiny_model_cfg of tests/test_end2end.py with the VPS backbone
    norm, from either package."""
    return m.Mask2FormerConfig(
        num_things_classes=3, num_stuff_classes=2, num_queries=8,
        backbone=m.BackboneConfig(depth=26, norm="sync_bn"),
        pixel_decoder=m.PixelDecoderConfig(encoder_layers=1, ffn_channels=64),
        decoder=m.TransformerDecoderConfig(num_layers=3, ffn_channels=64),
        **kw)


def _train_cfg(m):
    # warmup_iters=1: full-size updates from the second step on
    return m.TrainConfig(warmup_iters=1)


def _blob_masks(rng, n, t, h, w):
    """n well-separated tubes: each a rectangle in its own band of rows,
    drifting by one pixel per frame."""
    masks = np.zeros((n, t, h, w), np.uint8)
    band = h // n
    for i in range(n):
        y0 = i * band + int(rng.integers(0, 2))
        x0 = int(rng.integers(0, w // 2))
        for f in range(t):
            masks[i, f, y0:y0 + band - 2, x0 + f:x0 + f + w // 3] = 1
    return masks


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    gt_masks = np.stack([_blob_masks(rng, N, T, H // 4, W // 4) for _ in range(B)])
    gt_valid = np.ones((B, N), bool)
    gt_valid[1, 2] = False  # a padded target
    return {"images": rng.integers(0, 255, (B, T, H, W, 3), dtype=np.uint8),
            "gt_labels": rng.integers(0, 5, (B, N)).astype(np.int32),
            "gt_masks": gt_masks, "gt_valid": gt_valid}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _port_grads(trainer):
    """{flax path: gradient} of the port trainer's parameters."""
    from openpvsg_torch.weights import flax_path

    out = {}
    for name, p in trainer.model.named_parameters():
        _, path = flax_path(name, p.ndim)
        g = p.grad.detach().numpy()
        if path[-1] == "kernel":
            g = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g.T
        out[path] = g
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX trainer computing in float64 (its flax init jitted, to keep
    this file fast), its initial variables as numpy, and the first step's
    loss, logs, predictions and gradients from a jitted value-and-grad of
    the loss its train step differentiates."""
    import openpvsg_tpu.train.segmenter as jseg
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F
    from openpvsg_tpu.train.losses import mask2former_loss

    class JitInit(JaxM2F):
        def init(self, *args, **kwargs):
            return jax.jit(functools.partial(JaxM2F.init, self))(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jseg, "Mask2Former", JitInit)
        trainer = jseg.SegmenterTrainer(
            _tiny(jcfg, assigner="hungarian"), _train_cfg(jcfg),
            steps_per_epoch=10, example_shape=(T, H, W),
            compute_dtype=jnp.float64)
        # the head's embeddings are initialized in the default dtype, float64
        # here: every parameter is float32 on both sides
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                        trainer.state.params)
        trainer.state = trainer.state.replace(params=params,
                                              opt_state=trainer.tx.init(params))
    variables = jax.tree_util.tree_map(
        np.array, {"params": trainer.state.params,
                   "batch_stats": trainer.state.batch_stats})
    model, cfg = trainer.model, trainer.cfg

    def loss_fn(params, batch_stats, batch):
        images = (batch["images"].astype(jnp.float32) - MEAN) / STD
        out, new_vars = model.apply({"params": params, "batch_stats": batch_stats},
                                    images, mutable=["batch_stats"])
        loss, logs = mask2former_loss(
            jax.random.PRNGKey(0), out["cls_preds"], out["mask_preds"],
            batch["gt_labels"], batch["gt_masks"].astype(jnp.float32),
            batch["gt_valid"], cfg.num_classes, num_points=0,
            cls_weight=cfg.loss_cls_weight, mask_weight=cfg.loss_mask_weight,
            dice_weight=cfg.loss_dice_weight, bg_cls_weight=cfg.bg_cls_weight,
            assigner="hungarian")
        return loss, (logs, out["cls_preds"], out["mask_preds"],
                      new_vars["batch_stats"])

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    with jax.enable_x64(True):
        (loss, (logs, cls, masks, stats)), grads = grad_fn(
            variables["params"], variables["batch_stats"], _batch())
    first = {"loss": float(loss), "logs": {k: float(v) for k, v in logs.items()},
             "cls": np.asarray(cls), "masks": np.asarray(masks),
             "grads": dict(_flat(grads))}
    return {"trainer": trainer, "variables": variables, "first": first}


def _port_trainer(variables, **kw):
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import from_jax_params

    return SegmenterTrainer(_tiny(tcfg), _train_cfg(tcfg), steps_per_epoch=10,
                            device="cpu",
                            state_dict=from_jax_params(variables, _tiny(tcfg)),
                            **kw)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,h,w,f", [(2, 12, 15, 128), (3, 4, 5, 64)])
def test_sine_pos_encoding_3d(t, h, w, f):
    from openpvsg_tpu.models.position_encoding import sine_pos_encoding_3d as jax_pe
    from openpvsg_torch.models.position_encoding import sine_pos_encoding_3d

    got = sine_pos_encoding_3d(t, h, w, f).numpy()
    want = np.asarray(jax.jit(jax_pe, static_argnums=(0, 1, 2, 3))(t, h, w, f))
    assert got.shape == want.shape == (t, h, w, 2 * f)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _close_to_scale(got, want, rel, atol=0.0, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max() + atol, err_msg=msg)


def test_resnet_train_mode_outputs_and_batch_stats(jax_side):
    """The four stage outputs and the updated running statistics of every
    BN, against flax apply(..., mutable=['batch_stats'])."""
    from openpvsg_tpu.models.resnet import ResNet as JaxResNet
    from openpvsg_torch.models.resnet import ResNet
    from openpvsg_torch.weights import from_jax_params, to_jax_params

    v = jax_side["variables"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, H, W, 3)).astype(np.float32)
    jax_vars = {"params": v["params"]["backbone"],
                "batch_stats": v["batch_stats"]["backbone"]}
    apply = jax.jit(functools.partial(
        JaxResNet(depth=26, norm="sync_bn", train=True, dtype=jnp.float64).apply,
        mutable=["batch_stats"]))
    with jax.enable_x64(True):
        want, new_vars = apply(jax_vars, x)
    state = from_jax_params(v, _tiny(tcfg))
    net = ResNet(26, "sync_bn", train=True)
    net.load_state_dict({k[len("backbone."):]: t for k, t in state.items()
                         if k.startswith("backbone.")})
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for g, w_ in zip(got, want):
        _close_to_scale(g.numpy(), w_, 1e-5)
    state.update({f"backbone.{k}": t for k, t in net.state_dict().items()})
    got_stats = dict(_flat(to_jax_params(state, _tiny(tcfg))["batch_stats"]["backbone"]))
    want_stats = dict(_flat(new_vars["batch_stats"]))
    before = dict(_flat(jax_vars["batch_stats"]))
    assert got_stats.keys() == want_stats.keys()
    for path, w_ in want_stats.items():
        assert not np.array_equal(w_, before[path])
        _close_to_scale(got_stats[path], w_, 1e-5, msg="/".join(path))


def test_batch_norm_stores_the_biased_variance():
    """A batch of 2 at 1x1: the biased variance is half torch's unbiased
    one, so torch's own running update would differ by 2x here."""
    import flax.linen as fnn
    from openpvsg_torch.models.resnet import BatchNorm

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1, 1, 6)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    jv = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, new = bn.apply(jv, jnp.asarray(x), mutable=["batch_stats"])
    mod = BatchNorm(6, batch_stats=True)
    got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    biased = x.var(axis=(0, 1, 2))
    want_var = np.asarray(new["batch_stats"]["var"])
    np.testing.assert_allclose(want_var, 0.9 + 0.1 * biased, rtol=1e-6)
    np.testing.assert_allclose(mod.running_var.numpy(), want_var, rtol=1e-6)
    np.testing.assert_allclose(mod.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]), rtol=1e-6,
                               atol=1e-8)
    assert not np.allclose(mod.running_var.numpy(), 0.9 + 0.1 * 2 * biased)


def test_train_mode_predictions(jax_side):
    """Mask2Former(train=True): cls_preds and the float32 mask_preds of all
    L+1 layers, (L+1, B, Q, T, H/4, W/4)."""
    first = jax_side["first"]
    trainer = _port_trainer(jax_side["variables"])
    images, *_ = trainer.device_batch(_batch())
    with torch.no_grad():
        cls, masks, query = trainer.model(images)
    assert tuple(masks.shape) == (4, B, 8, T, H // 4, W // 4)
    assert masks.dtype == torch.float32 and tuple(query.shape) == (B, 8, 256)
    np.testing.assert_allclose(cls.numpy(), first["cls"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(masks.numpy(), first["masks"], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# assigner and loss
# ---------------------------------------------------------------------------

def test_costs_match_jax(rng):
    from openpvsg_tpu.train import assign as jassign
    from openpvsg_torch.train import assign

    Q, P, K = 8, 300, 6
    cls = rng.standard_normal((Q, K)).astype(np.float32)
    labels = np.array([0, 3, 5], np.int32)
    mp = (3 * rng.standard_normal((Q, P))).astype(np.float32)
    mt = (rng.random((N, P)) < 0.4).astype(np.float32)
    pairs = [(assign.classification_cost(torch.from_numpy(cls), torch.from_numpy(labels).long()),
              jassign.classification_cost(cls, labels)),
             (assign.mask_bce_cost(torch.from_numpy(mp), torch.from_numpy(mt)),
              jassign.mask_bce_cost(mp, mt)),
             (assign.dice_cost(torch.from_numpy(mp), torch.from_numpy(mt)),
              jassign.dice_cost(mp, mt))]
    for got, want in pairs:
        assert tuple(got.shape) == (Q, N)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _separated_preds(rng, L=3, Q=8, K=6):
    """Layer predictions where some queries reproduce a target well and the
    rest are noise, so the optimum is unique by a wide margin."""
    masks = np.stack([_blob_masks(rng, N, T, 16, 16) for _ in range(B)])
    cls = rng.standard_normal((L, B, Q, K)).astype(np.float32)
    mp = rng.standard_normal((L, B, Q, T, 16, 16)).astype(np.float32)
    for layer in range(L):
        for b in range(B):
            qs = rng.permutation(Q)[:N]
            for j, q in enumerate(qs):
                mp[layer, b, q] = np.where(masks[b, j] > 0, 6.0, -6.0) + 0.5 * mp[layer, b, q]
    labels = rng.integers(0, K - 1, (B, N)).astype(np.int32)
    valid = np.ones((B, N), bool)
    valid[0, 1] = False
    return cls, mp, labels, masks.astype(np.float32), valid


def test_assignments_bit_identical(rng):
    from openpvsg_tpu.train.assign import hungarian_assign_layers as jax_assign
    from openpvsg_torch.train.assign import hungarian_assign_layers

    cls, mp, labels, masks, valid = _separated_preds(rng)
    keys = jnp.zeros((cls.shape[0], B, 2), jnp.uint32)
    want = np.asarray(jax_assign(keys, cls, mp, labels, masks, valid,
                                 num_points=0, method="hungarian"))
    got = hungarian_assign_layers(*(torch.from_numpy(a) for a in (cls, mp)),
                                  torch.from_numpy(labels).long(),
                                  torch.from_numpy(masks), torch.from_numpy(valid))
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == 1).sum() == 0  # the invalid target is never taken
    assert ((got >= 0).sum(-1) == valid.sum(-1)[None]).all()


def test_loss_logs_and_prediction_grads(rng):
    from openpvsg_tpu.train.losses import mask2former_loss as jax_loss
    from openpvsg_torch.train.losses import mask2former_loss

    cls, mp, labels, masks, valid = _separated_preds(rng)
    K = cls.shape[-1] - 1

    def f(c, m):
        return jax_loss(jax.random.PRNGKey(0), c, m, labels, masks, valid, K,
                        num_points=0, assigner="hungarian")

    (want, want_logs), (g_cls, g_mp) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(cls, mp)
    tc, tm = (torch.from_numpy(a).requires_grad_() for a in (cls, mp))
    got, logs = mask2former_loss(tc, tm, torch.from_numpy(labels).long(),
                                 torch.from_numpy(masks), torch.from_numpy(valid), K)
    got.backward()
    assert logs.keys() == want_logs.keys()
    for k in logs:
        np.testing.assert_allclose(logs[k].item(), float(want_logs[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(g_cls), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(g_mp), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def test_trainer_step_loss_and_every_grad(jax_side):
    first = jax_side["first"]
    trainer = _port_trainer(jax_side["variables"])
    loss, logs = trainer.loss_and_grads(_batch())
    np.testing.assert_allclose(loss.item(), first["loss"], rtol=1e-4)
    for k, v in first["logs"].items():
        np.testing.assert_allclose(logs[k].item(), v, rtol=1e-4, atol=1e-6, err_msg=k)
    got = _port_grads(trainer)
    want = first["grads"]
    assert got.keys() == want.keys()
    for path, g in want.items():
        _close_to_scale(got[path], g, 1e-4, atol=1e-6, msg="/".join(path))


def test_trainer_three_steps_match_jax(jax_side):
    """Parameters and BN statistics by flax path after 3 steps of both
    trainers on the same batch; every parameter moved."""
    from openpvsg_torch.weights import to_jax_params

    jt = jax_side["trainer"]
    trainer = _port_trainer(jax_side["variables"])
    batch = _batch()
    for _ in range(3):
        with jax.enable_x64(True):
            want_logs = jt.step(batch, jax.random.PRNGKey(0))
        logs = trainer.step(batch)
        np.testing.assert_allclose(logs["loss"], float(want_logs["loss"]), rtol=1e-4)
    got = to_jax_params(trainer.model.state_dict(), _tiny(tcfg))
    for coll, tree in (("params", jt.state.params), ("batch_stats", jt.state.batch_stats)):
        want = dict(_flat(tree))
        mine = dict(_flat(got[coll]))
        before = dict(_flat(jax_side["variables"][coll]))
        assert mine.keys() == want.keys()
        for path, w_ in want.items():
            _close_to_scale(mine[path], w_, 1e-4, atol=1e-6,
                            msg=f"{coll}/{'/'.join(path)}")
            assert not np.array_equal(mine[path], before[path]), path


def test_param_groups_match_jax(jax_side):
    import flax
    from openpvsg_tpu.train.segmenter import _decay_mask, _param_labels
    from openpvsg_torch.train.segmenter import decays, param_groups, param_label
    from openpvsg_torch.weights import flax_path

    params = jax_side["variables"]["params"]
    labels = flax.traverse_util.flatten_dict(_param_labels(params))
    mask = flax.traverse_util.flatten_dict(_decay_mask(params))
    assert {p: param_label(p) for p in labels} == labels
    assert {p: decays(p) for p in mask} == mask
    trainer = _port_trainer(jax_side["variables"])
    by_id = {id(p): name for name, p in trainer.model.named_parameters()}
    seen = 0
    for group in param_groups(trainer.model, _train_cfg(tcfg)):
        for p in group["params"]:
            _, path = flax_path(by_id[id(p)], p.ndim)
            assert group["label"] == labels[path]
            assert group["lr_mult"] == (0.1 if labels[path] == "backbone" else 1.0)
            decay = mask[path] and labels[path] != "no_decay"
            assert group["weight_decay"] == (0.05 if decay else 0.0)
            seen += 1
    assert seen == len(labels)


def test_lr_schedule_matches_optax():
    from openpvsg_tpu.train.segmenter import make_lr_schedule as jax_sched
    from openpvsg_torch.train.segmenter import make_lr_schedule

    kw = dict(warmup_iters=10, lr_step_epochs=(2,))
    want = jax_sched(jcfg.TrainConfig(**kw), 10)
    got = make_lr_schedule(tcfg.TrainConfig(**kw), 10)
    for count in range(31):
        w_ = np.float32(want(jnp.int32(count)))
        g = got(count)
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w_, rtol=1e-7, err_msg=str(count))
    assert got(30) == np.float32(np.float32(0.1) * np.float32(1e-4))


@pytest.mark.parametrize("scale", [1e-4, 10.0])
def test_clip_matches_optax(scale):
    import optax
    from openpvsg_torch.train.segmenter import clip_by_global_norm_

    rng = np.random.default_rng(6)
    grads = [(scale * rng.standard_normal(s)).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 3))]
    want, _ = optax.clip_by_global_norm(0.01).update(grads, optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(got, 0.01)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-6, atol=0)
    if scale < 1:  # below max: untouched
        for g, w_ in zip(got, grads):
            np.testing.assert_array_equal(g.numpy(), w_)


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


def test_checkpoint_round_trip_is_bitwise(jax_side, tmp_path, one_intra_op_thread):
    from openpvsg_torch.train.checkpoint import load_checkpoint, save_checkpoint

    batch = _batch()
    a = _port_trainer(jax_side["variables"])
    a.step(batch)
    path = os.path.join(tmp_path, "ckpt.pt")
    save_checkpoint(path, a)
    logs_a = a.step(batch)
    b = _port_trainer(jax_side["variables"], seed=1)
    assert load_checkpoint(path, b) == 1
    logs_b = b.step(batch)
    assert logs_a == logs_b
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i])


@pytest.mark.parametrize("field,value", [
    ("loss_layout", "target"), ("assigner", "lapjv"),
    ("assigner", "greedy"), ("mask_logits_dtype", "bfloat16"),
    ("match_downsample", 2), ("focal_cls", True),
    ("with_sem_seg", True), ("focal_gamma", 1.0),
    ("focal_alpha", 0.5), ("sem_seg_weight", 0.5)])
def test_unported_training_values_raise(field, value):
    from openpvsg_torch.train.segmenter import SegmenterTrainer

    cfg = _tiny(tcfg, **{field: value})
    with pytest.raises(ValueError, match=rf"model\.{field}=.*ROADMAP\.md A9c"):
        SegmenterTrainer(cfg, _train_cfg(tcfg), device="cpu")


@pytest.mark.parametrize("field,value", [
    ("match_downsample", 0), ("loss_layout", "rows"), ("mask_logits_dtype", "bf16")])
def test_invalid_training_values_raise(field, value):
    """Values the JAX package rejects as invalid are refused too."""
    from openpvsg_torch.config import check_training_config

    with pytest.raises(ValueError, match=rf"model\.{field}={value!r}"):
        check_training_config(_tiny(tcfg, **{field: value}))
    check_training_config(_tiny(tcfg))


def test_weights_round_trip_through_flax_layout(jax_side):
    from openpvsg_torch.weights import from_jax_params, to_jax_params

    v = jax_side["variables"]
    back = to_jax_params(from_jax_params(v, _tiny(tcfg)), _tiny(tcfg))
    for coll in ("params", "batch_stats"):
        want = dict(_flat(v[coll]))
        got = dict(_flat(back[coll]))
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want)
    state = from_jax_params(v, _tiny(tcfg))
    state["head.extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="to_jax_params: 1 keys the configured"):
        to_jax_params(state, _tiny(tcfg))


def test_pad_targets_matches_the_jax_cli():
    from openpvsg_torch.train.segmenter import pad_targets
    from tools.train import pad_targets as jax_pad

    rng = np.random.default_rng(7)
    samples = [{"images": rng.integers(0, 255, (T, 36, 44, 3), dtype=np.uint8),
                "gt_labels": rng.integers(0, 5, n),
                "gt_mask_tubes": (rng.random((n, T, 36, 44)) < 0.5).astype(np.uint8)}
               for n in (2, 5)]
    got, want = pad_targets(samples, 4), jax_pad(samples, 4)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
