"""The rest of the JAX package in the PyTorch port, held to the JAX package
on the CPU at the tests' small size (R-26, 8 queries, 3 decoder layers,
64x64 frames):

- weights-only int8 (``utils/quantize.py``): the quantized names, their
  count, the int8 tensors and the scales bitwise against
  ``quantize_tree_int8`` after the layout change; the int8 segmenter in
  float32 against ``SegmenterInference(int8_weights=True)``: forward
  outputs within 1e-5 of their scale, ``masks.txt`` bytes equal;
- ``fast_norm``: the bf16 forward against flax's ``fast_norm=True``
  forward, each output within twice JAX's own bf16 error against its
  float32 forward plus 1e-2 of its scale (the rule of the bf16 tests,
  ``tests/test_torch_train_bf16.py``: XLA's CPU keeps bf16 intermediates in
  float32, so JAX's own error understates bf16's); ``fast_norm=False``
  bitwise unchanged;
- the ``gn`` backbone: the R-26 forward at 1e-4 of scale, and one training
  step's loss (rel 1e-4) and every gradient (1e-4 of its scale plus 1e-6)
  against JAX's in float64, as ``tests/test_torch_train.py`` holds the BN
  model;
- orbax checkpoints of a segmenter ``TrainState`` and of a relation head,
  written here, exported by ``export_jax_checkpoint.py`` and read by
  ``load_jax_export``: the JAX outputs (1e-5 of scale);
- the ``random`` appearance encoder with JAX's features replayed: the
  tracker's tracks and tubes equal to JAX's;
- the port's ``prepare_rel_set`` on IPS ``query_feats.pickle`` files of
  JAX's ``QueryFeatTube``: ``relations.pickle`` equal to JAX's stage 3.
"""
import dataclasses
import logging
import math
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 64
SCOPES = ("backbone", "pixel_decoder")
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One torch thread for this module: its many small CPU ops only wait
    on a thread pool when the suite's workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tiny(m, norm="frozen_bn", **kw):
    return m.Mask2FormerConfig(
        num_things_classes=3, num_stuff_classes=2, num_queries=8,
        backbone=m.BackboneConfig(depth=26, norm=norm),
        pixel_decoder=m.PixelDecoderConfig(encoder_layers=1, ffn_channels=64),
        decoder=m.TransformerDecoderConfig(num_layers=3, ffn_channels=64),
        object_mask_thr=0.01, iou_thr=0.1, **kw)


@pytest.fixture(scope="module")
def variables():
    """Flax variables of the tiny model: a jitted init, random BN
    statistics (so folding is not the identity) and the void logit pushed
    down (so fusion keeps segments)."""
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F

    v = jax.jit(JaxM2F(_tiny(jcfg)).init)(jax.random.PRNGKey(3),
                                         jnp.zeros((1, 1, H, W, 3)))
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.default_rng(4)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: ((1.0 + rng.random(a.shape)) if path[-1].key == "var"
                         else 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        v["batch_stats"])
    v["params"]["head"]["cls_embed"]["bias"][-1] -= 4.0
    return {"params": v["params"], "batch_stats": stats}


def _frames(seed, n=2):
    return np.random.default_rng(seed).integers(0, 255, (n, H, W, 3), dtype=np.uint8)


def _close_to_scale(got, want, rel, atol=0.0, msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * np.abs(want).max() + atol, err_msg=msg)


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------

def _jax_quantized(tree, prefix=()):
    from openpvsg_tpu.utils.quantize import Q8_KEY, SCALE_KEY

    for k, v in tree.items():
        if isinstance(v, dict) and Q8_KEY in v:
            yield prefix + (k,), np.asarray(v[Q8_KEY]), np.asarray(v[SCALE_KEY])
        elif isinstance(v, dict):
            yield from _jax_quantized(v, prefix + (k,))


@pytest.mark.parametrize("min_elems", [4096, 1])
def test_quantized_tensors_names_and_count_match_jax(variables, min_elems):
    """After the fold, the same leaves are quantized (by the flax
    ``kernel`` mapping: the 2-D ``level_embed`` stays as it is even with
    ``min_elems`` 1), and the int8 tensors and scales are JAX's bit for bit
    after the layout change (HWIO -> OIHW, (in, out) -> (out, in))."""
    from openpvsg_tpu.models.resnet import fold_frozen_bn as jax_fold
    from openpvsg_tpu.utils.quantize import quantize_tree_int8
    from openpvsg_torch.models.resnet import fold_frozen_bn
    from openpvsg_torch.utils.quantize import quantize_state_int8
    from openpvsg_torch.weights import flax_path, from_jax_params

    tree, n, saved = quantize_tree_int8(jax_fold(variables), scopes=SCOPES,
                                        min_elems=min_elems)
    want = {path: (q, s) for path, q, s in _jax_quantized(tree["params"])}
    state = fold_frozen_bn(from_jax_params(variables, _tiny(tcfg)))
    rest, got = quantize_state_int8(state, scopes=SCOPES, min_elems=min_elems)
    paths = {flax_path(k, q.ndim)[1]: k for k, (q, _) in got.items()}
    assert set(paths) == set(want) and len(got) == n > 0
    # JAX counts the saving from its float32 variables: 3 bytes per element
    assert saved == 3 * sum(q.numel() for q, _ in got.values())
    assert "pixel_decoder.axial_encoder.level_embed" in rest
    for path, (jq, js) in want.items():
        q, s = got[paths[path]]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        perm = (3, 2, 0, 1) if jq.ndim == 4 else (1, 0)
        np.testing.assert_array_equal(q.numpy(), jq.transpose(perm), err_msg=str(path))
        np.testing.assert_array_equal(s.numpy(), js, err_msg=str(path))


def test_quantized_count_at_the_vps_preset():
    """131 kernels, 32,171,200 elements of the 46.7 M parameters of the
    folded ``mask2former_vps`` model (shapes only, on the meta device)."""
    from openpvsg_torch.utils.quantize import is_quantizable
    from openpvsg_torch.weights import expected_shapes

    cfg = tcfg.mask2former_vps().model
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, norm="folded"))
    shapes = expected_shapes(cfg)
    sel = [k for k, s in shapes.items() if is_quantizable(k, s, SCOPES)]
    assert len(sel) == 131
    assert sum(math.prod(shapes[k]) for k in sel) == 32_171_200


def test_int8_segmenter_matches_jax(variables, tmp_path, caplog):
    """The float32 int8 segmenter against JAX's: forward outputs within
    1e-5 of their scale and ``masks.txt`` bytes equal. The model keeps no
    copy of a quantized weight, and the log counts the saving from the
    resident dtype (3 bytes per element from float32, 1 from bf16)."""
    from openpvsg_tpu.infer import stages as jax_stages
    from openpvsg_tpu.infer.segmenter import SegmenterInference as JaxSeg
    from openpvsg_torch.infer import stages
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.weights import from_jax_params

    state = from_jax_params(variables, _tiny(tcfg))
    jseg = JaxSeg(_tiny(jcfg), variables, int8_weights=True)
    with caplog.at_level(logging.INFO, logger="openpvsg_torch.infer.segmenter"):
        seg = SegmenterInference(_tiny(tcfg), state, device="cpu", int8_weights=True)
        SegmenterInference(_tiny(tcfg), state, dtype=torch.bfloat16, device="cpu",
                           int8_weights=True)
    q8 = seg.replicas[0].q8
    n_el = sum(q.numel() for q, _ in q8.values())
    msgs = [r.getMessage() for r in caplog.records if "int8 weights" in r.getMessage()]
    assert msgs == [f"int8 weights: {len(q8)} kernels quantized, "
                    f"{3 * n_el / 1e6:.1f} MB of device memory saved (from torch.float32)",
                    f"int8 weights: {len(q8)} kernels quantized, "
                    f"{n_el / 1e6:.1f} MB of device memory saved (from torch.bfloat16)"]
    names = {n for n, _ in seg.model.named_parameters()}
    assert not names & set(q8)
    plain = SegmenterInference(_tiny(tcfg), state, device="cpu")
    assert seg.weight_bytes() < plain.weight_bytes()
    frames = _frames(5)
    for g, w in zip(seg.forward_frames(frames), jseg.forward_frames(frames)):
        _close_to_scale(g.numpy(), w, 1e-5)
    from PIL import Image

    files = []
    for i, f in enumerate(_frames(6, n=4)):
        files.append(str(tmp_path / f"{i:04d}.png"))
        Image.fromarray(f).save(files[-1])
    jax_stages.run_query_tube_vps(jseg, files, str(tmp_path / "jax"), window=2)
    stages.run_query_tube_vps(seg, files, str(tmp_path / "port"), window=2)
    txt = [open(tmp_path / d / "quantitive" / "masks.txt", "rb").read()
           for d in ("jax", "port")]
    assert txt[0] and txt[0] == txt[1]


def test_int8_segmenter_on_a_mesh_keeps_int8_on_each_replica(variables):
    """On a (data=2) mesh each replica's device holds the int8 tensors and
    scales and no copy of the quantized weights; the mesh's panoptic maps
    equal the one-device int8 segmenter's, its forward outputs within 1e-5
    of their scale (the replicas' batches differ in size, so torch's CPU
    convolutions may round differently, as in tests/test_torch_parallel.py)."""
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.parallel.mesh import make_mesh
    from openpvsg_torch.weights import from_jax_params

    state = from_jax_params(variables, _tiny(tcfg))
    one = SegmenterInference(_tiny(tcfg), state, device="cpu", int8_weights=True)
    mesh = SegmenterInference(_tiny(tcfg), state, int8_weights=True,
                              mesh=make_mesh(n_data=2, devices=["cpu"] * 2))
    assert len(mesh.replicas) == 2
    for replica in mesh.replicas:
        assert replica.q8.keys() == one.replicas[0].q8.keys()
        assert not {n for n, _ in replica.model.named_parameters()} & set(replica.q8)
    frames = _frames(15, n=3)
    for a, b in zip(one.forward_frames(frames), mesh.forward_frames(frames)):
        _close_to_scale(b.numpy(), a.numpy(), 1e-5)
    for a, b in zip(one.infer_frames_ips(frames), mesh.infer_frames_ips(frames)):
        np.testing.assert_array_equal(a["pan_results"], b["pan_results"])


# ---------------------------------------------------------------------------
# fast_norm
# ---------------------------------------------------------------------------

def _port_forward(variables, cfg, dtype, fast_norm, images):
    from openpvsg_torch.models.mask2former import Mask2Former
    from openpvsg_torch.weights import from_jax_params

    model = Mask2Former(cfg, fast_norm=fast_norm)
    model.load_state_dict(from_jax_params(variables, cfg))
    model = model.to(dtype).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(images).to(dtype))
    return model, [t.float().numpy() for t in out]


def test_fast_norm_bf16_matches_jax(variables):
    """bf16 with LN and GN statistics in bf16, against flax's
    ``Mask2Former(dtype=bfloat16, fast_norm=True)``: each output within
    twice JAX's own distance to its float32 forward plus 1e-2 of its
    scale; the switch changes the port's bf16 outputs."""
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F

    images = (_frames(7).astype(np.float32) - MEAN) / STD

    def jax_out(**kw):
        out = jax.jit(JaxM2F(_tiny(jcfg), **kw).apply)(variables, jnp.asarray(images)[:, None])
        return [np.asarray(out["cls_preds"][-1], np.float32),
                np.asarray(out["mask_preds"][-1][:, :, 0], np.float32),
                np.asarray(out["query_feats"], np.float32)]

    want = jax_out(dtype=jnp.bfloat16, fast_norm=True)
    ref = jax_out()
    model, got = _port_forward(variables, _tiny(tcfg), torch.bfloat16, True, images)
    _, slow = _port_forward(variables, _tiny(tcfg), torch.bfloat16, False, images)
    assert all(m.fast_norm for m in model.head.modules() if hasattr(m, "fast_norm"))
    assert any(not np.array_equal(g, s_) for g, s_ in zip(got, slow))
    for name, g, w, r in zip(("cls", "masks", "query"), got, want, ref):
        jax_err = float(np.abs(w - r).max())
        assert 0 < jax_err
        assert float(np.abs(g - w).max()) <= 2 * jax_err + 1e-2 * np.abs(r).max(), name


def test_fast_norm_off_is_bitwise_unchanged(variables):
    """A model whose ``fast_norm`` was turned on and off again, and one
    built with ``fast_norm=False``, give the default model's outputs bit
    for bit in bf16 and float32."""
    images = (_frames(8).astype(np.float32) - MEAN) / STD
    for dtype in (torch.bfloat16, torch.float32):
        _, base = _port_forward(variables, _tiny(tcfg), dtype, False, images)
        model, _ = _port_forward(variables, _tiny(tcfg), dtype, True, images)
        model.fast_norm = False
        with torch.no_grad():
            again = [t.float().numpy() for t in model(torch.from_numpy(images).to(dtype))]
        for a, b in zip(base, again):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["layer", "group"])
def test_fast_norm_layer_matches_flax(kind):
    """One bf16 LayerNorm / GroupNorm(8) with statistics in bf16 against
    flax's with ``force_float32_reductions=False``: within two bf16 ulps
    of the output's scale."""
    import flax.linen as fnn

    from openpvsg_torch.models.layers import GroupNorm, LayerNorm

    rng = np.random.default_rng(9)
    x = (3.0 + 2.0 * rng.standard_normal((2, 6, 5, 32))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(32)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    if kind == "layer":
        flax_mod = fnn.LayerNorm(dtype=jnp.bfloat16, force_float32_reductions=False)
        mod = LayerNorm(32, eps=1e-6)
    else:
        flax_mod = fnn.GroupNorm(num_groups=8, dtype=jnp.bfloat16,
                                 force_float32_reductions=False)
        mod = GroupNorm(8, 32, eps=1e-6)
    want = np.asarray(flax_mod.apply({"params": {"scale": scale, "bias": bias}}, xb),
                      np.float32)
    mod.weight.data = torch.from_numpy(scale)
    mod.bias.data = torch.from_numpy(bias)
    mod.fast_norm = True
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        got = mod(xt) if kind == "layer" else mod(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16
    _close_to_scale(got.float().numpy(), want, 2 * 2.0 ** -8)


# ---------------------------------------------------------------------------
# the 'gn' backbone
# ---------------------------------------------------------------------------

T_CLIP, B_CLIP, N_GT = 2, 2, 3


def _gn_batch(seed=3):
    rng = np.random.default_rng(seed)
    masks = np.zeros((B_CLIP, N_GT, T_CLIP, H // 4, W // 4), np.uint8)
    for b in range(B_CLIP):
        for i in range(N_GT):
            y0, x0 = 5 * i, int(rng.integers(0, 6))
            for f in range(T_CLIP):
                masks[b, i, f, y0:y0 + 4, x0 + f:x0 + f + 6] = 1
    valid = np.ones((B_CLIP, N_GT), bool)
    valid[1, 2] = False
    return {"images": rng.integers(0, 255, (B_CLIP, T_CLIP, H, W, 3), dtype=np.uint8),
            "gt_labels": rng.integers(0, 5, (B_CLIP, N_GT)).astype(np.int32),
            "gt_masks": masks, "gt_valid": valid}


@pytest.fixture(scope="module")
def gn_side():
    """The tiny model with the 'gn' backbone: flax variables (float32), the
    JAX inference forward, and the first training step's loss, logs and
    gradients with the model computing in float64."""
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F
    from openpvsg_tpu.train.losses import mask2former_loss

    cfg = _tiny(jcfg, norm="gn", assigner="hungarian")
    with jax.enable_x64(True):
        v = jax.jit(JaxM2F(cfg).init)(jax.random.PRNGKey(5),
                                      jnp.zeros((1, 1, H, W, 3), jnp.float32))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v["params"])
    assert "batch_stats" not in v
    images = (_frames(11).astype(np.float32) - MEAN) / STD
    infer = jax.jit(JaxM2F(cfg).apply)({"params": params}, jnp.asarray(images)[:, None])
    model = JaxM2F(cfg, train=True, dtype=jnp.float64)

    def loss_fn(p, batch):
        x = (batch["images"].astype(jnp.float32) - MEAN) / STD
        out = model.apply({"params": p}, x)
        loss, logs = mask2former_loss(
            jax.random.PRNGKey(0), out["cls_preds"], out["mask_preds"],
            batch["gt_labels"], batch["gt_masks"].astype(jnp.float32),
            batch["gt_valid"], cfg.num_classes, num_points=0,
            cls_weight=cfg.loss_cls_weight, mask_weight=cfg.loss_mask_weight,
            dice_weight=cfg.loss_dice_weight, bg_cls_weight=cfg.bg_cls_weight,
            assigner="hungarian")
        return loss, logs

    with jax.enable_x64(True):
        (loss, logs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, _gn_batch())
    flat = {}

    def walk(tree, prefix=()):
        for k, a in tree.items():
            if isinstance(a, dict):
                walk(a, prefix + (k,))
            else:
                flat[prefix + (k,)] = np.asarray(a)

    walk(grads)
    return {"params": params, "images": images,
            "infer": [np.asarray(infer["cls_preds"][-1]),
                      np.asarray(infer["mask_preds"][-1][:, :, 0]),
                      np.asarray(infer["query_feats"])],
            "loss": float(loss), "logs": {k: float(a) for k, a in logs.items()},
            "grads": flat}


def test_gn_backbone_forward_matches_jax(gn_side):
    """The 'gn' model's inference forward (GroupNorm(32), eps 1e-6 in each
    bn*/downsample norm; served unfolded) against flax's, at 1e-4 of
    scale; the state dict round-trips through the flax layout."""
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.weights import from_jax_params, to_jax_params

    cfg = _tiny(tcfg, norm="gn")
    state = from_jax_params({"params": gn_side["params"]}, cfg)
    assert "backbone.layer1_0.bn1.gn.weight" in state
    assert "backbone.layer1_0.downsample_bn.gn.bias" in state
    back = to_jax_params(state, cfg)
    assert not back["batch_stats"]
    for key, t in from_jax_params(back, cfg).items():
        assert torch.equal(t, state[key]), key
    seg = SegmenterInference(cfg, state, device="cpu")
    assert seg.cfg.backbone.norm == "gn"
    _, got = _port_forward({"params": gn_side["params"]}, cfg, torch.float32, False,
                           gn_side["images"])
    for g, w in zip(got, gn_side["infer"]):
        _close_to_scale(g, w, 1e-4)


def test_gn_training_step_matches_jax(gn_side):
    """One trainer step's loss and logs (rel 1e-4) and every gradient (1e-4
    of its scale plus 1e-6) against JAX's float64 value-and-grad; the GN
    parameters take no weight decay, as ``train/segmenter.py:64``."""
    from openpvsg_torch.train.segmenter import SegmenterTrainer, decays
    from openpvsg_torch.weights import flax_path, from_jax_params

    cfg = _tiny(tcfg, norm="gn")
    trainer = SegmenterTrainer(cfg, tcfg.TrainConfig(warmup_iters=1), steps_per_epoch=10,
                               device="cpu",
                               state_dict=from_jax_params({"params": gn_side["params"]}, cfg))
    loss, logs = trainer.loss_and_grads(_gn_batch())
    np.testing.assert_allclose(loss.item(), gn_side["loss"], rtol=1e-4)
    for k, v in gn_side["logs"].items():
        np.testing.assert_allclose(logs[k].item(), v, rtol=1e-4, atol=1e-6, err_msg=k)
    n_gn = 0
    for name, p in trainer.model.named_parameters():
        _, path = flax_path(name, p.ndim)
        g = p.grad.detach().numpy()
        if path[-1] == "kernel":
            g = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g.T
        _close_to_scale(g, gn_side["grads"][path], 1e-4, atol=1e-6, msg="/".join(path))
        if ".gn." in name and name.startswith("backbone."):
            n_gn += 1
            assert not decays(path), name
    assert n_gn > 0


# ---------------------------------------------------------------------------
# JAX checkpoints
# ---------------------------------------------------------------------------

def test_orbax_segmenter_checkpoint_exports_and_loads(variables, tmp_path):
    """A JAX ``TrainState`` saved by ``openpvsg_tpu.train.checkpoint``,
    exported by ``export_jax_checkpoint.py`` and read by
    ``load_jax_export`` (and ``load_model_state``) gives JAX's forward on
    the restored variables (1e-5 of scale); a missing or extra array, an
    extra collection, or the wrong config, raises."""
    import optax

    import export_jax_checkpoint as export
    from openpvsg_tpu.infer.segmenter import SegmenterInference as JaxSeg
    from openpvsg_tpu.train.checkpoint import load_checkpoint, save_checkpoint
    from openpvsg_tpu.train.segmenter import TrainState
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.train.checkpoint import load_jax_export, load_model_state

    state = TrainState(step=jnp.asarray(7, jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=optax.adamw(1e-4).init(variables["params"]))
    ckpt, npz = str(tmp_path / "epoch_1"), str(tmp_path / "epoch_1.npz")
    save_checkpoint(ckpt, state)
    assert export.main([ckpt, npz]) == 0
    with np.load(npz) as z:
        header = z["__header__"]
        arrays = {k: z[k] for k in z.files if k != "__header__"}
    assert '"kind": "segmenter"' in str(header) and '"step": 7' in str(header)
    assert not any(k.startswith("opt_state") for k in arrays)
    cfg = _tiny(tcfg)
    got_state = load_jax_export(npz, cfg)
    for k, t in load_model_state(npz, cfg).items():
        assert torch.equal(t, got_state[k])
    restored = load_checkpoint(ckpt)
    jseg = JaxSeg(_tiny(jcfg), {"params": restored["params"],
                               "batch_stats": restored["batch_stats"]})
    seg = SegmenterInference(cfg, got_state, device="cpu")
    frames = _frames(12)
    for g, w in zip(seg.forward_frames(frames), jseg.forward_frames(frames)):
        _close_to_scale(g.numpy(), w, 1e-5)
    # a missing and a left-over array, a relation config
    key = "params/head/cls_embed/bias"
    for name, extra, match in (("missing", {}, "cls_embed"),
                               ("extra", {"params/head/spare/kernel": np.ones((2, 2))}, "spare"),
                               ("collection", {"opt_state/mu/w": np.ones(2)}, "opt_state")):
        bad = {k: v for k, v in arrays.items() if name != "missing" or k != key}
        path = str(tmp_path / f"{name}.npz")
        np.savez(path, __header__=header, **bad, **extra)
        with pytest.raises(ValueError, match=match):
            load_jax_export(path, cfg)
    with pytest.raises(ValueError, match="Mask2FormerConfig"):
        load_jax_export(npz, tcfg.RelationHeadConfig())


def test_orbax_relation_checkpoint_exports_and_loads(tmp_path):
    """A relation head's ``{"params": ...}`` checkpoint (as
    ``tools/rel_train.py`` saves it), exported and loaded, gives the flax
    model's outputs within 1e-5, also through ``load_relation_state``."""
    import export_jax_checkpoint as export
    from openpvsg_tpu.models.relation.heads import RelationModel as JaxRel
    from openpvsg_tpu.train.checkpoint import save_checkpoint
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.train.checkpoint import load_jax_export, load_relation_state

    kw = dict(d_model=32, encoder_heads=2, encoder_ffn=48, temporal_heads=2,
              temporal_ffn=40, num_relations=7)
    jc, tc = jcfg.RelationHeadConfig(**kw), tcfg.RelationHeadConfig(**kw)
    rng = np.random.default_rng(13)
    feats = rng.standard_normal((5, 12, 32)).astype(np.float32)
    pair = rng.standard_normal((4, 12, 64)).astype(np.float32)
    jm = JaxRel.from_config(jc)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(feats), jnp.asarray(pair))
    ckpt, npz = str(tmp_path / "epoch_3"), str(tmp_path / "rel.npz")
    save_checkpoint(ckpt, {"params": params["params"]})
    export.main([ckpt, npz])
    state = load_jax_export(npz, tc)
    for k, t in load_relation_state(npz, "transformer", cfg=tc).items():
        assert torch.equal(t, state[k])
    model = RelationModel.from_config(tc)
    model.load_state_dict(state)
    want = jax.jit(jm.apply)(params, jnp.asarray(feats), jnp.asarray(pair))
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(pair))
    assert set(got) == set(want)
    for k in want:
        _close_to_scale(got[k].numpy(), want[k], 1e-5, msg=k)
    with pytest.raises(ValueError, match="RelationHeadConfig"):
        load_jax_export(npz, _tiny(tcfg))


# ---------------------------------------------------------------------------
# the 'random' appearance encoder
# ---------------------------------------------------------------------------

def test_random_encoder_shape_and_seed_rule():
    """The features' shape is (B, round(H/d), round(W/d), dim) and the seed
    is the float32 sum of the input cast to int32, as in JAX (on an input
    whose sum is exact in either order)."""
    from openpvsg_tpu.tracker.zoo import RandomFeatEncoder as JaxRandom
    from openpvsg_torch.tracker.zoo import RandomFeatEncoder, make_encoder

    x = np.random.default_rng(14).integers(-40, 40, (1, 36, 52, 3)).astype(np.float32)
    seeds = []
    enc, down = make_encoder("random", random_dim=12, down_factor=8)
    enc.draw = lambda shape, seed: (seeds.append(seed), torch.zeros(shape))[1]
    out = enc(torch.from_numpy(x))
    want = JaxRandom(dim=12, down_factor=8).apply({}, jnp.asarray(x))[0]
    assert down == 8 and out[0].shape == want.shape == (1, round(36 / 8), round(52 / 8), 12)
    assert seeds == [int(jnp.sum(jnp.asarray(x)).astype(jnp.int32))]
    default = RandomFeatEncoder()(torch.from_numpy(x))[0]
    again = RandomFeatEncoder()(torch.from_numpy(x))[0]
    assert torch.equal(default, again) and default.dtype == torch.float32


def test_random_encoder_tracker_matches_jax(monkeypatch):
    """The tracker with the 'random' encoder over the 12-frame scene of
    tests/test_torch_tracker.py, JAX's features replayed call by call into
    the port's draw: the same tracks, masks, lost tracks and tubes."""
    import flax.linen as fnn

    import openpvsg_tpu.tracker.zoo as jzoo
    from openpvsg_tpu.tracker.tracker import MaskAssociationTracker as JMask
    from openpvsg_torch.tracker.tracker import MaskAssociationTracker
    from openpvsg_torch.tracker.zoo import RandomFeatEncoder

    recorded = []

    class Recording(fnn.Module):
        dim: int = 16
        down_factor: int = 8

        @fnn.compact
        def __call__(self, x):
            out = jzoo.RandomFeatEncoder(self.dim, self.down_factor)(x)
            jax.debug.callback(lambda a: recorded.append(np.array(a)), out[0])
            return out

    real_make = jzoo.make_encoder

    def make_encoder(model_type="imagenet50", *a, **k):
        if model_type == "random":
            return Recording(), 8
        return real_make(model_type, *a, **k)

    monkeypatch.setattr(jzoo, "make_encoder", make_encoder)
    jax.clear_caches()
    jc = jcfg.TrackerConfig(model_type="random", track_buffer=30)
    tc = tcfg.TrackerConfig(model_type="random", track_buffer=30)
    jt = JMask(jc, {})
    tt = MaskAssociationTracker(tc, {}, device="cpu")
    assert isinstance(tt.appearance_model, RandomFeatEncoder)

    def replay(shape, seed):
        a = recorded.pop(0)
        assert a.shape == tuple(shape)
        return torch.from_numpy(a)

    tt.appearance_model.draw = replay
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((3, 256)).astype(np.float32)
    ids = []
    for t in range(12):
        frame = rng.integers(0, 60, (H, W, 3)).astype(np.float32)
        masks, qfs = [], []
        for o, (y, x, dy, dx) in enumerate(((4, 2, 1, 3), (30, 40, 1, -2), (44, 6, -1, 2))):
            if (o == 1 and 5 <= t < 8) or t == 9:
                continue
            m = np.zeros((H, W), np.uint8)
            m[y + dy * t:y + dy * t + 14, max(x + dx * t, 0):x + dx * t + 16] = 1
            frame[m == 1] = (250, 30 * o, 30)
            masks.append(m)
            qfs.append({"query_feat": feats[o] + 0.05 * rng.standard_normal(256).astype(np.float32),
                        "cls_id": (1, 2, 2)[o]})
        masks = np.stack(masks) if masks else np.zeros((0, H, W), np.uint8)
        want, n_want = jt.update(frame, masks, [dict(q) for q in qfs])
        got, n_got = tt.update(frame, masks, [dict(q) for q in qfs])
        assert not recorded
        assert n_got == n_want
        assert [t_.track_id for t_ in got] == [t_.track_id for t_ in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.mask, w.mask)
        assert [t_.track_id for t_ in tt.lost_stracks] == [t_.track_id for t_ in jt.lost_stracks]
        ids.append([t_.track_id for t_ in want])
    assert [] in ids and max(max(i) for i in ids if i) >= 3
    got, want = tt.finalize(12), jt.finalize(12)
    assert [(t_.track_id, t_.start_frame_id, len(t_)) for t_ in got] == \
        [(t_.track_id, t_.start_frame_id, len(t_)) for t_ in want]
    for gt, wt in zip(got, want):
        for g, w in zip(gt.qf_tube, wt.qf_tube):
            assert (g is None) == (w is None)
            if g is not None:
                assert g["cls_id"] == w["cls_id"]
                np.testing.assert_array_equal(g["query_feat"], w["query_feat"])


# ---------------------------------------------------------------------------
# JAX's IPS query_feats.pickle
# ---------------------------------------------------------------------------

def _same(a, b, path="payload"):
    """Equal content: same types, keys and values, arrays equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_prepare_rel_set_reads_jax_ips_pickles(tmp_path, monkeypatch):
    """Stage-2 outputs written by the JAX package in the IPS format (its
    ``QueryFeatTube``s; ``data/synthetic.py:write_oracle_stage2``): the
    port's ``prepare_rel_set`` reads them and writes the
    ``relations.pickle`` of JAX's ``tools/prepare_rel_set.py`` on the same
    files."""
    import importlib

    from openpvsg_tpu.data.synthetic import make_dataset, write_oracle_stage2
    from openpvsg_torch.data import io as tio
    from openpvsg_torch.tools import prepare_rel_set

    data, port, jax_work = (str(tmp_path / d) for d in ("data", "port", "jax"))
    anno = make_dataset(data, n_train=0, n_val=2, n_frames=10, h=48, w=64, seed=5,
                        style="rich")
    write_oracle_stage2(data, anno, port, "val", seed=5)
    shutil.copytree(port, jax_work)
    vids = sorted(os.listdir(os.path.join(port, "val_save_qf")))
    with open(os.path.join(port, "val_save_qf", vids[0], "query_feats.pickle"), "rb") as f:
        raw = f.read()
    assert b"openpvsg_tpu.tracker.tubes" in raw and b"QueryFeatTube" in raw
    tubes = tio.load_pickle(os.path.join(port, "val_save_qf", vids[0], "query_feats.pickle"))
    assert type(tubes[0]).__module__ == "openpvsg_torch.tracker.tubes"
    assert type(tubes[0]).__name__ == "QueryFeatTube"
    common = ["--data-dir", data, "--anno-file", anno, "--split", "val"]
    summary = prepare_rel_set.main(common + ["--work-dir", port])
    assert summary["written"] == len(vids) == 2
    tool = importlib.import_module("tools.prepare_rel_set")
    if hasattr(tool, "maybe_mesh"):
        monkeypatch.setattr(tool, "maybe_mesh", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["prepare_rel_set.py", *common, "--work-dir", jax_work])
    tool.main()
    kept = 0
    for vid in vids:
        want = tio.load_pickle(os.path.join(jax_work, "val_save_qf", vid, "relations.pickle"))
        got = tio.load_pickle(os.path.join(port, "val_save_qf", vid, "relations.pickle"))
        _same(got, want)
        kept += len(want["relations"])
    assert kept > 0
