"""The reference's Mask2Former in the PyTorch port against the JAX package on
the CPU: the sampling primitives (``openpvsg_torch.ops.sampling``), the MSDA
pixel encoder (``encoder='msda'``), the mmdet checkpoint converter, and VPS
stage 2 with the MSDA model.

Sizes: R-26, 8 queries, 64x64 frames (levels 8x8, 4x4, 2x2), 1-2 MSDA
layers. Tolerances: the primitives 1e-5 absolute (float32 bilinear taps in
another order); the attention layer, the pixel decoder and the full model's
class and mask logits 1e-4 absolute (as tests/test_torch_modules.py);
stage 2's ``masks.txt`` byte-identical and its query features 1e-4, as
tests/test_torch_stage2.py holds the axial model.
"""
import os
import pickle
import re

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

from test_convert_full import synthetic_mmdet_sd

H, W = 64, 64


def _tiny(m, enc_layers=2, **kw):
    """synthetic_mmdet_sd's model (R-26, 8 queries, 3 decoder layers, 5
    classes, MSDA with its default widths) from either package."""
    return m.Mask2FormerConfig(
        num_things_classes=3, num_stuff_classes=2, num_queries=8,
        backbone=m.BackboneConfig(depth=26),
        pixel_decoder=m.PixelDecoderConfig(encoder_layers=enc_layers, encoder="msda"),
        decoder=m.TransformerDecoderConfig(num_layers=3), **kw)


def _mmdet_sd(seed=0):
    """synthetic_mmdet_sd with weights rescaled to N(0, 1/fan_in),
    embeddings to N(0, 1) and BN statistics randomized, so activations keep
    their scale through R-26, the queries differ and the MSDA layers sample
    away from their reference points; the mask MLP's last layer keeps its
    0.02 so that the mask logits are O(1)."""
    sd = synthetic_mmdet_sd(np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 1)
    embeds = ("level_encoding.weight", "level_embed.weight", "query_embed.weight",
              "query_feat.weight")
    for k, v in sd.items():
        if k.endswith(embeds):
            sd[k] = v / 0.02
        elif v.ndim >= 2 and k != "panoptic_head.mask_embed.4.weight":
            sd[k] = v / (0.02 * np.sqrt(np.prod(v.shape[1:])))
        elif k.endswith("running_var"):
            sd[k] = (0.5 + rng.random(v.shape)).astype(np.float32)
        elif k.endswith("running_mean"):
            sd[k] = (0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        elif v.ndim == 1 and k.endswith(".weight"):  # BN, GN and LayerNorm scales
            sd[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith("sampling_offsets.bias"):
            sd[k] = (2.0 * rng.standard_normal(v.shape)).astype(np.float32)
    return sd


# ---------------------------------------------------------------------------
# sampling primitives
# ---------------------------------------------------------------------------

def _primitive_pair(name, rng):
    """(port result, JAX result) of one primitive on inputs that reach
    past the borders (zero padding)."""
    from openpvsg_tpu.ops import sampling as jsamp
    from openpvsg_torch.ops import sampling as tsamp

    t = torch.from_numpy
    if name == "point_sample_at_pixel_coordinates":
        # against JAX's 4-tap bilinear_sample at fractional pixel
        # coordinates x, y (p = (x + 0.5) / size), past the borders too
        img = rng.standard_normal((7, 9, 4)).astype(np.float32)
        x = (rng.random(55) * 12 - 2).astype(np.float32)
        y = (rng.random(55) * 10 - 2).astype(np.float32)
        pts = np.stack([(x + 0.5) / 9, (y + 0.5) / 7], -1)[None]
        return tsamp.point_sample(t(img[None]), t(pts))[0], jsamp.bilinear_sample(img, x, y)
    if name == "grid_sample":
        img = rng.standard_normal((2, 7, 9, 4)).astype(np.float32)
        grid = (rng.random((2, 5, 11, 2)) * 2.4 - 1.2).astype(np.float32)
        return tsamp.grid_sample(t(img), t(grid)), jsamp.grid_sample(img, grid)
    if name == "point_sample":
        feats = rng.standard_normal((2, 6, 8, 3)).astype(np.float32)
        pts = (rng.random((2, 50, 2)) * 1.2 - 0.1).astype(np.float32)
        return tsamp.point_sample(t(feats), t(pts)), jsamp.point_sample(feats, pts)
    B, heads, hd, Q, P = 2, 4, 8, 13, 4
    shapes = [(6, 8), (3, 4), (2, 2)]
    value = rng.standard_normal((B, sum(h * w for h, w in shapes), heads, hd)).astype(np.float32)
    locs = (rng.random((B, Q, heads, 3, P, 2)) * 1.2 - 0.1).astype(np.float32)
    attn = rng.random((B, Q, heads, 3, P)).astype(np.float32)
    attn /= attn.reshape(B, Q, heads, -1).sum(-1)[..., None, None]
    return (tsamp.ms_deform_attn(t(value), shapes, t(locs), t(attn)),
            jsamp.ms_deform_attn(value, shapes, locs, attn))


@pytest.mark.parametrize("name", ["point_sample_at_pixel_coordinates", "grid_sample",
                                  "point_sample", "ms_deform_attn"])
def test_sampling_primitive_matches_jax(name, rng):
    got, want = _primitive_pair(name, rng)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# MSDA modules
# ---------------------------------------------------------------------------

def _perturbed(params, rng, scale=0.05):
    """flax params with noise on every leaf, so the zero-initialized
    projections (offsets, attention weights) do real work."""
    flat = flax.traverse_util.flatten_dict(params)
    return flax.traverse_util.unflatten_dict({
        k: np.asarray(v) + scale * rng.standard_normal(v.shape).astype(np.float32)
        for k, v in flat.items()})


def _state(params):
    from openpvsg_torch.weights import _convert_leaf, _flatten

    return dict(_convert_leaf(p, v) for p, v in _flatten(params))


def test_msda_attention_layer_matches_flax(rng):
    from openpvsg_tpu.models.pixel_decoder import MSDeformAttention as JaxMSDA
    from openpvsg_torch.models.pixel_decoder import MSDeformAttention

    C, heads, points = 32, 4, 2
    shapes = [(6, 8), (3, 4), (2, 2)]
    S, B = sum(h * w for h, w in shapes), 2
    query = rng.standard_normal((B, S, C)).astype(np.float32)
    value = rng.standard_normal((B, S, C)).astype(np.float32)
    refs = rng.random((B, S, 2)).astype(np.float32)
    jm = JaxMSDA(embed_dim=C, num_heads=heads, num_levels=3, num_points=points)
    params = _perturbed(jax.jit(lambda k, *a: jm.init(k, *a, shapes))(
        jax.random.PRNGKey(0), query, value, refs)["params"], rng, scale=0.3)
    want = jax.jit(lambda v, *a: jm.apply(v, *a, shapes))(
        {"params": params}, query, value, refs)
    mod = MSDeformAttention(C, heads, 3, points)
    mod.load_state_dict(_state(params))
    with torch.no_grad():
        got = mod(*(torch.from_numpy(a) for a in (query, value, refs)), shapes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_msda_pixel_decoder_matches_flax(train, rng):
    """mask_feature and the three encoder levels; ``train=True`` runs the
    plain stride-4 chain, eval the B1 wrapper (its plain version here)."""
    from openpvsg_tpu.models.pixel_decoder import MSDeformAttnPixelDecoder as JaxPD
    from openpvsg_torch.models.pixel_decoder import MSDeformAttnPixelDecoder

    def cfg(m):
        return m.PixelDecoderConfig(encoder="msda", encoder_layers=2, ffn_channels=64)

    feats = [rng.standard_normal((2, H // s, W // s, c)).astype(np.float32)
             for s, c in zip((4, 8, 16, 32), (256, 512, 1024, 2048))]
    jm = JaxPD(cfg(jcfg))
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), feats)["params"], rng)
    want = jax.jit(jm.apply)({"params": params}, feats)
    mod = MSDeformAttnPixelDecoder(cfg(tcfg), train=train)
    mod.load_state_dict(_state(params))
    with torch.no_grad():
        got = mod([torch.from_numpy(f) for f in feats])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    assert len(got[1]) == len(want[1]) == 3
    for g, w_ in zip(got[1], want[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0, atol=1e-4)


def test_random_msda_weights_start_as_flax_does():
    """random_state_dict: the offsets' weight zero and bias the directional
    grid of flax's init, the attention weights zero."""
    from openpvsg_tpu.models.pixel_decoder import _msda_offset_bias
    from openpvsg_torch.weights import random_state_dict

    state = random_state_dict(_tiny(tcfg, enc_layers=1), 0)
    attn = "pixel_decoder.encoder_layer_0_attn"
    assert not state[f"{attn}.sampling_offsets.weight"].any()
    np.testing.assert_array_equal(state[f"{attn}.sampling_offsets.bias"].numpy(),
                                  _msda_offset_bias(8, 3, 4).astype(np.float32))
    assert not state[f"{attn}.attention_weights.weight"].any()
    assert not state[f"{attn}.attention_weights.bias"].any()
    assert state["pixel_decoder.level_embed"].std() > 0.5


def test_config_json_with_the_reference_model_reads_in_the_port(tmp_path):
    """A JAX config.json with the MSDA encoder (its ``num_points`` and
    no longer JAX-only) and the points objective with the split reads as
    the port's same configuration, and back."""
    path = str(tmp_path / "config.json")
    sets = ["model.pixel_decoder.encoder=msda", "model.pixel_decoder.num_points=2",
            "model.loss_sampling=points", "model.num_points=4096",
            "model.split_thing_stuff=true"]
    want = jcfg.apply_overrides(jcfg.mask2former_vps(), jcfg.parse_set_args(sets))
    got = tcfg.apply_overrides(tcfg.mask2former_vps(), tcfg.parse_set_args(sets))
    assert got.model.pixel_decoder.num_points == 2
    jcfg.save_config(want, path)
    assert tcfg.load_config_file(path) == got
    tcfg.save_config(got, path)
    assert jcfg.load_config_file(path) == want
    tcfg.check_training_config(got.model)


# ---------------------------------------------------------------------------
# the full model from an mmdet state dict
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mmdet_sd():
    return _mmdet_sd()


@pytest.mark.parametrize("T", [1, 2])
def test_full_model_from_mmdet_matches_jax(mmdet_sd, T):
    """The same synthetic mmdet state dict converted by each package: class
    and mask logits of every decoder layer (train-mode forward, frozen BN,
    as tests/test_full_model_parity.py runs it) for clips of T frames."""
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F
    from openpvsg_tpu.train.checkpoint import convert_mmdet_mask2former as jax_convert
    from openpvsg_torch.models.mask2former import Mask2Former
    from openpvsg_torch.train.checkpoint import convert_mmdet_mask2former

    images = np.random.default_rng(5).standard_normal((1, T, H, W, 3)).astype(np.float32)
    out = jax.jit(JaxM2F(_tiny(jcfg), train=True).apply)(
        jax.tree_util.tree_map(jnp.asarray, jax_convert(mmdet_sd)), images)
    model = Mask2Former(_tiny(tcfg), train=True)
    model.load_state_dict(convert_mmdet_mask2former(
        {k: torch.from_numpy(v) for k, v in mmdet_sd.items()}, _tiny(tcfg)), strict=True)
    with torch.no_grad():
        cls, masks, _ = model(torch.from_numpy(images))
    assert tuple(masks.shape) == (4, 1, 8, T, H // 4, W // 4)
    np.testing.assert_allclose(cls.numpy(), np.asarray(out["cls_preds"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(masks.numpy(), np.asarray(out["mask_preds"]), rtol=0,
                               atol=1e-4)
    # not a flat model: the queries' masks differ at O(1)
    assert np.asarray(out["mask_preds"])[-1].std(axis=1).mean() > 0.05


def test_mmdet_converter_refuses_what_does_not_fit(mmdet_sd):
    from openpvsg_torch.train.checkpoint import convert_mmdet_mask2former

    cfg = _tiny(tcfg)
    sd = dict(mmdet_sd)
    del sd["panoptic_head.pixel_decoder.encoder.layers.1.ffns.0.layers.1.bias"]
    with pytest.raises(ValueError, match=r"1 keys the port expects and the state "
                                         r"dict lacks \['panoptic_head\.pixel_decoder"
                                         r"\.encoder\.layers\.1\.ffns\.0\.layers\.1\.bias'\]"):
        convert_mmdet_mask2former(sd, cfg)
    with pytest.raises(ValueError, match=r"keys the configured model does not use "
                                         r"\['panoptic_head\.pixel_decoder\.encoder\.layers\.1"):
        convert_mmdet_mask2former(mmdet_sd, _tiny(tcfg, enc_layers=1))
    sd = dict(mmdet_sd, **{"backbone.conv1.weight": np.zeros((64, 3, 3, 3), np.float32)})
    with pytest.raises(ValueError, match=r"shape mismatches \[\('backbone\.conv1\.weight'"):
        convert_mmdet_mask2former(sd, cfg)


def test_load_mmdet_checkpoint_reads_a_pth(mmdet_sd, tmp_path):
    """A .pth as mmdet 2.25 writes it (``meta`` of plain types beside the
    ``state_dict``, with ``num_batches_tracked`` buffers): read with
    weights_only, converted, and the alternative ``mask_embed.{0,2,4}``
    naming of the head's MLP gives the same weights."""
    from openpvsg_torch.train.checkpoint import (convert_mmdet_mask2former,
                                                 load_mmdet_checkpoint)

    sd = {k: torch.from_numpy(v) for k, v in mmdet_sd.items()}
    sd["backbone.bn1.num_batches_tracked"] = torch.tensor(7)
    path = str(tmp_path / "m2f.pth")
    torch.save({"meta": {"epoch": 8, "iter": 1000, "mmdet_version": "2.25.0",
                         "CLASSES": ["a", "b"]}, "state_dict": sd}, path)
    loaded = load_mmdet_checkpoint(path)
    assert loaded.keys() == sd.keys()
    assert all(np.array_equal(loaded[k].numpy(), mmdet_sd[k]) for k in mmdet_sd)
    want = convert_mmdet_mask2former(loaded, _tiny(tcfg))
    renamed = {}
    for k, v in loaded.items():
        m = re.match(r"(panoptic_head\.mask_embed\.)layers\.(\d)\.(.*)", k)
        renamed[f"{m[1]}{2 * int(m[2])}.{m[3]}" if m else k] = v
    assert "panoptic_head.mask_embed.4.weight" in renamed
    got = convert_mmdet_mask2former(renamed, _tiny(tcfg))
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_load_mmdet_checkpoint_warns_before_a_full_unpickle(tmp_path):
    """A .pth whose ``meta`` holds a class ``weights_only`` refuses raises
    by default, naming ``trusted=True``; with it, the file is read again as
    a full pickle, after a warning naming the file."""
    import argparse

    from openpvsg_torch.train.checkpoint import load_mmdet_checkpoint

    path = str(tmp_path / "old.pth")
    torch.save({"meta": {"config": argparse.Namespace(depth=50)},
                "state_dict": {"backbone.conv1.weight": torch.ones(2)}}, path)
    with pytest.raises(pickle.UnpicklingError,
                       match=r"(?s)old\.pth: not loadable with weights_only.*trusted=True"):
        load_mmdet_checkpoint(path)
    with pytest.warns(UserWarning, match=r"old\.pth: not loadable with weights_only"):
        sd = load_mmdet_checkpoint(path, trusted=True)
    assert list(sd) == ["backbone.conv1.weight"]


# ---------------------------------------------------------------------------
# VPS stage 2 with the MSDA model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def segmenters():
    """(JAX segmenter, port segmenter) with encoder='msda' on the same
    random weights (a flax init, BN statistics randomized, the void logit
    pushed down so segments survive; tests/test_torch_stage2.py's recipe)."""
    from openpvsg_tpu.infer.segmenter import SegmenterInference as JaxSeg
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.weights import from_jax_params

    def cfg(m):
        return _tiny(m, enc_layers=1, object_mask_thr=0.01, iou_thr=0.1)

    variables = jax.tree_util.tree_map(np.asarray, jax.jit(JaxM2F(cfg(jcfg)).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, H, W, 3))))
    rng = np.random.default_rng(2)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: ((1.0 + rng.random(v.shape)) if path[-1].key == "var"
                         else 0.1 * rng.standard_normal(v.shape)).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(np.array, variables["params"])
    params["head"]["cls_embed"]["bias"][-1] -= 4.0
    variables = {"params": params, "batch_stats": stats}
    jax_seg = JaxSeg(cfg(jcfg), variables, fused_fpn=True)
    seg = SegmenterInference(cfg(tcfg), from_jax_params(variables, cfg(tcfg)),
                             device="cpu")
    return jax_seg, seg


def test_stage2_vps_msda_matches_jax(segmenters, tmp_path):
    """run_query_tube_vps (window 2) over 6 moving-block PNG frames: masks.txt
    byte-identical, query_feats.pickle's tubes equal (features 1e-4)."""
    from openpvsg_tpu.infer import stages as jax_stages
    from openpvsg_torch.infer import stages

    jax_seg, seg = segmenters
    rng = np.random.default_rng(0)
    frames = []
    for t in range(6):
        img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        img[8:24, 8 + 2 * t:24 + 2 * t] = [250, 30, 30]
        img[48:, :] = [30, 250, 30]
        frames.append(str(tmp_path / f"{t:04d}.png"))
        Image.fromarray(img).save(frames[-1])
    n_jax = jax_stages.run_query_tube_vps(jax_seg, frames, str(tmp_path / "jax"), window=2)
    n = stages.run_query_tube_vps(seg, frames, str(tmp_path / "torch"), window=2)
    texts = [open(tmp_path / side / "quantitive" / "masks.txt", "rb").read()
             for side in ("jax", "torch")]
    assert len(texts[0].splitlines()) >= 6, "too few kept segments"
    assert texts[1] == texts[0] and n == n_jax
    tubes = []
    for side in ("jax", "torch"):
        with open(os.path.join(tmp_path, side, "query_feats.pickle"), "rb") as f:
            tubes.append(pickle.load(f))
    want, got = tubes
    assert [t.track_id for t in got] == [t.track_id for t in want]
    for gt, wt in zip(got, want):
        for g, w_ in zip(gt.qf_tube, wt.qf_tube):
            assert (g is None) == (w_ is None)
            if g is not None:
                assert g["cls_id"] == w_["cls_id"]
                np.testing.assert_allclose(g["query_feat"], w_["query_feat"],
                                           atol=1e-4, rtol=1e-4)
