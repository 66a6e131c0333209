"""The Swin backbone of the PyTorch port against the JAX package on the CPU:
the same weights (a flax init passed through from_jax_params) and the same
numpy inputs go through both.

Covered: ``WindowAttention`` with and without the shift mask, unshifted and
shifted ``SwinBlock``, ``SwinTransformer('tiny')`` at 64x64 and at 72x88
(its stride-4 grid, 18x22, is no multiple of the window, so every stage
pads), the whole Swin segmenter's forward and VPS stage 2, the flax weight
round trip, and ``convert_mmdet_swin`` against a replica of mmdet's Swin.

Tolerances: the modules and the backbone atol/rtol 1e-4
(tests/test_torch_modules.py's); the segmenter's forward cls 1e-4, masks
1e-3, query 1e-4 (tests/test_torch_stage2.py's, the JAX side running the
Pallas FPN kernel in interpret mode); stage 2's masks.txt byte-identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

MODULE_TOL = dict(atol=1e-4, rtol=1e-4)
H, W, T_FRAMES = 64, 64, 6


def _tiny(m):
    """tests/test_torch_stage2.py's tiny segmenter with the Swin-T backbone
    (the smallest Swin the JAX package has)."""
    return m.Mask2FormerConfig(
        num_things_classes=3, num_stuff_classes=2, num_queries=8,
        backbone=m.BackboneConfig(kind="swin", swin_variant="tiny"),
        pixel_decoder=m.PixelDecoderConfig(in_channels=(96, 192, 384, 768),
                                           encoder_layers=1, ffn_channels=64),
        decoder=m.TransformerDecoderConfig(num_layers=3, ffn_channels=64),
        object_mask_thr=0.01, iou_thr=0.1)


def _np(t):
    return t.detach().numpy()


def _port_module(module, params):
    """``module`` loaded with a flax ``params`` subtree."""
    from openpvsg_torch.weights import _convert_leaf, _flatten

    module.load_state_dict(dict(_convert_leaf(p, a) for p, a in _flatten(params)),
                           strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def segmenters():
    """(JAX variables, JAX segmenter, port segmenter) on the same weights,
    the void logit pushed down so that fusion keeps segments."""
    from openpvsg_tpu.infer.segmenter import SegmenterInference as JaxSeg
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.weights import from_jax_params

    variables = jax.jit(JaxM2F(_tiny(jcfg)).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, H, W, 3)))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    params["head"]["cls_embed"]["bias"][-1] -= 4.0
    variables = {"params": params}
    jax_seg = JaxSeg(_tiny(jcfg), variables, fused_fpn=True)
    seg = SegmenterInference(_tiny(tcfg), from_jax_params(variables, _tiny(tcfg)),
                             device="cpu")
    assert seg.cfg.backbone.norm == "frozen_bn"  # nothing to fold
    return variables, jax_seg, seg


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_jax(rng, masked):
    from openpvsg_tpu.models.swin import WindowAttention as JaxWA
    from openpvsg_torch.models.swin import WindowAttention, shift_window_mask

    x = rng.standard_normal((6, 49, 32)).astype(np.float32)
    mask = shift_window_mask(14, 21, 7, 3) if masked else None
    m = JaxWA(32, 2, 7)
    params = m.init(jax.random.PRNGKey(1), x, mask)["params"]
    params = dict(params, rel_bias_table=rng.standard_normal(
        params["rel_bias_table"].shape).astype(np.float32))
    want = m.apply({"params": params}, x, mask)
    net = _port_module(WindowAttention(32, 2, 7), params)
    with torch.no_grad():
        got = net(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("shift", [0, 3])
def test_swin_block_matches_jax(rng, shift):
    """A 14x21 grid of 2 images: 6 windows each; the shifted block masks
    across its roll."""
    from openpvsg_tpu.models.swin import SwinBlock as JaxBlock
    from openpvsg_torch.models.swin import SwinBlock

    x = rng.standard_normal((2, 14, 21, 32)).astype(np.float32)
    m = JaxBlock(32, 2, 7, shift)
    params = m.init(jax.random.PRNGKey(2), x)["params"]
    params["attn"] = dict(params["attn"], rel_bias_table=rng.standard_normal(
        params["attn"]["rel_bias_table"].shape).astype(np.float32))
    want = m.apply({"params": params}, x)
    net = _port_module(SwinBlock(32, 2, 7, shift), params)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("hw", [(64, 64), (72, 88)])
def test_swin_transformer_matches_jax(segmenters, rng, hw):
    """The four LayerNormed scales of Swin-T; at 72x88 every stage pads
    (18x22 -> 21x28, 9x11 -> 14x14, 5x6 -> 7x7, 3x3 -> 7x7) and the odd
    grids pad before their merge (9x11 -> 10x12, 5x6 -> 6x6)."""
    from openpvsg_tpu.models.swin import SwinTransformer as JaxSwin

    variables, _, seg = segmenters
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    want = jax.jit(JaxSwin("tiny").apply)(
        {"params": variables["params"]["backbone"]}, x)
    with torch.no_grad():
        got = seg.model.backbone(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [
        (2, -(-hw[0] // s), -(-hw[1] // s), c)
        for s, c in ((4, 96), (8, 192), (16, 384), (32, 768))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **MODULE_TOL)


# ---------------------------------------------------------------------------
# the segmenter
# ---------------------------------------------------------------------------

def test_forward_frames_matches_jax(segmenters, rng):
    _, jax_seg, seg = segmenters
    frames = rng.integers(0, 255, (2, H, W, 3)).astype(np.uint8)
    want = jax_seg.forward_frames(frames)
    got = seg.forward_frames(frames)
    assert got[1].shape == (2, 8, H // 4, W // 4)
    for g, w, tol in zip(got, want, (1e-4, 1e-3, 1e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, rtol=tol)


def test_stage2_vps_masks_txt_matches_jax(segmenters, tmp_path):
    """run_query_tube_vps with the Swin segmenter, windows of 2: the port's
    masks.txt is the JAX package's, byte for byte."""
    from openpvsg_tpu.infer import stages as jax_stages
    from openpvsg_torch.infer import stages

    _, jax_seg, seg = segmenters
    rng = np.random.default_rng(0)
    paths = []
    for t in range(T_FRAMES):  # tests/test_end2end.py's moving block
        img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        img[8:24, 8 + 2 * t:24 + 2 * t] = [250, 30, 30]
        img[48:, :] = [30, 250, 30]
        paths.append(str(tmp_path / f"{t:04d}.png"))
        Image.fromarray(img).save(paths[-1])
    n_jax = jax_stages.run_query_tube_vps(jax_seg, paths, str(tmp_path / "jax"),
                                          window=2)
    n = stages.run_query_tube_vps(seg, paths, str(tmp_path / "torch"), window=2)
    want = (tmp_path / "jax" / "quantitive" / "masks.txt").read_bytes()
    got = (tmp_path / "torch" / "quantitive" / "masks.txt").read_bytes()
    assert len(want.splitlines()) >= T_FRAMES, "too few kept segments"
    assert got == want and n == n_jax


def test_weights_round_trip_through_flax_layout(segmenters):
    from openpvsg_torch.weights import from_jax_params, to_jax_params

    variables = segmenters[0]
    cfg = _tiny(tcfg)
    state = from_jax_params(variables, cfg)
    assert state["backbone.stage0_block0.attn.rel_bias_table"].shape == (169, 3)
    assert "backbone.downsample0.reduction.bias" not in state
    back = to_jax_params(state, cfg)
    want = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert got.keys() == want.keys() and back["batch_stats"] == {}
    assert all(np.array_equal(got[k], want[k]) for k in want)
    state["backbone.downsample0.reduction.bias"] = torch.zeros(192)
    with pytest.raises(ValueError, match="keys the configured model does not use"):
        to_jax_params(state, cfg)


# ---------------------------------------------------------------------------
# Swin-L and the ``mask2former_swinl_vps`` preset
# ---------------------------------------------------------------------------

def test_swin_large_has_the_published_widths():
    """Mask2Former's Swin-L: embed dim 192 doubling per stage, blocks
    2-2-18-2, heads 6-12-24-48 (head size 32 in every stage), MLP ratio 4,
    window 12 with its 23²-row relative-bias table, shift 6 in every second
    block."""
    from openpvsg_torch.models.swin import SwinTransformer

    with torch.device("meta"):
        net = SwinTransformer("large")
    assert net.window == 12 and net.depths == (2, 2, 18, 2)
    assert hasattr(net, "stage2_block17") and not hasattr(net, "stage2_block18")
    for s, (C, heads) in enumerate(zip((192, 384, 768, 1536), (6, 12, 24, 48))):
        first, second = (getattr(net, f"stage{s}_block{b}") for b in (0, 1))
        assert second.norm1.normalized_shape == (C,) and C // heads == 32
        assert second.attn.num_heads == heads
        assert second.attn.rel_bias_table.shape == (23 * 23, heads)
        assert second.attn.rel_index.shape == (144 * 144,)
        assert (first.shift, second.shift, second.window) == (0, 6, 12)
        assert second.mlp_fc1.out_features == 4 * C
    assert net.patch_embed.weight.shape == (192, 3, 4, 4)


@pytest.mark.parametrize("variant", ["tiny", "small", "base"])
def test_the_other_variants_keep_window_7(variant):
    from openpvsg_torch.models.swin import SwinTransformer, swin_window

    with torch.device("meta"):
        net = SwinTransformer(variant)
    block = net.stage0_block1
    assert swin_window(variant) == net.window == block.window == 7
    assert block.shift == 3 and block.attn.rel_bias_table.shape[0] == 13 * 13


def test_swinl_preset_serves_stage2_and_reads_back(tmp_path):
    """``mask2former_swinl_vps`` (Swin-L, the MSDA decoder, 200 queries)
    serves VPS stage 2 through ``SegmenterInference`` and
    ``run_query_tube_vps`` on the CPU: 4 frames of 64x64 (stride-4 grid
    16x16, padded to 24x24) as one batch of two windows; and the preset
    reads back through ``save_config`` / ``load_config_file``."""
    import dataclasses

    from openpvsg_torch.infer import stages
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.weights import random_state_dict

    cfg = tcfg.get_config("mask2former_swinl_vps")
    m = cfg.model
    assert (m.num_queries, m.backbone.kind, m.backbone.swin_variant, m.pixel_decoder.encoder,
            m.pixel_decoder.in_channels, m.video, m.num_frames) == (
        200, "swin", "large", "msda", (192, 384, 768, 1536), True, 2)
    path = str(tmp_path / "config.json")
    tcfg.save_config(cfg, path)
    assert tcfg.config_to_dict(tcfg.load_config_file(path)) == tcfg.config_to_dict(cfg)
    m = dataclasses.replace(m, object_mask_thr=0.0, iou_thr=0.1)
    seg = SegmenterInference(m, random_state_dict(m, 0), device="cpu")
    assert seg.model.backbone.window == 12 and seg.model.head.query_feat.shape == (200, 256)
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 255, (64, 64, 3), dtype=np.uint8) for _ in range(4)]
    n = stages.run_query_tube_vps(seg, frames, str(tmp_path / "out"), window=2,
                                  windows_per_batch=2)
    lines = (tmp_path / "out" / "quantitive" / "masks.txt").read_text().splitlines()
    assert n > 0 and {int(line.split()[0]) for line in lines} == {1, 2, 3, 4}


# ---------------------------------------------------------------------------
# mmdet Swin checkpoints
# ---------------------------------------------------------------------------

REPLICA = (32, (2, 1, 1, 1), (1, 2, 2, 4))  # embed dim, depths, heads
LN_EPS = 1e-6


def _mmdet_swin_state(rng):
    """A random mmdet 2.25 ``SwinTransformer`` state dict of the REPLICA
    shapes under ``backbone.``, norms and biases random too, so that every
    layout shows."""
    C0, depths, heads = REPLICA
    sd = {}

    def put(k, *shape, scale=None):
        fan = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        v = rng.standard_normal(shape) * (scale or 1 / np.sqrt(fan))
        sd["backbone." + k] = torch.from_numpy(v.astype(np.float32))

    def norm(k, c):
        put(k + ".weight", c, scale=0.2)
        sd[f"backbone.{k}.weight"] += 1.0
        put(k + ".bias", c, scale=0.1)

    put("patch_embed.projection.weight", C0, 3, 4, 4)
    put("patch_embed.projection.bias", C0, scale=0.1)
    norm("patch_embed.norm", C0)
    C = C0
    for s, depth in enumerate(depths):
        for b in range(depth):
            p = f"stages.{s}.blocks.{b}"
            norm(p + ".norm1", C)
            norm(p + ".norm2", C)
            put(p + ".attn.w_msa.qkv.weight", 3 * C, C)
            put(p + ".attn.w_msa.qkv.bias", 3 * C, scale=0.1)
            put(p + ".attn.w_msa.proj.weight", C, C)
            put(p + ".attn.w_msa.proj.bias", C, scale=0.1)
            put(p + ".attn.w_msa.relative_position_bias_table", 169, heads[s], scale=0.5)
            sd[f"backbone.{p}.attn.w_msa.relative_position_index"] = _mmdet_rel_index(7)
            put(p + ".ffn.layers.0.0.weight", 4 * C, C)
            put(p + ".ffn.layers.0.0.bias", 4 * C, scale=0.1)
            put(p + ".ffn.layers.1.weight", C, 4 * C)
            put(p + ".ffn.layers.1.bias", C, scale=0.1)
        norm(f"norm{s}", C)
        if s < len(depths) - 1:
            norm(f"stages.{s}.downsample.norm", 4 * C)
            put(f"stages.{s}.downsample.reduction.weight", 2 * C, 4 * C)
            C *= 2
    return sd


def _mmdet_rel_index(ws):
    """mmdet ``WindowMSA``'s relative_position_index (double_step_seq)."""
    seq1 = torch.arange(0, (2 * ws - 1) * ws, 2 * ws - 1)
    seq2 = torch.arange(0, ws, 1)
    coords = (seq1[:, None] + seq2[None, :]).reshape(1, -1)
    return (coords + coords.T).flip(1).contiguous()


def _mmdet_swin_forward(sd, x):
    """mmdet 2.25 ``SwinTransformer.forward`` on an input that no stage pads
    (224x224: grids 56, 28, 14, 7): tokens (B, L, C), ``WindowMSA`` scaling
    q before q.k, ``ShiftWindowMSA``'s roll and mask, and ``PatchMerging``
    by ``nn.Unfold`` (kernel 2, stride 2), whose 4C features are in
    (c, dy, dx) order. GELU and the LayerNorm eps are the JAX package's
    (tanh, 1e-6), so that only the weight layout is under test."""
    C, depths, heads = REPLICA
    ws = 7

    def g(k):
        return sd["backbone." + k]

    def ln(t, k):
        return F.layer_norm(t, (t.shape[-1],), g(k + ".weight"), g(k + ".bias"), LN_EPS)

    x = F.conv2d(x, g("patch_embed.projection.weight"),
                 g("patch_embed.projection.bias"), stride=4)
    B, _, Hs, Ws = x.shape
    x = ln(x.flatten(2).transpose(1, 2), "patch_embed.norm")
    outs = []
    for s, depth in enumerate(depths):
        nh = heads[s]
        for b in range(depth):
            p = f"stages.{s}.blocks.{b}"
            shift = 0 if b % 2 == 0 else ws // 2
            y = ln(x, p + ".norm1").view(B, Hs, Ws, C)
            mask = None
            if shift:
                y = torch.roll(y, (-shift, -shift), dims=(1, 2))
                img = torch.zeros((1, Hs, Ws, 1))
                cnt = 0
                for hsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
                    for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
                        img[:, hsl, wsl, :] = cnt
                        cnt += 1
                mw = (img.view(1, Hs // ws, ws, Ws // ws, ws, 1).permute(0, 1, 3, 2, 4, 5)
                      .reshape(-1, ws * ws))
                mask = mw.unsqueeze(1) - mw.unsqueeze(2)
                mask = mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)
            win = (y.view(B, Hs // ws, ws, Ws // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
                   .reshape(-1, ws * ws, C))
            n, N = win.shape[:2]
            a = p + ".attn.w_msa"
            qkv = (F.linear(win, g(a + ".qkv.weight"), g(a + ".qkv.bias"))
                   .reshape(n, N, 3, nh, C // nh).permute(2, 0, 3, 1, 4))
            q, k, v = qkv[0] * (C // nh) ** -0.5, qkv[1], qkv[2]
            attn = q @ k.transpose(-2, -1)
            bias = g(a + ".relative_position_bias_table")[
                g(a + ".relative_position_index").view(-1)].view(N, N, -1)
            attn = attn + bias.permute(2, 0, 1).unsqueeze(0)
            if mask is not None:
                nW = mask.shape[0]
                attn = (attn.view(n // nW, nW, nh, N, N)
                        + mask.unsqueeze(1).unsqueeze(0)).view(-1, nh, N, N)
            o = (attn.softmax(-1) @ v).transpose(1, 2).reshape(n, N, C)
            o = F.linear(o, g(a + ".proj.weight"), g(a + ".proj.bias"))
            y = (o.view(B, Hs // ws, Ws // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
                 .reshape(B, Hs, Ws, C))
            if shift:
                y = torch.roll(y, (shift, shift), dims=(1, 2))
            x = x + y.reshape(B, Hs * Ws, C)
            f = p + ".ffn.layers"
            y = F.gelu(F.linear(ln(x, p + ".norm2"), g(f + ".0.0.weight"),
                                g(f + ".0.0.bias")), approximate="tanh")
            x = x + F.linear(y, g(f + ".1.weight"), g(f + ".1.bias"))
        outs.append(ln(x, f"norm{s}").view(B, Hs, Ws, C))
        if s < len(depths) - 1:
            d = f"stages.{s}.downsample"
            u = F.unfold(x.view(B, Hs, Ws, C).permute(0, 3, 1, 2), kernel_size=2,
                         stride=2).transpose(1, 2)
            x = F.linear(ln(u, d + ".norm"), g(d + ".reduction.weight"))
            Hs, Ws, C = Hs // 2, Ws // 2, 2 * C
    return outs


def test_convert_mmdet_swin_against_unfold_replica(rng, monkeypatch):
    """The port's converter reorders the patch-merging weights from mmdet's
    unfold order, so the port's Swin holding them computes what mmdet's
    does; the JAX converter's copy, unreordered, does not (ROADMAP.md §C).
    Every other weight is the JAX converter's."""
    from openpvsg_tpu.train.checkpoint import convert_mmdet_swin as jax_convert
    from openpvsg_torch.models import swin
    from openpvsg_torch.train.checkpoint import convert_mmdet_swin
    from openpvsg_torch.weights import _convert_leaf, _flatten

    monkeypatch.setitem(swin.SWIN_CONFIGS, "replica", REPLICA)
    sd = _mmdet_swin_state(rng)
    x = rng.standard_normal((1, 3, 224, 224)).astype(np.float32)
    with torch.no_grad():
        want = _mmdet_swin_forward(sd, torch.from_numpy(x))
    ported = convert_mmdet_swin(sd)
    net = swin.SwinTransformer("replica")
    net.load_state_dict(ported, strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 2, 3, 1))
    for gt, w in zip(got, want):
        np.testing.assert_allclose(_np(gt), _np(w), **MODULE_TOL)

    tree = jax_convert({k: v.numpy() for k, v in sd.items()})["params"]
    as_jax = dict(_convert_leaf(p, a) for p, a in _flatten(tree))
    assert as_jax.keys() == ported.keys()
    merges = {k for k in ported if k.startswith("downsample")}
    assert len(merges) == 9
    for k in ported:
        assert torch.equal(ported[k], as_jax[k]) != (k in merges), k
    net.load_state_dict(as_jax, strict=True)
    with torch.no_grad():
        unreordered = net(torch.from_numpy(x).permute(0, 2, 3, 1))
    assert np.abs(_np(unreordered[1]) - _np(want[1])).max() > 0.1
