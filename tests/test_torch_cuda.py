"""The port's CUDA kernels against their plain versions on the card, at
shapes the main path does not reach (ragged tiles, narrow channels, few
queries, exact ties), plus the wrappers' argument checks and the model's
GPU path against its CPU path.

Every test needs a GPU: they carry the ``cuda`` marker and skip without one.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: float32 with TF32 off, 1e-4 of the output scale (sums of up to
9 * C products in another order); bfloat16, 1e-2 of the scale per launch
(one rounding of the output, one of the on-load operand) and 5e-2 for the
chain against the bfloat16 module chain, which rounds after every module.
"""
import numpy as np
import pytest
import torch

from openpvsg_torch.kernels import fpn, fusion

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rel):
    scale = max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * scale, (err, rel * scale)


def _fpn_case(B, H, W, Cin, C, Cout, dt, dev, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*s, scale=1.0, shift=0.0):
        return (torch.randn(s, generator=g) * scale + shift).to(dev)

    p = {"w_lat": r(Cin, C, scale=Cin ** -0.5), "b_lat": r(C, scale=0.1),
         "gn1_scale": r(C, scale=0.3, shift=1.0), "gn1_bias": r(C, scale=0.1),
         "w_out": r(3, 3, C, C, scale=(9 * C) ** -0.5), "b_out": r(C, scale=0.1),
         "gn2_scale": r(C, scale=0.3, shift=1.0), "gn2_bias": r(C, scale=0.1),
         "w_mask": r(C, Cout, scale=C ** -0.5), "b_mask": r(Cout, scale=0.1)}
    f0 = r(B, H, W, Cin).to(dt).contiguous()
    s8 = r(B, H // 2, W // 2, C).to(dt).contiguous()
    return f0, s8, p


# (B, H, W, Cin, C, Cout, groups): ragged pixel tiles (H*W not a multiple of
# 128 or 64; H and W not multiples of the bf16 conv's 24x8 tile, H*W not
# one of its 192 pixels), channel counts that are multiples of 8 but not of
# 16 or 64, output widths below one tile, the main-path width (B = 2), the
# test CLI's IPS batch (8 frames of 360x640, padded to 384x640), and Swin-T's
# stride-4 width (Cin 96: the bf16 GEMM reads K up to 128 through TMA's zero
# fill)
FPN_CASES = [(1, 16, 24, 32, 32, 16, 4), (2, 18, 30, 96, 64, 48, 8),
             (2, 32, 40, 136, 256, 200, 32), (1, 96, 120, 256, 256, 256, 32),
             (2, 20, 36, 64, 64, 64, 8), (2, 96, 120, 256, 256, 256, 32),
             (8, 96, 160, 256, 256, 256, 32), (2, 96, 120, 96, 256, 256, 32)]


@pytest.mark.parametrize("case", FPN_CASES)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_fpn_launches_match_plain(dev, case, dt):
    B, H, W, Cin, C, Cout, G = case
    f0, s8, p = _fpn_case(B, H, W, Cin, C, Cout, dt, dev)
    rel = 1e-4 if dt == torch.float32 else 1e-2
    w_lat = p["w_lat"].to(dt).contiguous()
    w_out = p["w_out"].to(dt).contiguous()
    w_mask = p["w_mask"].to(dt).contiguous()
    count = H * W * (C // G)
    before = [fn.launches for fn in fpn.KERNEL_WRAPPERS]

    l_ref, s1, q1 = fpn.lateral_stats_plain(f0, w_lat, p["b_lat"])
    l_got, s1k, q1k = fpn.lateral_stats(f0, w_lat, p["b_lat"])
    _close(l_got, l_ref, rel)
    _close(s1k, s1, 1e-4)
    _close(q1k, q1, 1e-4)
    sc1, bi1 = fpn.group_affine(s1, q1, p["gn1_scale"], p["gn1_bias"], count, G, 1e-6)
    x2_ref, s2, q2 = fpn.conv3x3_stats_plain(l_ref, s8, sc1, bi1, w_out, p["b_out"])
    x2_got, s2k, q2k = fpn.conv3x3_stats(l_ref, s8, sc1, bi1, w_out, p["b_out"])
    _close(x2_got, x2_ref, rel)
    _close(s2k, s2, 1e-3)
    _close(q2k, q2, 1e-3)
    sc2, bi2 = fpn.group_affine(s2, q2, p["gn2_scale"], p["gn2_bias"], count, G, 1e-6)
    _close(fpn.mask_proj(x2_ref, sc2, bi2, w_mask, p["b_mask"]),
           fpn.mask_proj_plain(x2_ref, sc2, bi2, w_mask, p["b_mask"]), rel)
    _close(fpn.fpn_stride4(f0, s8, p, G), fpn.fpn_stride4_plain(f0, s8, p, G),
           2e-4 if dt == torch.float32 else 5e-2)
    after = [fn.launches for fn in fpn.KERNEL_WRAPPERS]
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_fpn_chain_is_deterministic(dev, dt):
    """GroupNorm sums are per-tile partials summed in a fixed order: two
    calls give the same bits."""
    f0, s8, p = _fpn_case(2, 96, 120, 256, 256, 256, dt, dev, seed=1)
    first = fpn.fpn_stride4(f0, s8, p)
    for _ in range(2):
        assert torch.equal(fpn.fpn_stride4(f0, s8, p), first)


def test_fpn_wrappers_check_their_arguments(dev):
    f0, s8, p = _fpn_case(1, 16, 24, 32, 32, 16, torch.float32, dev)
    w = p["w_lat"].contiguous()
    with pytest.raises(TypeError):
        fpn.lateral_stats(f0.to(torch.float16), w.half(), p["b_lat"])
    with pytest.raises(TypeError):
        fpn.lateral_stats(f0, w, p["b_lat"].double())
    with pytest.raises(ValueError, match="contiguous"):
        fpn.lateral_stats(f0.permute(0, 2, 1, 3), w, p["b_lat"])
    with pytest.raises(ValueError):
        fpn.lateral_stats(f0, w[:, :8].contiguous(), p["b_lat"])
    with pytest.raises(ValueError, match="on cpu"):
        fpn.lateral_stats(f0, w.cpu(), p["b_lat"])
    with pytest.raises(ValueError, match="aligned"):
        # contiguous, but 8 bytes past an aligned address
        fpn.lateral_stats(f0.flatten()[2:2 + 16 * 23 * 32].view(1, 16, 23, 32), w,
                          p["b_lat"])
    # channel counts: multiples of 8 in both routes; at most 256 in bf16
    with pytest.raises(ValueError, match="multiple of 8"):
        fpn.lateral_stats(f0[..., :12].contiguous(), w[:12].contiguous(), p["b_lat"])
    bf = torch.bfloat16
    wide = torch.zeros((1, 4, 4, 264), dtype=bf, device=dev)
    with pytest.raises(ValueError, match="at most 256"):
        fpn.lateral_stats(wide, torch.zeros((264, 32), dtype=bf, device=dev),
                          p["b_lat"])
    with pytest.raises(ValueError, match="at most 256"):
        fpn.mask_proj(wide, torch.zeros((1, 264), device=dev),
                      torch.zeros((1, 264), device=dev),
                      torch.zeros((264, 16), dtype=bf, device=dev),
                      torch.zeros(16, device=dev))
    with pytest.raises(ValueError, match="at most 256"):
        fpn.conv3x3_stats(wide, torch.zeros((1, 2, 2, 264), dtype=bf, device=dev),
                          torch.zeros((1, 264), device=dev),
                          torch.zeros((1, 264), device=dev),
                          torch.zeros((3, 3, 264, 264), dtype=bf, device=dev),
                          torch.zeros(264, device=dev))
    # the float32 route takes them
    out = fpn.lateral_stats(wide.float(), torch.zeros((264, 32), device=dev),
                            p["b_lat"])[0]
    assert out.shape == (1, 4, 4, 32)


# sigmoid(u) >= 0.5 flips near u = -1.78e-7, not at 0; the kernel decides the
# binary bit by the sign outside |u| < 2^-12 and by the exact formula inside
_BAND = 2.0 ** -12
_EDGE_VALUES = [0.0, -0.0, -1e-7, -1.78e-7, -1.7829e-7, -1.8e-7, -2e-7,
                _BAND, -_BAND, _BAND * (1 - 2 ** -23), -_BAND * (1 - 2 ** -23),
                _BAND * (1 + 2 ** -23), -_BAND * (1 + 2 ** -23)]


def _fusion_case(kind, N, Q, h, w, g):
    low = torch.randn((N, Q, h, w), generator=g) * 3
    scores = torch.rand((N, Q), generator=g) * 0.9 + 0.1
    if kind == "random":
        scores[torch.rand((N, Q), generator=g) < 0.3] = float("-inf")
    elif kind == "flip_band":
        # planes of edge values, so upsampled values sit at them and at
        # their blends
        vals = torch.tensor(_EDGE_VALUES)
        idx = torch.randint(0, len(vals), (N, Q, h, w), generator=g)
        low = torch.where(torch.rand((N, Q, 1, 1), generator=g) < 0.5, vals[idx],
                          vals[idx[..., :1, :1]].expand(N, Q, h, w))
    elif kind == "ties":
        # sigmoid(40) == 1.0: two queries tie at val == score, the lower wins
        tied = [Q // 3, Q - 1]
        low[:, tied] = 40.0
        scores[:] = torch.rand((N, Q), generator=g) * 0.5
        scores[:, tied] = 0.75
    elif kind == "tie_order":
        # val 0.375 twice: a higher index with the higher score (visited
        # first, sigmoid(0) = 0.5) and a lower index (sigmoid(40) = 1.0); the
        # lower index takes the pixel on the tie
        scores[:] = torch.rand((N, Q), generator=g) * 0.3
        low[:, Q // 3], scores[:, Q // 3] = 40.0, 0.375
        low[:, Q - 1], scores[:, Q - 1] = 0.0, 0.75
    elif kind == "all_dropped":
        scores[:] = float("-inf")
    elif kind == "one_kept":
        keep = scores[:, :1].clone()
        scores[:] = float("-inf")
        scores[:, Q // 2] = keep[:, 0]
    elif kind == "no_skip":
        scores[:] = 0.5
    return low.contiguous(), scores


# (N, Q, h, w, ori): tiles of 8x8 low-res pixels that end partway, ori below
# the padded frame, one query, more queries than a 32-query ring stage holds
# (Q = 130 ends with one query per group), the main-path width with a
# ragged edge, and the test CLI's IPS batch (8 frames of 360x640)
FUSION_SHAPES = [(1, 1, 5, 7, (20, 28)), (2, 7, 16, 20, (57, 70)),
                 (3, 100, 24, 30, (90, 120)), (3, 130, 24, 30, (81, 117)),
                 (2, 100, 97, 121, (383, 470)), (8, 100, 96, 160, (360, 640))]
FUSION_KINDS = ["random", "flip_band", "ties", "tie_order", "all_dropped", "one_kept",
                "no_skip"]


@pytest.mark.parametrize("kind", FUSION_KINDS)
@pytest.mark.parametrize("N,Q,h,w,ori", FUSION_SHAPES)
def test_fusion_matches_plain(dev, N, Q, h, w, ori, kind):
    g = torch.Generator().manual_seed(Q)
    low, scores = _fusion_case(kind, N, Q, h, w, g)
    low, scores = low.to(dev), scores.to(dev)
    before = fusion.fusion_maps.launches
    got = fusion.fusion_maps(low, scores, (4 * h, 4 * w), ori)
    want = fusion.fusion_maps_plain(low, scores, ori)
    assert fusion.fusion_maps.launches == before + 1
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    for a, b in zip(got, want):
        assert torch.equal(a, b.to(a.dtype))


@pytest.mark.parametrize("N,Q,h,w", [(1, 3, 5, 7), (2, 100, 96, 120), (2, 130, 97, 121)])
def test_fusion_exact_sigmoid_count(dev, N, Q, h, w):
    """The counting build evaluates the sigmoid for all eight pixels of every
    lane of a warp that needs one: with one kept query that is each tile's
    first visit of it (tiles of 8x8 low-res pixels, padding included); with
    every query dropped, none. It is not a launch of the main path."""
    g = torch.Generator().manual_seed(Q)
    tile_pixels = N * 16 * (8 * -(-h // 8)) * (8 * -(-w // 8))
    before = fusion.fusion_maps.launches
    counts = {}
    for kind in ("all_dropped", "one_kept", "random", "no_skip"):
        low, scores = _fusion_case(kind, N, Q, h, w, g)
        counts[kind] = fusion.exact_sigmoid_count(low.to(dev), scores.to(dev),
                                                  (4 * h, 4 * w), (4 * h, 4 * w))
    assert fusion.fusion_maps.launches == before
    assert counts["all_dropped"] == 0 and counts["one_kept"] == tile_pixels
    for kind in ("random", "no_skip"):
        assert counts[kind] % 256 == 0
        assert tile_pixels <= counts[kind] <= Q * tile_pixels


def test_fusion_ties_go_to_the_first_query(dev):
    g = torch.Generator().manual_seed(0)
    low = torch.randn((1, 6, 8, 10), generator=g)
    low[0, 4] = low[0, 1]
    scores = torch.tensor([[0.2, 0.9, 0.3, float("-inf"), 0.9, 0.1]])
    owner = fusion.fusion_maps(low.to(dev), scores.to(dev), (32, 40), (32, 40))[0]
    assert not bool((owner == 4).any())
    plain = fusion.fusion_maps_plain(low.to(dev), scores.to(dev), (32, 40))[0]
    assert torch.equal(owner, plain.to(owner.dtype))
    # every query dropped: argmax of an all -inf column is 0
    dropped = torch.full((1, 6), float("-inf"))
    owner = fusion.fusion_maps(low.to(dev), dropped.to(dev), (32, 40), (32, 40))[0]
    assert not bool(owner.any())


def test_fusion_checks_its_arguments(dev):
    low = torch.zeros((1, 4, 8, 10), device=dev)
    scores = torch.zeros((1, 4), device=dev)
    with pytest.raises(ValueError, match="4x"):
        fusion.fusion_maps(low, scores, (30, 40), (30, 40))
    with pytest.raises(TypeError):
        fusion.fusion_maps(low.double(), scores, (32, 40), (32, 40))
    with pytest.raises(ValueError):
        fusion.fusion_maps(low, scores[:, :3].contiguous(), (32, 40), (32, 40))


def test_model_gpu_path_matches_cpu_path(dev):
    """The tiny segmenter (R-26) on the card, through the kernels, against
    the same weights on the CPU, through the plain versions (float32)."""
    from openpvsg_torch.config import (BackboneConfig, Mask2FormerConfig,
                                       PixelDecoderConfig,
                                       TransformerDecoderConfig)
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.weights import random_state_dict

    cfg = Mask2FormerConfig(
        num_things_classes=3, num_stuff_classes=2, num_queries=8,
        backbone=BackboneConfig(depth=26),
        pixel_decoder=PixelDecoderConfig(encoder_layers=1, ffn_channels=64),
        decoder=TransformerDecoderConfig(num_layers=3, ffn_channels=64),
        object_mask_thr=0.0, iou_thr=0.1)
    state = random_state_dict(cfg, 0)
    frames = np.random.default_rng(0).integers(0, 255, (2, 72, 88, 3), dtype=np.uint8)
    gpu = SegmenterInference(cfg, state, device=dev).forward_frames(frames)
    cpu = SegmenterInference(cfg, state, device="cpu").forward_frames(frames)
    for a, b in zip(gpu, cpu):
        _close(a.cpu(), b, 1e-3)


def test_ips_pan_results_on_the_card_match_the_cpu(dev):
    """``infer_frames_ips`` of the tiny segmenter on one 2-frame batch (frames
    cropped from their padded size), float32: the card through B1 and B2
    against the CPU through the plain versions; at most 0.1% of the pixels
    may differ (logits within 1e-3 of their scale can swap an owner)."""
    from openpvsg_torch.config import (BackboneConfig, Mask2FormerConfig,
                                       PixelDecoderConfig,
                                       TransformerDecoderConfig)
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.weights import random_state_dict

    cfg = Mask2FormerConfig(
        num_things_classes=3, num_stuff_classes=2, num_queries=8,
        backbone=BackboneConfig(depth=26),
        pixel_decoder=PixelDecoderConfig(encoder_layers=1, ffn_channels=64),
        decoder=TransformerDecoderConfig(num_layers=3, ffn_channels=64),
        object_mask_thr=0.0, iou_thr=0.1)
    state = random_state_dict(cfg, 1)
    frames = np.random.default_rng(1).integers(0, 255, (2, 90, 120, 3), dtype=np.uint8)
    before = _counts()
    gpu = SegmenterInference(cfg, state, device=dev).infer_frames_ips(frames)
    assert all(a > b for a, b in zip(_counts(), before))
    cpu = SegmenterInference(cfg, state, device="cpu").infer_frames_ips(frames)
    for a, b in zip(gpu, cpu):
        assert a["pan_results"].shape == (90, 120)
        assert (a["pan_results"] != b["pan_results"]).mean() <= 1e-3


def _tiny_train_cfg():
    from openpvsg_torch.config import (BackboneConfig, Mask2FormerConfig,
                                       PixelDecoderConfig,
                                       TransformerDecoderConfig)

    return Mask2FormerConfig(
        num_things_classes=3, num_stuff_classes=2, num_queries=8,
        backbone=BackboneConfig(depth=26, norm="sync_bn"),
        pixel_decoder=PixelDecoderConfig(encoder_layers=1, ffn_channels=64),
        decoder=TransformerDecoderConfig(num_layers=3, ffn_channels=64))


def _train_batch(seed=0, B=2, T=2, H=64, W=64, N=3):
    rng = np.random.default_rng(seed)
    masks = np.zeros((B, N, T, H // 4, W // 4), np.uint8)
    for b in range(B):
        for j in range(N):  # one band of rows per target
            masks[b, j, :, 5 * j:5 * j + 4, 2 + b:10 + b] = 1
    return {"images": rng.integers(0, 255, (B, T, H, W, 3), dtype=np.uint8),
            "gt_labels": rng.integers(0, 5, (B, N)).astype(np.int32),
            "gt_masks": masks, "gt_valid": np.ones((B, N), bool)}


def _counts():
    return [fn.launches for fn in fpn.KERNEL_WRAPPERS + fusion.KERNEL_WRAPPERS]


def test_train_forward_backward_runs_the_unfused_chain(dev):
    """Mask2Former(train=True) on the card: the stride-4 chain's weights get
    gradients, and neither B1 nor B2 launches."""
    from openpvsg_torch.models.mask2former import Mask2Former
    from openpvsg_torch.weights import random_state_dict

    cfg = _tiny_train_cfg()
    model = Mask2Former(cfg, train=True)
    model.load_state_dict(random_state_dict(cfg, 0))
    model.to(dev)
    before = _counts()
    x = torch.randn((2, 2, 64, 64, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    cls, masks, _ = model(x)
    assert tuple(masks.shape) == (4, 2, 8, 2, 16, 16)
    (cls.square().mean() + masks.square().mean()).backward()
    pd = model.pixel_decoder
    for p in (pd.lateral_conv_0.conv.weight, pd.output_conv_0.conv.weight,
              pd.mask_feature.weight):
        assert p.grad is not None and float(p.grad.abs().max()) > 0
    assert _counts() == before


def test_eval_forward_still_launches_b1(dev):
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.weights import random_state_dict

    cfg = _tiny_train_cfg()
    seg = SegmenterInference(cfg, random_state_dict(cfg, 0), device=dev)
    before = [fn.launches for fn in fpn.KERNEL_WRAPPERS]
    seg.forward_frames(np.zeros((2, 64, 64, 3), np.uint8))
    after = [fn.launches for fn in fpn.KERNEL_WRAPPERS]
    assert all(a == b + 1 for a, b in zip(after, before))


def test_kernels_refuse_inputs_that_require_grad(dev):
    f0, s8, p = _fpn_case(1, 16, 24, 32, 32, 16, torch.float32, dev)
    with pytest.raises(RuntimeError, match="no backward"):
        fpn.fpn_stride4(f0.requires_grad_(), s8, p, 4)
    with pytest.raises(RuntimeError, match="no backward"):
        fpn.fpn_stride4(f0.detach(), s8, {k: v.requires_grad_() for k, v in p.items()}, 4)
    with pytest.raises(RuntimeError, match="no backward"):
        fpn.lateral_stats(f0.detach(), p["w_lat"], p["b_lat"])
    low = torch.zeros((1, 4, 8, 10), device=dev, requires_grad=True)
    scores = torch.zeros((1, 4), device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        fusion.fusion_maps(low, scores, (32, 40), (32, 40))
    with torch.no_grad():  # inference: the same inputs launch
        fpn.fpn_stride4(f0, s8, p, 4)
        fusion.fusion_maps(low, scores, (32, 40), (32, 40))


def test_trainer_step_on_the_card_matches_the_cpu(dev):
    """One SegmenterTrainer step of the small model, card against CPU from
    the same state dict and batch, at the full lr of 1e-4 (warmup_ratio 1):
    the logs, the assignment and every gradient (1e-2 of its tensor's scale
    plus 1e-6: float32 gradients of convs feeding a norm are ill-conditioned)
    agree; and the card's update equals the CPU's update from the card's
    gradients within 1% of the update taken, beyond one float32 ulp of the
    parameter (Adam's first step divides each element by its own magnitude,
    so it is compared from one set of gradients)."""
    from openpvsg_torch.config import TrainConfig
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import random_state_dict

    cfg = _tiny_train_cfg()
    state = random_state_dict(cfg, 1)
    batch = _train_batch()
    cpu, gpu = (SegmenterTrainer(cfg, TrainConfig(warmup_ratio=1.0),
                                 steps_per_epoch=10, device=d, state_dict=state)
                for d in ("cpu", dev))
    before = _counts()
    logs = [{k: float(v.detach()) for k, v in tr.loss_and_grads(batch)[1].items()}
            for tr in (cpu, gpu)]
    assert _counts() == before
    np.testing.assert_array_equal(gpu.last_assigned, cpu.last_assigned)
    for k, v in logs[0].items():
        assert abs(logs[1][k] - v) <= 1e-4 * max(1.0, abs(v)), k
    names = [n for n, _ in cpu.model.named_parameters()]
    p0 = [p.detach().clone() for p in cpu.params]
    for n, pc, pg in zip(names, cpu.params, gpu.params):
        gg = pg.grad.cpu()
        scale = float(pc.grad.abs().max())
        assert float((gg - pc.grad).abs().max()) <= 1e-2 * scale + 1e-6, n
        pc.grad.copy_(gg)
    cpu.apply_updates()
    gpu.apply_updates()
    assert cpu.schedule(0) == np.float32(1e-4)
    for n, b, pc, pg in zip(names, p0, cpu.params, gpu.params):
        step = float((pc.detach() - b).abs().max())
        gap = float((pg.detach().cpu() - pc.detach()).abs().max())
        ulp = float(torch.finfo(torch.float32).eps * b.abs().max())
        assert gap <= 1e-2 * step + ulp, (n, gap, step)


def _relation_cfg(name="transformer", pair_interaction=False):
    from openpvsg_torch.config import RelationHeadConfig

    return RelationHeadConfig(model_name=name, d_model=64, encoder_heads=2,
                              encoder_ffn=96, temporal_heads=2, temporal_ffn=96,
                              num_relations=9, pair_interaction=pair_interaction)


def _relation_video(seed, n=10, t=70, count=6):
    rng = np.random.default_rng(seed)
    rels = []
    for _ in range(count):
        s, o = (int(v) for v in rng.choice(n, 2, replace=False))
        span = np.zeros(t)
        a = int(rng.integers(0, t - 8))
        span[a:a + 8] = 1
        rels.append({"subject_index": s, "object_index": o,
                     "relation": int(rng.integers(0, 9)), "relation_span": span})
    return rng.standard_normal((n, t, 64), dtype=np.float32), rels


@pytest.mark.parametrize("method", ["lapjv", "greedy"])
def test_device_assigners_on_the_card_match_the_cpu(dev, method):
    """LAPJV and greedy over a batch of problems on the card give the CPU's
    assignments (the same float32 arithmetic per problem); LAPJV's equal
    the host LAP's."""
    from openpvsg_torch.train.assign import (BIG_COST, _host_lap, device_assign)

    g = torch.Generator().manual_seed(3)
    costs = torch.randn((3, 4, 100, 20), generator=g) * 3
    costs[:, :, :, 15:] = BIG_COST  # padded targets
    got = device_assign(costs.to(dev), method).cpu()
    want = device_assign(costs, method)
    assert torch.equal(got, want)
    if method == "lapjv":
        host = np.stack([_host_lap(c) for c in costs.reshape(12, 100, 20).numpy()])
        np.testing.assert_array_equal(got.reshape(12, 100).numpy(), host)


@pytest.mark.parametrize("name,pair_interaction", [
    ("vanilla", False), ("filter", False), ("conv", True), ("transformer", False)])
def test_relation_model_on_the_card_matches_the_cpu(dev, name, pair_interaction):
    """Every output of the relation model on padded tubes and frames, card
    against CPU from the same weights: 1e-4 of each output's scale (at
    least 1), float32 with TF32 off."""
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.weights import random_relation_state_dict

    cfg = _relation_cfg(name, pair_interaction)
    state = random_relation_state_dict(cfg, 2)
    rng = np.random.default_rng(3)
    n, t, nb, tb = 10, 70, 20, 128
    feats = np.zeros((nb, tb, 64), np.float32)
    feats[:n, :t] = rng.standard_normal((n, t, 64))
    pair = np.zeros((25, tb, 128), np.float32)
    pair[:7, :t] = rng.standard_normal((7, t, 128))
    outs = []
    for d in ("cpu", dev):
        m = RelationModel.from_config(cfg).to(d)
        m.load_state_dict(state)
        with torch.no_grad():
            out = m(torch.from_numpy(feats).to(d), torch.from_numpy(pair).to(d),
                    tube_valid=(torch.arange(nb) < n).to(d),
                    frame_valid=(torch.arange(tb) < t).to(d))
        outs.append({k: v.cpu() for k, v in out.items()})
    for k, want in outs[0].items():
        _close(outs[1][k], want, 1e-4)


def test_relation_train_step_on_the_card_matches_the_cpu(dev):
    """One RelationTrainer video, card against CPU: the loss within 1e-5
    (relative) and every gradient within 1e-3 of its tensor's scale plus
    1e-7 (the attention key biases have an exact gradient of zero)."""
    from openpvsg_torch.train.relation import RelationTrainer
    from openpvsg_torch.weights import random_relation_state_dict

    cfg = _relation_cfg()
    state = random_relation_state_dict(cfg, 4)
    feats, rels = _relation_video(5)
    out = []
    for d in ("cpu", dev):
        tr = RelationTrainer(cfg, np.arange(1, 10), device=d, state_dict=state)
        out.append(tr.step(feats, rels)[0])
        out.append({n: g.cpu() for (n, _), g in
                    zip(tr.model.named_parameters(), tr._accum)})
    assert abs(out[2] - out[0]) <= 1e-5 * abs(out[0])
    for n, g in out[1].items():
        assert float((out[3][n] - g).abs().max()) <= 1e-3 * float(g.abs().max()) + 1e-7, n


def test_relation_eval_gathers_on_the_card_as_on_the_host(dev):
    """evaluate_video on the card: the device gather and the host gather
    feed predict the same tensor, so their ranked results are equal."""
    from openpvsg_torch.eval.rel_eval import evaluate_video
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.weights import random_relation_state_dict

    cfg = _relation_cfg()
    model = RelationModel.from_config(cfg).to(dev)
    model.load_state_dict(random_relation_state_dict(cfg, 6))
    feats, _ = _relation_video(7, n=9, t=150)
    before = _counts()
    for pairwise in (True, False):
        a = evaluate_video(model, feats, 30, pairwise, device_gather=True)
        b = evaluate_video(model, feats, 30, pairwise, device_gather=False)
        assert a[0] == b[0] and len(a[1]) == len(b[1]) > 0
        for x, y in zip(a[1], b[1]):
            assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
    assert _counts() == before


def test_train_cli_runs_on_the_card_with_deterministic(dev, tmp_path):
    """The train CLI on the card with ``--deterministic``: operations without
    a deterministic CUDA implementation warn instead of raising, and two
    steps train (the global setting is restored after)."""
    from openpvsg_torch.tools import make_synthetic_data, train

    root = str(tmp_path / "data")
    anno = make_synthetic_data.main(["--out", root, "--frames", "3", "--size", "64", "64"])
    args = ["--config", "mask2former_vps", "--data-dir", root, "--anno-file", anno,
            "--work-dir", str(tmp_path / "work"), "--epochs", "1", "--deterministic",
            "--set", "model.backbone.depth=26", "model.num_queries=8",
            "model.num_things_classes=5", "model.num_stuff_classes=3",
            "model.decoder.num_layers=3", "model.decoder.ffn_channels=64",
            "model.pixel_decoder.encoder_layers=1", "model.pixel_decoder.ffn_channels=64",
            "data.train_scale=64,64", "data.crop_size=64,64", "train.samples_per_gpu=8"]
    try:
        out = train.main(args)
    finally:
        torch.use_deterministic_algorithms(False)
    assert out["steps"] == 2 and out["device"].startswith("cuda")
    assert all(np.isfinite(out["losses"])) and not any(out["launches"].values())


def _tracker_case(seed=0, n=4, h=96, w=128):
    """Frames and masks of a few moving boxes for the tracker on the card."""
    rng = np.random.default_rng(seed)
    frames, masks = [], []
    for t in range(3):
        frame = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        m = np.zeros((n, h, w), np.uint8)
        for i in range(n):
            y, x = 6 + 20 * i, 4 + 8 * t + 10 * i
            m[i, y:y + 18, x:x + 30] = 1
            frame[m[i] == 1] = rng.integers(60, 255, 3, dtype=np.uint8)
        frames.append(frame)
        masks.append(m)
    return frames, masks


def test_tracker_defaults_to_the_card(dev):
    """A default MaskAssociationTracker puts its encoder and the detections'
    pixel-feature sets on the card, and tracks."""
    from openpvsg_torch.config import TrackerConfig
    from openpvsg_torch.tracker.tracker import MaskAssociationTracker
    from openpvsg_torch.weights import random_appearance_state_dict

    cfg = TrackerConfig(appearance_depth=26)
    tr = MaskAssociationTracker(cfg, random_appearance_state_dict(cfg, 0))
    assert tr.device.type == "cuda"
    assert {p.device.type for p in tr.appearance_model.parameters()} == {"cuda"}
    frames, masks = _tracker_case()
    qf = [{"query_feat": np.zeros(4, np.float32), "cls_id": 1}] * 4
    for frame, m in zip(frames, masks):
        out, n = tr.update(frame, m, qf)
    assert sorted(t.track_id for t in out) == [1, 2, 3, 4] and n == 4
    assert all(t.curr_feat.device.type == "cuda" for t in out)


def test_tracker_device_work_on_the_card_matches_the_cpu_with_tf32_on(dev):
    """The appearance features and the reconsdot cost on the card against
    the CPU, with the caller's TF32 switched on: both run in IEEE float32
    (1e-4 absolute), and the caller's settings come back."""
    from openpvsg_torch.config import TrackerConfig
    from openpvsg_torch.tracker.appearance import (extract_object_embeddings,
                                                   make_appearance_model)
    from openpvsg_torch.tracker.matching import reconsdot_distance
    from openpvsg_torch.weights import random_appearance_state_dict

    cfg = TrackerConfig(appearance_depth=26)
    model = make_appearance_model(depth=26)
    model.load_state_dict(random_appearance_state_dict(cfg, 1))
    model.eval()
    frames, masks = _tracker_case(seed=1)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        feats = {}
        for name in ("cpu", "cuda"):
            model.to(name)
            a, va = extract_object_embeddings(model, frames[0], masks[0])
            b, vb = extract_object_embeddings(model, frames[1], masks[1])
            cost = reconsdot_distance([f.T for f in a], [f.T for f in b])
            feats[name] = (a.cpu(), va.cpu(), cost)
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    assert torch.equal(feats["cpu"][1], feats["cuda"][1])
    assert float((feats["cpu"][0] - feats["cuda"][0]).abs().max()) <= 1e-4
    assert np.abs(feats["cpu"][2] - feats["cuda"][2]).max() <= 1e-4


def test_kernels_launch_on_their_tensors_device(dev):
    """B1's three launches and B2 on ``cuda:1`` from a thread whose current
    device is ``cuda:0``: each wrapper launches under its input's device,
    so the library's per-device caches and the launch itself are that
    card's. Skips with fewer than two GPUs."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    one = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    for dt in (torch.float32, torch.bfloat16):
        f0, s8, p = _fpn_case(2, 24, 40, 64, 64, 64, dt, one)
        got = fpn.fpn_stride4(f0, s8, p, num_groups=8)
        assert got.device == one and torch.cuda.current_device() == 0
        _close(got, fpn.fpn_stride4_plain(f0, s8, p, num_groups=8),
               2e-4 if dt == torch.float32 else 5e-2)
    g = torch.Generator().manual_seed(1)
    low, scores = _fusion_case("random", 2, 10, 24, 30, g)
    low, scores = low.to(one), scores.to(one)
    got = fusion.fusion_maps(low, scores, (96, 120), (90, 110))
    assert got[0].device == one and torch.cuda.current_device() == 0
    for a, b in zip(got, fusion.fusion_maps_plain(low, scores, (90, 110))):
        assert torch.equal(a, b.to(a.dtype))
