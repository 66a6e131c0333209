"""The port's kernel modules on the CPU: their plain versions (what a
wrapper runs for CPU tensors) against the JAX package's oracles and Pallas
kernels, and the decomposition the CUDA kernels implement.

Tolerances: the FPN chain, as tests/test_fpn_kernel.py holds the Pallas
kernel (atol 2e-5, rtol 1e-4: float32 sums over 9 * C products in another
order). Fusion outputs are integers and must be bit-identical: both sides
evaluate the same float32 formulas on identical logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpvsg_tpu.ops.pallas.fpn_kernel import fused_fpn_stride4, xla_fpn_stride4
from openpvsg_torch.kernels import fpn, fusion

FPN_TOL = dict(atol=2e-5, rtol=1e-4)

# the shapes of tests/test_fpn_kernel.py:31 and :44
FPN_SHAPES = [(2, 32, 40, 96, 64, 48, 8), (1, 16, 24, 32, 32, 16, 4)]


def _fpn_inputs(rng, B, H, W, Cin, C, Cout):
    p = {
        "w_lat": rng.standard_normal((1, 1, Cin, C)) * 0.1,
        "b_lat": rng.standard_normal(C) * 0.1,
        "gn1_scale": rng.standard_normal(C) * 0.5 + 1.0,
        "gn1_bias": rng.standard_normal(C) * 0.1,
        "w_out": rng.standard_normal((3, 3, C, C)) * 0.05,
        "b_out": rng.standard_normal(C) * 0.1,
        "gn2_scale": rng.standard_normal(C) * 0.5 + 1.0,
        "gn2_bias": rng.standard_normal(C) * 0.1,
        "w_mask": rng.standard_normal((1, 1, C, Cout)) * 0.1,
        "b_mask": rng.standard_normal(Cout) * 0.1,
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    f0 = rng.standard_normal((B, H, W, Cin)).astype(np.float32)
    s8 = rng.standard_normal((B, H // 2, W // 2, C)).astype(np.float32)
    return f0, s8, p


def _torch(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.mark.parametrize("shape", FPN_SHAPES)
def test_fpn_plain_matches_xla_and_pallas(rng, shape):
    """fpn_stride4 on CPU tensors (the unfused module chain) against the
    JAX unfused chain and the Pallas kernel in interpret mode."""
    B, H, W, Cin, C, Cout, G = shape
    f0, s8, p = _fpn_inputs(rng, B, H, W, Cin, C, Cout)
    got = fpn.fpn_stride4(torch.from_numpy(f0), torch.from_numpy(s8),
                          _torch(p), num_groups=G).numpy()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ref = np.asarray(xla_fpn_stride4(jnp.asarray(f0), jnp.asarray(s8), jp,
                                     num_groups=G))
    pallas = np.asarray(fused_fpn_stride4(jnp.asarray(f0), jnp.asarray(s8), jp,
                                          num_groups=G, tile_h=8, interpret=True))
    assert got.shape == (B, H, W, Cout)
    np.testing.assert_allclose(got, ref, **FPN_TOL)
    np.testing.assert_allclose(got, pallas, **FPN_TOL)


@pytest.mark.parametrize("shape", FPN_SHAPES)
def test_fpn_three_launch_decomposition(rng, shape):
    """The three launches the CUDA kernel makes (lateral + sums, GN1 fold,
    conv3x3 on GN1(l_raw) + up2x(s8) + sums, GN2 fold, relu + mask 1x1),
    run through their plain versions, equal the unfused chain."""
    B, H, W, Cin, C, Cout, G = shape
    f0, s8, p = _fpn_inputs(rng, B, H, W, Cin, C, Cout)
    t = _torch(p)
    count = H * W * (C // G)
    l_raw, s1, q1 = fpn.lateral_stats(torch.from_numpy(f0),
                                      t["w_lat"].reshape(Cin, C), t["b_lat"])
    sc1, bi1 = fpn.group_affine(s1, q1, t["gn1_scale"], t["gn1_bias"], count,
                                G, 1e-6)
    x2, s2, q2 = fpn.conv3x3_stats(l_raw, torch.from_numpy(s8), sc1, bi1,
                                   t["w_out"], t["b_out"])
    sc2, bi2 = fpn.group_affine(s2, q2, t["gn2_scale"], t["gn2_bias"], count,
                                G, 1e-6)
    got = fpn.mask_proj(x2, sc2, bi2, t["w_mask"].reshape(C, Cout), t["b_mask"])
    chain = fpn.fpn_stride4_plain(torch.from_numpy(f0), torch.from_numpy(s8), t,
                                  num_groups=G)
    np.testing.assert_allclose(got.numpy(), chain.numpy(), **FPN_TOL)
    # the CPU path never counts a launch
    assert fpn.lateral_stats.launches == fpn.conv3x3_stats.launches == 0
    assert fpn.mask_proj.launches == 0


def _fusion_inputs(rng, N=2, Q=8, h=16, w=20, drop=0.3):
    low = (rng.standard_normal((N, Q, h, w)) * 3.0).astype(np.float32)
    scores = rng.uniform(0.05, 1.0, (N, Q)).astype(np.float32)
    scores[rng.random((N, Q)) < drop] = -np.inf
    return low, scores


def test_fusion_maps_plain_matches_fusion_reference(rng):
    """fusion_maps on CPU tensors against _fusion_reference (the off-TPU
    path of fused_fusion_maps) on identical logits: owner, binary and both
    areas bit-identical."""
    from openpvsg_tpu.ops.pallas.fusion_kernel import _fusion_reference

    low, scores = _fusion_inputs(rng)
    ori = (60, 72)
    owner, binary, marea, oarea = fusion.fusion_maps(
        torch.from_numpy(low), torch.from_numpy(scores), (64, 80), ori)
    for n in range(low.shape[0]):
        r_owner, r_binary, r_marea, r_oarea = _fusion_reference(
            jnp.asarray(low[n]), jnp.asarray(scores[n]), jnp.asarray(ori))
        np.testing.assert_array_equal(owner[n].numpy(), np.asarray(r_owner))
        np.testing.assert_array_equal(binary[n].numpy(), np.asarray(r_binary))
        np.testing.assert_array_equal(marea[n].numpy(), np.asarray(r_marea))
        np.testing.assert_array_equal(oarea[n].numpy(), np.asarray(r_oarea))
    assert owner.dtype == marea.dtype == oarea.dtype == torch.int32
    assert fusion.fusion_maps.launches == 0


def test_fusion_maps_rejects_unpadded_shape(rng):
    low, scores = _fusion_inputs(rng)
    with pytest.raises(ValueError, match="4x"):
        fusion.fusion_maps(torch.from_numpy(low), torch.from_numpy(scores),
                           (60, 80), (60, 72))


def test_exact_sigmoid_count_needs_the_card(rng):
    """The count measures the CUDA kernel's work: CPU tensors have no such
    work to count, and the call launches nothing."""
    low, scores = _fusion_inputs(rng)
    with pytest.raises(ValueError, match="CUDA"):
        fusion.exact_sigmoid_count(torch.from_numpy(low), torch.from_numpy(scores),
                                   (64, 80), (64, 80))
    assert fusion.fusion_maps.launches == 0


@pytest.mark.parametrize("ori", [(64, 80), (57, 70)])
def test_panoptic_fusion_matches_jax(rng, ori):
    """The port's panoptic_fusion (kernel B2 plain version + torch) against
    openpvsg_tpu's panoptic_fusion on the same logits, upsampled to the
    padded frame and cropped to ori as the JAX segmenter does: pan_seg,
    query_keep and segment_id bit-identical."""
    from openpvsg_tpu.models.fusion import panoptic_fusion as jax_fusion
    from openpvsg_tpu.ops.resize import resize_bilinear as jax_resize
    from openpvsg_torch.models.fusion import panoptic_fusion

    N, Q, h, w, things, stuff = 2, 8, 16, 20, 3, 2
    low, _ = _fusion_inputs(rng, N, Q, h, w)
    cls = (rng.standard_normal((N, Q, things + stuff + 1)) * 2).astype(np.float32)
    got = panoptic_fusion(torch.from_numpy(cls), torch.from_numpy(low),
                          things, stuff, 0.3, 0.5, (4 * h, 4 * w), ori)
    up = jax_resize(jnp.asarray(low).reshape(N * Q, h, w, 1), (4 * h, 4 * w))
    up = up.reshape(N, Q, 4 * h, 4 * w)[:, :, :ori[0], :ori[1]]
    want = jax.vmap(lambda c, m: jax_fusion(c, m, things, stuff, 0.3, 0.5))(
        jnp.asarray(cls), up)
    assert int(np.asarray(want["query_keep"]).sum()) > 0
    for key in ("pan_seg", "query_keep", "segment_id", "labels"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-6)


def test_panoptic_fusion_binary_rule_matches_jax_in_the_flip_band(rng):
    """Logits whose upsampled values lie in [-1.79e-7, 0) or at +-0, where
    float32 sigmoid(u) >= 0.5 holds though u < 0 (it flips near
    u = -1.783e-7): the port's panoptic_fusion and openpvsg_tpu's
    (models/fusion.py:66, sigmoid >= 0.5) agree bit for bit. The Pallas
    kernel's oracle _fusion_reference (fusion_kernel.py:221) thresholds
    up >= 0.0 instead and differs here; the port follows fusion.py."""
    from openpvsg_tpu.models.fusion import panoptic_fusion as jax_fusion
    from openpvsg_tpu.ops.pallas.fusion_kernel import _fusion_reference
    from openpvsg_tpu.ops.resize import resize_bilinear as jax_resize
    from openpvsg_torch.models.fusion import panoptic_fusion

    N, Q, h, w, things, stuff = 1, 8, 8, 10, 3, 2
    # every blend of these (3/8, 5/8, 1/8, 7/8 weights) stays in
    # [-1.4 * 2^-23, 0], inside the band where sigmoid >= 0.5
    vals = np.array([-0.0, 0.0, -2.0 ** -24, -2.0 ** -23, -1.25 * 2.0 ** -23,
                     -1.4 * 2.0 ** -23], np.float32)
    assert (torch.sigmoid(torch.from_numpy(vals)) >= 0.5).all()
    low = vals[rng.integers(0, len(vals), (N, Q, 2, 2))]
    low = np.repeat(np.repeat(low, h // 2, axis=2), w // 2, axis=3)
    cls = (rng.standard_normal((N, Q, things + stuff + 1)) * 2).astype(np.float32)
    cls[..., -1] = -10.0  # no query picks the void class
    ori = (30, 36)
    got = panoptic_fusion(torch.from_numpy(cls), torch.from_numpy(low),
                          things, stuff, 0.0, 0.1, (4 * h, 4 * w), ori)
    up = jax_resize(jnp.asarray(low).reshape(N * Q, h, w, 1), (4 * h, 4 * w))
    up = up.reshape(N, Q, 4 * h, 4 * w)
    assert float(up.max()) <= 0.0 and float(up.min()) >= -1.79e-7
    want = jax.vmap(lambda c, m: jax_fusion(c, m, things, stuff, 0.0, 0.1))(
        jnp.asarray(cls), up[:, :, :ori[0], :ori[1]])
    assert int(np.asarray(want["query_keep"]).sum()) > 0
    for key in ("pan_seg", "query_keep", "segment_id"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    # every pixel's owner is binary under fusion.py's rule, so nothing is void
    assert int((got["pan_seg"] == things + stuff).sum()) == 0
    # the Pallas oracle's up >= 0.0 drops the pixels with u < 0
    scores = torch.softmax(torch.from_numpy(cls), -1).amax(-1)
    ref_orig = np.asarray(_fusion_reference(jnp.asarray(low[0]),
                                            jnp.asarray(scores[0].numpy()),
                                            jnp.asarray(ori))[3])
    port_orig = fusion.fusion_maps(torch.from_numpy(low), scores,
                                   (4 * h, 4 * w), ori)[3][0].numpy()
    assert (ref_orig < port_orig).any()


def test_minvis_stitch_matches_jax(rng):
    """Identical embeddings give identical perms, ties included (duplicated
    queries), because both packages call the same C++ LAP."""
    from openpvsg_tpu.infer.segmenter import minvis_stitch as jax_stitch
    from openpvsg_torch.infer.segmenter import minvis_stitch

    emb = rng.standard_normal((4, 10, 16)).astype(np.float32)
    emb[:, 7] = emb[:, 3]  # exact ties in the cost matrix
    np.testing.assert_array_equal(minvis_stitch(emb), jax_stitch(emb))
    prev = rng.standard_normal((10, 16)).astype(np.float32)
    np.testing.assert_array_equal(minvis_stitch(emb, prev=prev),
                                  jax_stitch(emb, prev=prev))
