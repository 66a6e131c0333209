#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``openpvsg_torch``) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:

1. card    — ``nvidia-smi`` name and power limit (also printed raw); no GPU
             means exit 2 with no result.
2. build   — nvcc builds of every kernel source (sm_90a), all at once;
             ptxas registers and spills of each kernel entry.
3. kernels vs plain at main-path width — the three FPN launches and the FPN
             chain (B=2, 96x120, C=256, G=32) in float32 (TF32 off) and
             bfloat16, and the fusion pass (N=2, Q=100, 96x120 -> 384x480,
             ori 360x480) on two inputs: the smoke input (~30% of queries
             dropped) and a no-skip input (every query kept at one score);
             max-abs errors, mismatch counts, device times per call
             (``time_ms``: calls queued back to back) and per-call times with
             the host's launch time (``call_ms``), achieved TFLOP/s and the
             share of the bound; for the fusion pass the shares of pairs
             whose exact sigmoid the function needs (two exact rules, plain
             side) and that the kernel evaluated (its counting build), the
             bound restated per input (bytes, FP32 or SFU operations) and
             the time of one CTA alone. Any tolerance exceeded fails (the
             fusion pass has none: one differing owner, bit or area fails),
             and so does a chain whose two calls differ in any bit.
4. reference — the full-width model on a small input, GPU (kernels) against
             CPU (plain versions) in float32.
5. stage 2 — ``run_query_tube_vps`` (window 2) with the ``mask2former_vps``
             model at full width (R-50, folded BN, bf16, random weights from
             the seed) on synthetic 360x480 frames; launch counts are zeroed
             just before this run and read just after, and every kernel must
             have launched. The same frames run a second time (timed as
             well), and whether the two ``masks.txt`` files are
             byte-identical is reported. Then the same frames at 2 and 4
             windows per forward (``windows_per_batch``, batches of 4 and 8
             frames; each warmed once, its counts zeroed just before and
             read just after): frames/s, launches, whether its
             ``masks.txt`` equals the serial run's bytes, and the share of
             pixels whose class differs from the serial run's; every kernel
             must launch and that share stay under 10% (cuDNN and cuBLAS
             pick other kernels at another batch size, so the bytes need not
             be equal on the card, and the random weights' near-ties turn
             last-bit differences into other owners), and the same frames
             in float32 (TF32 off) at 1 and 4 windows must give the same
             ``masks.txt`` bytes. Then, TF32 off, B1 (float32 and bf16) at
             ``f0 (8, 96, 120, 256)`` and B2 at ``(8, 100, 96, 120)`` cropped
             to 360x480, the 4-window batch's shapes, against their plain
             versions at phase 3's tolerances.
6. train_reference — one ``SegmenterTrainer`` step of the tests' small
             model (R-26, 8 queries, 3 decoder layers, 2 clips of 2 64x64
             frames) on the card and on the CPU from the same state dict and
             batch, at the full lr of 1e-4 (``warmup_ratio`` 1): the losses,
             the assignments, the largest gradient difference (relative to
             each tensor's scale, between the two and from each to the
             step's float64 gradients on the CPU), and the card's update
             against the CPU's update from the card's gradients. A loss more
             than 1e-3 apart (relative), a differing assignment, a gradient
             more than 1e-2 of its scale apart or an update more than 1e-2 of
             itself apart (beyond one float32 ulp of the parameter; the
             attention key biases, whose exact gradient is zero, aside)
             fails. Then its bfloat16 case (``model.backbone.dtype``): the
             same model's bf16 step on the card against the CPU's bf16 step
             from the same state, under the CPU's bf16 assignment, the CPU's
             float32 step the reference, at
             tests/test_torch_train_bf16.py's tolerances (the loss within
             1e-2 relative; the cls and mask logits within twice the CPU's
             bf16 distance to float32 plus 1e-2 of their scale; every
             gradient within six times it, nine in ten within twice it);
             the trainers' own assignments are reported, and the card's
             update must leave finite float32 parameters.
7. train   — stage-1 training of ``mask2former_vps`` at full width (R-50
             'sync_bn' in training mode, 256-channel pixel decoder, 6 axial
             layers, 9 decoder layers with all-layer masks, 100 queries, 126
             classes), random weights from the seed, float32: the preset's
             ``samples_per_gpu`` synthetic clips of 2 frames at 360x480
             padded to 384x480 with 1-20 blob tubes each; 6 steps (loss per
             step, median step ms and host LAP ms over steps 2-6, frames/s,
             peak GiB, a checksum of the parameters), then a checkpoint round
             trip whose seventh step must equal the uninterrupted one. Both
             train phases run with torch's default TF32 settings, as a user's
             caller would; the trainer turns TF32 off inside its step. It
             fails on a non-finite loss, TF32 on inside a step, a parameter
             with a gradient that did not move, a BN whose running statistics
             did not change, a B1 or B2 launch during training (counted over
             both train phases), or a resumed seventh step whose logs differ
             by more than 1e-5 (relative) or whose update differs by more
             than 1e-2 of itself (as in phase 6). Then the same run in
             bfloat16 compute (float32 parameters; no checkpoint round
             trip), and 3 full-width bf16 steps each of the reference's MSDA
             model (points objective, split) and of Swin-T (median step ms,
             frames/s, peak GiB); a non-finite loss fails.
8. rel_reference — the relation model at a small width (d 64, 2 heads, a
             transformer head, 12 tubes and 100 frames padded to the training
             buckets 20 and 128, 57 relations) on the card and on the CPU
             from the same weights: the forward's largest gaps on
             ``pred_matrix``, ``span_pred`` and ``prob`` (bound 1e-4 of each
             output's scale, at least 1), one train step's loss (1e-5
             relative) and gradients (1e-3 of each tensor's scale, the key
             biases aside), and the evaluation's ranked pairs, triplets and
             span bits: exactly equal or not, and equal wherever adjacent
             scores (and |span logits|) are more than 1e-4 apart, which must
             hold. Runs from torch's default TF32 settings.
9. relations — stages 3-5 at full width, from the seed, with the launch
             counts of both kernels zeroed first: ``run_rel_set`` on 2
             synthetic 380-frame 360x640 videos with 20 GT objects and 1-30
             GT relations each, their GT masks written as mask PNGs and as
             the predicted ``masks.txt`` with random query features (seconds
             per video, mask PNGs read included; relations written); ``relation_head('transformer')`` training
             (d 256, float32, TF32 off in the step) over 64 synthetic
             relation sets (20-100 tubes, 150-1200 frames, 1-30 relations):
             2 Adam applies at ``accumulation_steps`` 32 (median step ms,
             flush ms, videos/s, peak GiB, losses), then a checkpoint round
             trip whose next step's loss must agree within 1e-5, and one
             accumulation cycle of ``relation_conv_large``; ``evaluate``
             (proxy R@K, 100 pairs) over 16 sets and ``evaluate_full`` over
             the stage-3 videos, written with ``save_metrics_to_csv`` (ms per
             video, the metric dicts, the CSV). It fails on a non-finite
             loss, a parameter without a gradient or that did not move, TF32
             on inside a step, a resumed step that differs, stage 3 writing
             no relation, or any launch of B1 or B2.
10. stage1_cli — stage 1 from PVSG files to PQ/VPQ through the port's
             CLIs, each in its own process, at full ``mask2former_vps`` width:
             a PVSG root with PVSG's cardinalities (2 train videos of 17
             360x640 frames, 32 two-frame clips, and 1 val video of 24
             frames, 1-20 moving objects each, frame and mask PNGs);
             ``pack_train_cache``; ``train`` (float32, global batch 4 clips,
             8 steps per epoch) for 1 epoch from the PNGs, then ``--epochs 2
             --auto-resume``, then 1 epoch ``--packed-cache``; ``test --eval
             PQ,VPQ`` of epoch_2 in bfloat16 (IPS batches of 8, VPQ windows
             of 2). Steps/s, clips/s and the loader-wait share per epoch, IPS
             and VPQ frames/s, peak GiB, PQ and VPQ; the IPS path in float32
             on the card against the CPU on 2 val frames (epoch_2 and random
             weights); then B1 (8 frames, 96x160) and B2 ((8, 100, 96, 160)
             cropped to 360x640) against their plain versions at the IPS
             batch's shapes. It fails when a CLI exits non-zero, a loss is
             not finite, the resumed run does not start at epoch 1, the IPS
             pan_results differ on more than 0.1% of the pixels, the test CLI
             did not launch B1 or B2, a train run launched either, or a
             kernel disagrees with its plain version.
11. stage2_ips — IPS stage 2 at full ``mask2former_ips`` width, from
             torch's default TF32 settings (the tracker turns TF32 off for
             its device work): (a) ``run_query_tube_ips`` on one synthetic
             64-frame 360x640 video of moving rectangles (R-50, folded BN,
             bf16 segmenter, random weights from the seed with
             ``object_mask_thr=0.0``, ``iou_thr=0.1``; the ``imagenet50 s3``
             appearance encoder in float32; batches of 8, two in flight),
             with the launch counts zeroed just before and read just after:
             frames/s, segments per frame, tubes, peak GiB, launches; (b) the
             tracker alone on the GT of the relations phase's first video
             (20 moving objects, 360x640, 120 of its frames painted as
             frames, from frame 130, where most objects are present at
             once): ms per frame split into appearance extraction,
             reconsdot (host clock and CUDA events) and host, peak GiB, and
             MOTA / IDF1 / HOTA against the GT (reported, not gated); (c)
             the tracker on the card and on the CPU over the first 16 of
             those frames: every reconsdot matrix within 1e-4 absolute and
             the same track ids per frame; then B1 (8 frames, 96x160) and B2
             ((8, 100, 96, 160) cropped to 360x640) against their plain
             versions, TF32 off. It fails when the IPS path writes no
             segment or does not launch B1 and B2, when the card and the
             CPU disagree, or when a kernel disagrees with its plain
             version.
12. reference_model — the reference's Mask2Former (``mask2former_vps``
             with the 6-layer MSDA pixel encoder: 8 heads, 3 levels, 4
             points, FFN 1024; R-50, 9 decoder layers, 100 queries, 127
             class logits), from torch's default TF32 settings: (a) a
             synthetic state dict in mmdet 2.25's key layout from the seed,
             written as a .pth, read by ``load_mmdet_checkpoint`` and
             converted by ``convert_mmdet_mask2former`` (seconds of each;
             the segmenter loads it strictly); (b) ``run_query_tube_vps``
             on 16 360x480 frames, bf16, window 2, with those weights and
             the launch counts zeroed just before and read just after:
             frames/s, peak GiB, launches (B1 and B2 must launch), the MSDA
             and the axial encoder alone at a window's shapes (device ms
             from ``torch.profiler``, and CUDA events around one call),
             B1 on the MSDA stride-8 output against ``fpn_stride4_plain``
             (5e-2 of the scale, bf16) and B2 on the model's logits against
             ``fusion_maps_plain`` (no mismatch); (c) the MSDA pixel decoder
             in float32 on a 64x96 input, card against CPU (TF32 off): the
             three levels within 1e-4 of their scale, ``mask_feature`` (B1's
             float32 chain) within 2e-4; (d) ``SegmenterTrainer`` with
             ``loss_sampling='points'`` (12544 points, oversampling 3,
             importance 0.75) and ``split_thing_stuff``, float32, the
             preset's 16 clips of 2 384x480 frames, 4 steps and a fifth
             under ``torch.profiler``: median step ms of steps 2-4, host LAP
             share, device busy ms and idle share, peak GiB, beside phase
             ``train``'s dense axial numbers. It fails on a non-finite loss,
             a kernel launched by training, or any failed check above.
13. swin — the Swin-T segmenter (``mask2former_swin_vps``: Swin-T, 96
             channels at stride 4, the axial pixel decoder on (96, 192, 384,
             768), 9 decoder layers, 100 queries) and the trainer's options:
             (a) B1's three launches and chain at Swin-T's stride-4 width,
             ``f0 (2, 96, 120, 96)`` -> C 256, in float32 (TF32 off) and
             bfloat16 against their plain versions at phase 3's tolerances
             (each launch's ms, bound and ``addmm``'s ms); (b) the model in
             float32 on a 2x64x64 input, card against CPU (as phase 4); (c)
             ``run_query_tube_vps`` with it in bf16 (random weights from the
             seed, ``object_mask_thr=0.0``, ``iou_thr=0.1``) on 16 360x480
             frames, window 2, launch counts zeroed just before and read just
             after (B1 and B2 must launch): frames/s, peak GiB, and whether a
             rerun's ``masks.txt`` is byte-identical; (d) training, float32,
             from torch's default TF32 settings: 4 full-width steps of 16
             clips of 2 384x480 frames with the host Hungarian (median step
             ms of steps 2-4, host LAP share, frames/s, peak GiB); one
             step's costs solved by the host Hungarian and by LAPJV and
             greedy on the card (each one's ms; LAPJV's assignment must
             equal the host's); 4 steps of a trainer with LAPJV (median step
             ms); and one step of the small model (phase 6's) per trainer
             option (LAPJV, greedy, ``match_downsample`` 2, the target
             layout, focal, the semantic head with ``gt_semantic``, bf16
             mask logits) on the card and on the CPU: the same assignment,
             the loss within 1e-3 (1e-2 with bf16 logits) relative and every
             gradient within 1e-2 (5e-2) of its scale. Fails on any check
             above, a non-finite loss, or a B1 or B2 launch in training.
14. end2end — stages 3-5 and end-to-end serving at full width, from the
             seed: (a) a rich synthetic PVSG root (``make_synthetic_data
             --style rich --oracle-stage2``: 4 train and 2 val videos of 120
             360x640 frames, 2-5 moving things over a floor, GT-derived
             tubes and random-projection query features), then, each in its
             own process whose ``summary:`` line the script reads,
             ``prepare_rel_set --jobs 4`` on both splits (videos/s),
             ``rel_train --epochs 1`` (``relation_head('transformer')``, d
             256, 57 relations; step ms, losses), and ``rel_test`` and
             ``rel_test_full`` on its epoch_1 and on a reference ``.pth``
             bundle written from the seed at the preset's widths (R@K,
             reported); (b) ``end2end_inference --eval`` on the 2 val
             videos, VPS (``mask2former_vps``, window 2) then IPS
             (``mask2former_ips``, batches of 8, the ``imagenet50 s3``
             encoder in float32), bf16 segmenters with random weights from
             the seed (``object_mask_thr=0.0``, ``iou_thr=0.1``) and
             rel_train's relation head: frames/s, segment and relation
             seconds, tubes and triplets per video, peak GiB, protocol
             metrics (reported); (c) ``StreamingPVSG`` in this process on
             128 360x480 frames pushed one at a time (window 2,
             relation_interval 16, num_top_pairs 20, max_history 64), launch
             counts zeroed just before and read just after: per-window ms
             (median, p95), scoring ms, peak GiB, the ring's device; then the
             host backend on the same stream; then, TF32 off, B1 at end2end
             VPS's ``f0 (2, 96, 160, 256)`` and B2 at its ``(2, 100, 96,
             160)`` logits cropped to 360x640 against their plain versions
             (phase 3's tolerances; its IPS batches have phase 10's
             shapes). It fails when a CLI exits non-zero, a video writes no
             ``relations.pickle``, a loss is not finite, a relation CLI
             launches B1 or B2, end2end (VPS or IPS) or streaming does not
             launch both, a ``triplets.json`` or (with a
             ``relations.pickle``) ``protocol_metrics.json`` is missing, the
             ring is not on the card, the two streaming backends' triplets
             differ where adjacent scores are more than 1e-4 apart, or a
             kernel disagrees with its plain version.
15. multi_device — the multi-device half (``openpvsg_torch.parallel``) on the
             one card, TF32 off: (a) ``run_query_tube_vps`` on phase 5's 16
             360x480 frames with a (data=2) mesh of two replicas on
             ``cuda:0`` at 2 windows per forward (each replica's batch is
             then the serial run's), bf16 then float32: its ``masks.txt``
             must equal the serial run's bytes, and each replica must launch
             B1 and B2 (its per-replica forward and fusion are wrapped to
             count them); frames/s beside the serial run's; (b)
             ``TimeShardedRelation`` of the d-256, 57-relation transformer
             head on a (1, 2) mesh, T = 900, 50 pairs of 20 tubes, against
             the one-device head: probabilities, pair matrix and span logits
             within 1e-4 of their scale, binarized spans equal save where
             the one-device logit lies within that of 0; ms of each; (c) two
             ranks spawned over gloo on the card (NCCL refuses two ranks on
             one GPU): phase 6's small step against one process on the
             global batch at phase 6's tolerances, then
             ``prepare_query_tube_vps`` on 3 synthetic 6-frame videos through
             ``--dist-coordinator`` (the stage-2 CLIs join over gloo) against
             one process: each ``masks.txt`` the same bytes; (d) one full-width
             ``mask2former_vps`` step (4 clips) under an NCCL process group
             of world size 1 against the plain step from the same state:
             logs within 1e-6 of their scale; a second step of each timed
             (ms, peak GiB). Any failure fails the phase.
16. the ``{"kernels": [...]}`` line (since phase 5's batching with each
   kernel's ``stage2_wpb2_launches``, ``stage2_wpb4_launches`` and its
   error, ms, plain ms, bound and library ms at the 4-window batch's
   shapes; since phase 13 with each kernel's
   ``swin_launches`` and B1's Swin-shape error, ms, bound and library ms;
   since phase 14 with ``end2end_launches`` (VPS plus IPS, and each),
   ``streaming_launches`` and each kernel's error, ms, plain ms, bound and
   library ms at end2end VPS's shape; since phase 15 with
   ``multi_device_launches`` (the bf16 mesh run) and
   ``multi_device_launches_per_replica``), then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

Any failure raises, so the script exits non-zero without the last line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense, 700 W
PEAK_BYTES = 3.35e12
# how each kernel computes, per activation dtype
DESIGN = {"fpn_lateral": "wgmma bf16 (A from registers), TMA in and out, persistent CTA, "
                         "resident weight",
          "fpn_conv3x3": "wgmma bf16 (A from the halo tile in shared memory), implicit GEMM, "
                         "TMA weight ring",
          "fpn_mask": "wgmma bf16 (A from registers), TMA in and out, persistent CTA, "
                      "resident weight"}
SIMT = "simt f32"


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(torch, fn, reps=20, warmup=3):
    """Device time per call (ms): ``reps`` calls are queued behind a sleeping
    kernel, so they run back to back and the host's time to launch them is
    hidden; CUDA events around the whole queue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # at most 2 GHz: sleeps at least twice as long as the launches take
    torch.cuda._sleep(int(host_s * 4e9) + 1_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(torch, fn, reps=20, warmup=3):
    """Median of per-call CUDA-event times (ms), each call launched on an
    idle device: includes the host's launch time where it exceeds the
    device's (the method of the first chip runs)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_fpn(torch, gen, dev, B=2, H=96, W=120, at="stage2", Cin=256):
    """B1's launches and chain against their plain versions at (B, H, W)
    stride-4 pixels of ``Cin`` backbone channels (256 for R-50 and the MSDA
    level, 96 for Swin-T), C = 256; ``at`` names the path of that shape."""
    from openpvsg_torch.kernels import fpn
    from openpvsg_torch.ops.resize import resize_bilinear

    C, Cout, G, eps = 256, 256, 32, 1e-6
    H8, W8 = H // 2, W // 2

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    f0_32, s8_32 = rnd(B, H, W, Cin), rnd(B, H8, W8, C)
    p32 = {"w_lat": rnd(Cin, C, scale=Cin ** -0.5), "b_lat": rnd(C, scale=0.1),
           "gn1_scale": rnd(C, scale=0.1, shift=1.0), "gn1_bias": rnd(C, scale=0.1),
           "w_out": rnd(3, 3, C, C, scale=(9 * C) ** -0.5), "b_out": rnd(C, scale=0.1),
           "gn2_scale": rnd(C, scale=0.1, shift=1.0), "gn2_bias": rnd(C, scale=0.1),
           "w_mask": rnd(C, Cout, scale=C ** -0.5), "b_mask": rnd(Cout, scale=0.1)}
    count = H * W * (C // G)
    M = B * H * W
    results = {}
    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        es = 4 if dt == torch.float32 else 2
        # per-stage tolerance: both sides compute in float32 from the same
        # inputs and round once to the activation type; the chain compares
        # against the unfused module chain, which rounds at every module in
        # bfloat16
        stage_tol = 1e-4 if dt == torch.float32 else 1e-2
        chain_tol = 2e-4 if dt == torch.float32 else 5e-2
        f0, s8 = f0_32.to(dt).contiguous(), s8_32.to(dt).contiguous()
        w_lat = p32["w_lat"].to(dt).contiguous()
        w_out = p32["w_out"].to(dt).contiguous()
        w_mask = p32["w_mask"].to(dt).contiguous()
        b = {k: p32[k] for k in ("b_lat", "b_out", "b_mask")}

        l_ref, s1, q1 = fpn.lateral_stats_plain(f0, w_lat, b["b_lat"])
        l_got, s1k, q1k = fpn.lateral_stats(f0, w_lat, b["b_lat"])
        sc1, bi1 = fpn.group_affine(s1, q1, p32["gn1_scale"], p32["gn1_bias"],
                                    count, G, eps)
        x2_ref, s2, q2 = fpn.conv3x3_stats_plain(l_ref, s8, sc1, bi1, w_out,
                                                 b["b_out"])
        x2_got, s2k, q2k = fpn.conv3x3_stats(l_ref, s8, sc1, bi1, w_out,
                                             b["b_out"])
        sc2, bi2 = fpn.group_affine(s2, q2, p32["gn2_scale"], p32["gn2_bias"],
                                    count, G, eps)
        m_ref = fpn.mask_proj_plain(x2_ref, sc2, bi2, w_mask, b["b_mask"])
        m_got = fpn.mask_proj(x2_ref, sc2, bi2, w_mask, b["b_mask"])
        chain_ref = fpn.fpn_stride4_plain(f0, s8, p32, G, eps)
        chain_got = fpn.fpn_stride4(f0, s8, p32, G, eps)
        torch.cuda.synchronize()

        x1 = (l_ref.float() * sc1[:, None, None] + bi1[:, None, None]
              + resize_bilinear(s8.float(), (H, W))).to(dt)
        x1_nchw = x1.permute(0, 3, 1, 2)
        w_out_oihw = w_out.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        y2 = torch.relu(x2_ref.float() * sc2[:, None, None]
                        + bi2[:, None, None]).to(dt).reshape(M, C)
        stages = {
            "fpn_lateral": dict(
                got=l_got, ref=l_ref, sums=(s1k, s1, q1k, q1),
                fn=lambda: fpn.lateral_stats(f0, w_lat, b["b_lat"]),
                plain=lambda: fpn.lateral_stats_plain(f0, w_lat, b["b_lat"]),
                lib=lambda: torch.addmm(b["b_lat"].to(dt), f0.reshape(M, Cin), w_lat),
                flops=2 * M * Cin * C,
                nbytes=(M * Cin + Cin * C + M * C) * es + C * 4 + 2 * B * C * 4),
            "fpn_conv3x3": dict(
                got=x2_got, ref=x2_ref, sums=(s2k, s2, q2k, q2),
                fn=lambda: fpn.conv3x3_stats(l_ref, s8, sc1, bi1, w_out, b["b_out"]),
                plain=lambda: fpn.conv3x3_stats_plain(l_ref, s8, sc1, bi1, w_out,
                                                      b["b_out"]),
                lib=lambda: torch.nn.functional.conv2d(
                    x1_nchw, w_out_oihw, b["b_out"].to(dt), padding=1),
                flops=2 * M * 9 * C * C,
                nbytes=((M * C + B * H8 * W8 * C + 9 * C * C + M * C) * es
                        + 2 * B * C * 4 + C * 4 + 2 * B * C * 4)),
            "fpn_mask": dict(
                got=m_got, ref=m_ref, sums=None,
                fn=lambda: fpn.mask_proj(x2_ref, sc2, bi2, w_mask, b["b_mask"]),
                plain=lambda: fpn.mask_proj_plain(x2_ref, sc2, bi2, w_mask,
                                                  b["b_mask"]),
                lib=lambda: torch.addmm(b["b_mask"].to(dt), y2, w_mask),
                flops=2 * M * C * Cout,
                nbytes=(M * C + C * Cout + M * Cout) * es + 2 * B * C * 4 + Cout * 4),
        }
        for name, s in stages.items():
            ref_max = float(s["ref"].float().abs().max())
            err = max_abs(s["got"], s["ref"])
            ok = err <= stage_tol * max(1.0, ref_max)
            sum_err = None
            if s["sums"] is not None:
                sk, sr, qk, qr = s["sums"]
                sum_err = max(float(((sk - sr).abs() / (sr.abs() + qr.sqrt() + 1e-6)).max()),
                              float(((qk - qr).abs() / (qr + 1e-6)).max()))
                ok = ok and sum_err <= 1e-3
            bound_ms, bound_by = bound(s["flops"], s["nbytes"], dt_name)
            ms = time_ms(torch, s["fn"])
            row = {"max_abs_err": err, "ref_absmax": ref_max,
                   "tol": stage_tol * max(1.0, ref_max), "stats_rel_err": sum_err,
                   "ms": ms, "plain_ms": time_ms(torch, s["plain"]),
                   "library_ms": time_ms(torch, s["lib"]),
                   "call_ms": call_ms(torch, s["fn"]),
                   "library_call_ms": call_ms(torch, s["lib"]),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "tflops": s["flops"] / ms / 1e9, "bound_share": bound_ms / ms,
                   "design": DESIGN[name] if dt == torch.bfloat16 else SIMT, "ok": ok}
            results[(name, dt_name)] = row
            emit({"phase": "kernel_vs_plain", "kernel": name, "dtype": dt_name,
                  "at": at, "shape": [B, H, W, C], "cin": Cin, **row})
            if not ok:
                fail(f"{name} {dt_name} disagrees with its plain version: {row}")
        ref_max = float(chain_ref.float().abs().max())
        err = max_abs(chain_got, chain_ref)
        again = fpn.fpn_stride4(f0, s8, p32, G, eps)
        row = {"max_abs_err": err, "ref_absmax": ref_max,
               "tol": chain_tol * max(1.0, ref_max),
               "deterministic": bool(torch.equal(again, chain_got)),
               "ms": time_ms(torch, lambda: fpn.fpn_stride4(f0, s8, p32, G, eps)),
               "plain_ms": time_ms(torch, lambda: fpn.fpn_stride4_plain(f0, s8, p32, G, eps)),
               "call_ms": call_ms(torch, lambda: fpn.fpn_stride4(f0, s8, p32, G, eps)),
               "plain_call_ms": call_ms(
                   torch, lambda: fpn.fpn_stride4_plain(f0, s8, p32, G, eps))}
        row["ok"] = err <= row["tol"] and row["deterministic"]
        emit({"phase": "kernel_vs_plain", "kernel": "fpn_stride4 (chain)",
              "dtype": dt_name, "at": at, "shape": [B, H, W, C], "cin": Cin, **row})
        if not row["ok"]:
            fail(f"fpn_stride4 {dt_name} disagrees with the module chain or "
                 f"with itself: {row}")
    return results


FUSION_DESIGN = ("simt f32: 8x8 low-res tile per CTA, halo tiles through a cp.async ring, "
                 "phase-planar upsample with shared horizontal blends, queries by descending "
                 "score, exact sigmoid only where a query can win, warp-reduced counts")
SFU_PER_SM_CLOCK = 16  # ex2 and rcp run on the SFU, 16 per SM and clock on Hopper
# FP32 operations per query-pixel pair: a quarter of a horizontal blend (a 4x
# upsample shares each across four output rows), a vertical blend (3 each)
# and the threshold
FUSION_PAIR_FLOPS = 0.25 * 3 + 3 + 1


def fusion_input(torch, gen, dev, no_skip, N=2, Q=100, h=96, w=120):
    """The main-path shape: logits randn * 3; the smoke input has scores
    U(0.05, 1) with ~30% of the queries dropped; the no-skip input keeps
    every query at one score, so no score-based skip applies."""
    low = (torch.randn((N, Q, h, w), generator=gen) * 3.0).to(dev)
    if no_skip:
        return low, torch.full((N, Q), 0.5, device=dev)
    scores = torch.rand((N, Q), generator=gen) * 0.95 + 0.05
    dropped = torch.rand((N, Q), generator=gen) < 0.3
    return low, torch.where(dropped, torch.tensor(float("-inf")), scores).to(dev)


def sigmoid_counts(torch, low, scores):
    """Query-pixel pairs whose exact sigmoid the function needs on these
    inputs, from the plain side (never called by the port), by two exact
    rules. val = s * sigmoid(u) is at most the query's bound, so a query
    whose bound is below the best value of the queries visited before it
    cannot take the pixel:

    ascending   queries in index order (a tie goes to the earlier query), the
                bound is the score: pairs with s > the best before
                (torch.cummax);
    descending  queries by descending score (ties by index), the bound is
                max(s, 0), halved where u <= 0 (sigmoid(u) <= 0.5 there):
                pairs whose bound reaches the best before.

    Dropped queries (-inf) need none."""
    F = torch.nn.functional
    N, Q, h, w = low.shape
    up = F.interpolate(low, size=(4 * h, 4 * w), mode="bilinear", align_corners=False)
    kept = ~torch.isneginf(scores)[:, :, None, None]
    val = torch.where(kept, scores[:, :, None, None] * torch.sigmoid(up),
                      torch.tensor(float("-inf"), device=low.device))

    def before(v):  # best of the queries visited earlier
        prev = torch.cummax(v, dim=1).values
        return torch.cat([torch.full_like(prev[:, :1], float("-inf")), prev[:, :-1]], 1)

    needed = int(((scores[:, :, None, None] > before(val)) & kept).sum())
    order = torch.argsort(scores, dim=1, descending=True, stable=True)
    g = order[:, :, None, None].expand_as(up)
    ub = scores.gather(1, order).clamp(min=0.0)[:, :, None, None]
    ub = torch.where(up.gather(1, g) <= 0, 0.5 * ub, ub)
    kept_desc = kept.gather(1, order[:, :, None, None])
    needed_desc = int(((ub >= before(val.gather(1, g))) & kept_desc).sum())
    return needed, needed_desc


def fusion_bound(N, Q, h, w, n_sig, sm_clock_hz):
    """Least time for the fusion pass on these inputs: the largest of the
    bytes (logits read, maps written, scores and areas), the FP32 operations
    (FUSION_PAIR_FLOPS per pair, 3 more per exact sigmoid the input needs)
    and the SFU operations (ex2 and rcp per exact sigmoid)."""
    pairs = N * Q * 16 * h * w
    t = {"bytes": (N * Q * h * w * 4 + N * Q * 4 + N * 16 * h * w * 5 + 2 * N * Q * 4)
         / PEAK_BYTES,
         "fp32": (FUSION_PAIR_FLOPS * pairs + 3 * n_sig) / PEAK_FLOPS["float32"],
         "sfu": 2 * n_sig / (132 * SFU_PER_SM_CLOCK * sm_clock_hz)}
    term = max(t, key=t.get)
    return t[term] * 1e3, term, {k: v * 1e3 for k, v in t.items()}


def check_fusion(torch, gen, dev, sm_clock_hz, N=2, h=96, w=120, ori=(360, 480),
                 inputs=("smoke", "no_skip"), at="stage2"):
    """B2 against its plain version on (N, 100, h, w) logits cropped to
    ``ori``; ``at`` names the path of that shape. The main-path call also
    times one CTA alone."""
    from openpvsg_torch.kernels import fusion

    rows = {}
    for name in inputs:
        low, scores = fusion_input(torch, gen, dev, no_skip=name == "no_skip",
                                   N=N, h=h, w=w)
        N, Q, h, w = low.shape
        H, W = 4 * h, 4 * w
        got = fusion.fusion_maps(low, scores, (H, W), ori)
        ref = fusion.fusion_maps_plain(low, scores, ori)
        torch.cuda.synchronize()
        needed, needed_desc = sigmoid_counts(torch, low, scores)
        executed = fusion.exact_sigmoid_count(low, scores, (H, W), ori)
        pairs = N * Q * H * W
        n_sig = min(needed, needed_desc)
        bound_ms, term, terms = fusion_bound(N, Q, h, w, n_sig, sm_clock_hz)
        ms = time_ms(torch, lambda: fusion.fusion_maps(low, scores, (H, W), ori))
        row = {"input": name, "owner_mismatch": int((got[0] != ref[0]).sum()),
               "binary_mismatch": int((got[1] != ref[1]).sum()),
               "mask_area_max_diff": int((got[2] - ref[2]).abs().max()),
               "original_area_max_diff": int((got[3] - ref[3]).abs().max()),
               "tol_pixels": 0, "dropped": int(torch.isneginf(scores).sum()),
               "sigmoid_share_needed": needed / pairs,
               "sigmoid_share_needed_desc": needed_desc / pairs,
               "sigmoid_share_executed": executed / pairs,
               "ms": ms,
               "plain_ms": time_ms(torch, lambda: fusion.fusion_maps_plain(low, scores, ori)),
               "call_ms": call_ms(torch, lambda: fusion.fusion_maps(low, scores, (H, W), ori)),
               "library_ms": None, "bound_ms": bound_ms,
               "bound_by": "bytes" if term == "bytes" else "operations",
               "bound_term": term, "bound_terms_ms": terms,
               "sm_clock_mhz": sm_clock_hz / 1e6,
               "tflops": (FUSION_PAIR_FLOPS * pairs + 3 * n_sig) / ms / 1e9,
               "bound_share": bound_ms / ms, "design": FUSION_DESIGN}
        row["max_abs_err"] = max(row["mask_area_max_diff"], row["original_area_max_diff"])
        row["ok"] = (row["owner_mismatch"] == row["binary_mismatch"] == row["max_abs_err"]
                     == 0)
        emit({"phase": "kernel_vs_plain", "kernel": "fusion_maps", "dtype": "float32",
              "at": at, "shape": [N, Q, h, w], "ori_hw": list(ori), **row})
        if not row["ok"]:
            fail(f"fusion_maps disagrees with its plain version on the {name} input: {row}")
        rows[name] = row
        del low, scores, got, ref
    if at != "stage2":
        return rows
    # one CTA alone (8x8 low-res pixels, one frame): the kernel's latency
    low, scores = fusion_input(torch, gen, dev, no_skip=False, N=1, h=8, w=8)
    rows["smoke"]["one_cta_ms"] = time_ms(
        torch, lambda: fusion.fusion_maps(low, scores, (32, 32), (32, 32)))
    emit({"phase": "kernel_vs_plain", "kernel": "fusion_maps", "input": "one CTA",
          "shape": [1, 100, 8, 8], "ms": rows["smoke"]["one_cta_ms"]})
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: the model
# ---------------------------------------------------------------------------

def stage2_config():
    from openpvsg_torch.config import mask2former_vps

    # random weights: lower the keep thresholds so segments survive and
    # fusion and RLE do real work (as tests/test_end2end.py does)
    return dataclasses.replace(mask2former_vps().model, object_mask_thr=0.0,
                               iou_thr=0.1)


def synthetic_frames(np, n, h, w, seed):
    """Noise frames with two moving blocks and a static floor strip."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (n, h, w, 3), dtype=np.uint8)
    for t in range(n):
        x0 = 40 + 12 * t
        frames[t, 60:180, x0:x0 + 120] = (250, 30, 30)
        frames[t, 200:260, 400 - 8 * t:460 - 8 * t] = (30, 30, 250)
        frames[t, 300:] = (30, 250, 30)
    return frames


def check_reference(torch, np, cfg, state, seed, phase="reference"):
    """Full-width model, small input: the GPU path (kernels) in float32
    against the CPU path (plain versions, the path the tests hold against
    the JAX package)."""
    from openpvsg_torch.infer.segmenter import SegmenterInference

    frames = synthetic_frames(np, 2, 360, 480, seed)[:, 100:164, 100:164]
    outs = {}
    for dev in ("cpu", None):
        seg = SegmenterInference(cfg, state, dtype=torch.float32, device=dev)
        outs[dev] = [t.float().cpu() for t in seg.forward_frames(frames)]
        del seg
    row = {}
    ok = True
    for name, a, b in zip(("cls", "masks", "query"), outs[None], outs["cpu"]):
        err = max_abs(a, b)
        ref_max = float(b.abs().max())
        good = (bool(torch.isfinite(a).all()) and a.shape == b.shape
                and err <= 1e-3 * max(1.0, ref_max))
        row[name] = {"shape": list(a.shape), "max_abs_err": err,
                     "ref_absmax": ref_max, "ok": good}
        ok = ok and good
    emit({"phase": phase, "input": [2, 64, 64, 3], "dtype": "float32",
          **row, "ok": ok})
    if not ok:
        fail(f"GPU forward disagrees with the CPU reference: {row}")


def class_maps(np, path, n_frames):
    """masks.txt -> per-frame class-id maps (-1 where no segment)."""
    from openpvsg_torch.data import io as data_io
    from openpvsg_torch.data import rle as rle_codec

    maps = None
    for e in data_io.read_masks_txt(path):
        if maps is None:
            maps = np.full((n_frames, *e["rle"]["size"]), -1, np.int64)
        maps[e["fid"] - 1][rle_codec.decode(e["rle"]) > 0] = e["cid"]
    return maps


def run_stage2(torch, np, cfg, state, seed, wrappers, n_frames=16):
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.infer.stages import run_query_tube_vps

    seg = SegmenterInference(cfg, state, dtype=torch.bfloat16)
    frames = list(synthetic_frames(np, n_frames, 360, 480, seed))
    with tempfile.TemporaryDirectory() as tmp:
        run_query_tube_vps(seg, frames[:4], os.path.join(tmp, "warm"), window=2)
        for fn in wrappers:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_tubes = run_query_tube_vps(seg, frames, os.path.join(tmp, "vid"), window=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in wrappers}
        # the same frames again: are the outputs the same bytes? (timed too:
        # the stage is bound by the host, and one run's frames/s is noisy)
        t0 = time.perf_counter()
        run_query_tube_vps(seg, frames, os.path.join(tmp, "again"), window=2)
        torch.cuda.synchronize()
        wall_again = time.perf_counter() - t0
        masks = []
        for run in ("vid", "again"):
            with open(os.path.join(tmp, run, "quantitive", "masks.txt"), "rb") as f:
                masks.append(f.read())
        lines = masks[0].decode().splitlines()
        with open(os.path.join(tmp, "vid", "query_feats.pickle"), "rb") as f:
            pickle_bytes = len(f.read())
        # several windows per forward on the same frames: each batch size
        # warmed once, its launch counts zeroed just before its run and read
        # just after; its masks.txt is compared with the serial run's
        serial = class_maps(np, os.path.join(tmp, "vid", "quantitive", "masks.txt"),
                            n_frames)
        batched = {}
        for wpb in (2, 4):
            run_query_tube_vps(seg, frames[:2 * wpb], os.path.join(tmp, f"warm{wpb}"),
                               window=2, windows_per_batch=wpb)
            for fn in wrappers:
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_query_tube_vps(seg, frames, os.path.join(tmp, f"wpb{wpb}"), window=2,
                               windows_per_batch=wpb)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            path = os.path.join(tmp, f"wpb{wpb}", "quantitive", "masks.txt")
            with open(path, "rb") as f:
                same = f.read() == masks[0]
            differ = float((class_maps(np, path, n_frames) != serial).mean())
            batched[wpb] = {"frames_per_s": n_frames / seconds, "seconds": seconds,
                            "batch_frames": 2 * wpb, "masks_txt_identical": same,
                            "class_pixels_differing_share": differ,
                            "launches": {fn.__name__: fn.launches for fn in wrappers}}
        # the same comparison in float32 (TF32 off), where only cuBLAS's
        # products differ with the batch, in their last bits: the bytes must
        # be the serial run's, JAX's contract
        seg32 = SegmenterInference(cfg, state, dtype=torch.float32)
        f32 = {}
        for wpb in (1, 4):
            root = os.path.join(tmp, f"f32_{wpb}")
            run_query_tube_vps(seg32, frames, root, window=2, windows_per_batch=wpb)
            with open(os.path.join(root, "quantitive", "masks.txt"), "rb") as f:
                f32[wpb] = f.read()
        f32_row = {"masks_txt_identical": f32[1] == f32[4],
                   "class_pixels_differing_share": float(
                       (class_maps(np, os.path.join(tmp, "f32_4", "quantitive", "masks.txt"),
                                   n_frames)
                        != class_maps(np, os.path.join(tmp, "f32_1", "quantitive",
                                                       "masks.txt"), n_frames)).mean())}
        del seg32
    row = {"frames": n_frames, "frame_hw": [360, 480], "window": 2,
           "dtype": "bfloat16", "seconds": wall, "frames_per_s": n_frames / wall,
           "tubes": n_tubes, "masks_txt_lines": len(lines),
           "frames_per_s_rerun": n_frames / wall_again,
           "masks_txt_identical_on_rerun": masks[0] == masks[1],
           "masks_txt_lines_rerun": len(masks[1].decode().splitlines()),
           "query_feats_pickle_bytes": pickle_bytes, "launches": launches,
           "windows_per_batch": {str(k): v for k, v in batched.items()},
           "windows_per_batch_4_float32": f32_row}
    emit({"phase": "stage2", **row})
    if not lines:
        fail("masks.txt is empty")
    if any(v == 0 for v in launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    if not f32_row["masks_txt_identical"]:
        fail(f"windows_per_batch=4 changed the float32 masks.txt: {f32_row}")
    for wpb, b in batched.items():
        # cuDNN and cuBLAS pick other kernels at another batch size, whose
        # sums differ in the last bits (in bf16 from R-50's layer2_1.conv2
        # on), and the random weights' near-ties in fusion (every query kept
        # at object_mask_thr 0) turn those into other owners on a few
        # percent of the pixels (4.5% at 2 windows in the first H100 run); a
        # batching fault (frames or windows out of place) moves most of them
        if b["class_pixels_differing_share"] > 0.1:
            fail(f"windows_per_batch={wpb} changed masks.txt beyond the last "
                 f"bits: {b['class_pixels_differing_share']:.4f} of the pixels")
        if any(v == 0 for v in b["launches"].values()):
            fail(f"windows_per_batch={wpb}: a kernel never launched: {b['launches']}")
    return launches, {wpb: b["launches"] for wpb, b in batched.items()}


# ---------------------------------------------------------------------------
# phases 6-7: stage-1 training
# ---------------------------------------------------------------------------

def tiny_train_config():
    """The tests' small model (tests/test_torch_train.py)."""
    from openpvsg_torch.config import (BackboneConfig, Mask2FormerConfig,
                                       PixelDecoderConfig,
                                       TransformerDecoderConfig)

    return Mask2FormerConfig(
        num_things_classes=3, num_stuff_classes=2, num_queries=8,
        backbone=BackboneConfig(depth=26, norm="sync_bn"),
        pixel_decoder=PixelDecoderConfig(encoder_layers=1, ffn_channels=64),
        decoder=TransformerDecoderConfig(num_layers=3, ffn_channels=64))


def train_batch(np, clips, frames, hw, padded_hw, max_instances, num_classes,
                seed):
    """Synthetic clips from the seed: uint8 noise frames zero-padded to
    ``padded_hw``, each clip with 1..max_instances rectangular tubes (one
    colour each, drifting from frame to frame) and random labels; the batch
    dict of ``pad_targets`` (masks at stride 4)."""
    from openpvsg_torch.train.segmenter import pad_targets

    rng = np.random.default_rng(seed)
    H, W = hw
    samples = []
    for _ in range(clips):
        images = np.zeros((frames, *padded_hw, 3), np.uint8)
        images[:, :H, :W] = rng.integers(0, 255, (frames, H, W, 3), dtype=np.uint8)
        n = int(rng.integers(1, max_instances + 1))
        tubes = np.zeros((n, frames, *padded_hw), np.uint8)
        for j in range(n):
            h = int(rng.integers(H // 10, H // 3))
            w = int(rng.integers(W // 10, W // 3))
            y, x = int(rng.integers(0, H - h)), int(rng.integers(0, W - w))
            dy, dx = (int(d) for d in rng.integers(-H // 20, H // 20 + 1, 2))
            colour = rng.integers(0, 255, 3, dtype=np.uint8)
            for t in range(frames):
                yt = min(max(y + t * dy, 0), H - h)
                xt = min(max(x + t * dx, 0), W - w)
                tubes[j, t, yt:yt + h, xt:xt + w] = 1
                images[t, yt:yt + h, xt:xt + w] = colour
        samples.append({"images": images,
                        "gt_labels": rng.integers(0, num_classes, n),
                        "gt_mask_tubes": tubes})
    return pad_targets(samples, max_instances)


def launch_counts(wrappers):
    return {fn.__name__: fn.launches for fn in wrappers}


def float64_grads(torch, cfg, state, images, batch, assigned):
    """The same step's gradients in float64 on the CPU, with the same
    assignment: the arbiter of the two float32 runs."""
    from openpvsg_torch.models.mask2former import Mask2Former
    from openpvsg_torch.train.losses import mask2former_loss

    model = Mask2Former(cfg, train=True).double()
    model.load_state_dict(state)
    cls, masks, _ = model(images.double())
    loss, _ = mask2former_loss(
        cls, masks, torch.from_numpy(batch["gt_labels"]).long(),
        torch.from_numpy(batch["gt_masks"]).double(),
        torch.from_numpy(batch["gt_valid"]), cfg.num_classes,
        cls_weight=cfg.loss_cls_weight, mask_weight=cfg.loss_mask_weight,
        dice_weight=cfg.loss_dice_weight, bg_cls_weight=cfg.bg_cls_weight,
        assigned=assigned)
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters()}


def grad_rel_diff(got, want):
    """Largest gradient difference relative to each tensor's scale, and
    where; key-projection biases (an exact gradient of zero, scale < 1e-6)
    are left out."""
    worst, where = 0.0, None
    for n, g in want.items():
        scale = float(g.abs().max())
        if scale > 1e-6:
            rel = float((got[n].double() - g).abs().max()) / scale
            if rel > worst:
                worst, where = rel, n
    return worst, where


def key_bias(name):
    """Attention key-projection biases: the softmax over keys is invariant
    to them, so their exact gradient is zero and what they get is rounding
    noise, which Adam scales to a step of the full lr."""
    return name.endswith("k_proj.bias")


def update_gap(names, before, after, other):
    """How far ``other`` lies from ``after``, the parameters one update
    past ``before``, as a share of that update: for each tensor but the
    key biases, max|other - after| less one float32 ulp of the tensor's
    largest value, over max|after - before|. Returns the largest share and
    its tensor's name; 1e-2 means the updates agree within 1% of the
    update."""
    worst, at = 0.0, None
    for n, b, a, o in zip(names, before, after, other):
        if key_bias(n):
            continue
        gap = float((o - a).abs().max()) - 2.0 ** -23 * float(b.abs().max())
        step = float((a - b).abs().max())
        share = (gap / step if step > 0 else float("inf")) if gap > 0 else 0.0
        if share > worst:
            worst, at = share, n
    return worst, at


def tf32_probe(torch, model):
    """Records (matmul, cuDNN) TF32 flags each time the model runs."""
    seen = []
    model.register_forward_pre_hook(lambda *_: seen.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))
    return seen


def check_train_reference(torch, np, seed):
    """One train step of the small model on the card and on the CPU at the
    full lr, the step's float64 gradients on the CPU, and the card's update
    against the CPU's update from the card's gradients."""
    from openpvsg_torch.config import TrainConfig
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import random_state_dict

    t_phase = time.perf_counter()
    cfg = tiny_train_config()
    state = random_state_dict(cfg, seed)
    batch = train_batch(np, 2, 2, (64, 64), (64, 64), 3, cfg.num_classes, seed)
    # warmup_ratio 1: the first update runs at the full lr of 1e-4
    tcfg = TrainConfig(warmup_ratio=1.0)
    cpu, gpu = (SegmenterTrainer(cfg, tcfg, steps_per_epoch=10, device=dev,
                                 state_dict=state) for dev in ("cpu", None))
    tf32 = tf32_probe(torch, gpu.model)
    logs = {}
    for name, tr in (("cpu", cpu), ("gpu", gpu)):
        _, out = tr.loss_and_grads(batch)
        logs[name] = {k: float(v.detach()) for k, v in out.items()}
    names = [n for n, _ in cpu.model.named_parameters()]
    grads = {name: {n: p.grad.detach().cpu().clone() for n, p in
                    zip(names, tr.params)} for name, tr in (("cpu", cpu), ("gpu", gpu))}
    exact = float64_grads(torch, cfg, state, cpu.device_batch(batch)[0], batch,
                          cpu.last_assigned)
    before = [p.detach().clone() for p in cpu.params]
    for n, p in zip(names, cpu.params):  # the CPU updates from the card's grads
        p.grad.copy_(grads["gpu"][n])
    cpu.apply_updates()
    gpu.apply_updates()
    gap, gap_at = update_gap(names, before, [p.detach() for p in cpu.params],
                             [p.detach().cpu() for p in gpu.params])
    loss_rel = max(abs(logs["gpu"][k] - v) / max(abs(v), 1e-12)
                   for k, v in logs["cpu"].items())
    grad_rel, grad_rel_name = grad_rel_diff(grads["gpu"], grads["cpu"])
    gpu_f64, gpu_f64_name = grad_rel_diff(grads["gpu"], exact)
    cpu_f64, cpu_f64_name = grad_rel_diff(grads["cpu"], exact)
    same_assignment = bool(np.array_equal(cpu.last_assigned, gpu.last_assigned))
    row = {"size": "R-26, Q=8, 3 decoder layers, B=2, T=2, 64x64, N=3",
           "dtype": "float32", "lr": float(cpu.schedule(0)),
           "tf32_in_step": tf32, "loss_cpu": logs["cpu"]["loss"],
           "loss_gpu": logs["gpu"]["loss"], "max_loss_rel_diff": loss_rel,
           "assignments_equal": same_assignment,
           "max_grad_rel_diff": grad_rel, "max_grad_rel_diff_at": grad_rel_name,
           "gpu_vs_float64_max_grad_rel_diff": gpu_f64,
           "gpu_vs_float64_at": gpu_f64_name,
           "cpu_vs_float64_max_grad_rel_diff": cpu_f64,
           "cpu_vs_float64_at": cpu_f64_name,
           "max_update_gap_share": gap, "max_update_gap_at": gap_at}
    # float32 gradients of a conv feeding a normalization are ill-conditioned
    # (the norm's backward removes the mean and scale its input carries), so
    # two summation orders leave them up to a few 1e-3 of their scale apart;
    # a wrong gradient is O(1) apart. Adam's first step divides each element
    # by its own magnitude, so the updates are compared from one set of
    # gradients: what differs then is the clip and the optimizer alone
    row["ok"] = (loss_rel <= 1e-3 and same_assignment and grad_rel <= 1e-2
                 and gap <= 1e-2 and tf32 == [(False, False)])
    row["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "train_reference", **row})
    if not row["ok"]:
        fail(f"the train step on the card disagrees with the CPU: {row}")


def step_under(torch, trainer, batch, assigned):
    """The trainer's forward, and its objective's loss and gradients under
    ``assigned`` (L, B, Q), dense, in the trainer's precision: (loss,
    {name: gradient}, cls, mask logits) on the CPU."""
    from openpvsg_torch.train.losses import mask2former_loss
    from openpvsg_torch.train.segmenter import ieee_float32

    cfg = trainer.cfg
    with ieee_float32():
        images, gt_labels, gt_masks, gt_valid = trainer.device_batch(batch)
        cls, masks, _ = trainer.model(images)
        loss, _ = mask2former_loss(
            cls, masks, gt_labels, gt_masks, gt_valid, cfg.num_classes,
            cls_weight=cfg.loss_cls_weight, mask_weight=cfg.loss_mask_weight,
            dice_weight=cfg.loss_dice_weight, bg_cls_weight=cfg.bg_cls_weight,
            assigned=assigned)
        trainer.optimizer.zero_grad(set_to_none=False)
        loss.backward()
    grads = {n: p.grad.detach().cpu().clone()
             for n, p in trainer.model.named_parameters()}
    return float(loss.detach()), grads, cls.detach().float().cpu(), masks.detach().float().cpu()


def within_bf16(got, want, ref, wide):
    """tests/test_torch_train_bf16.py's rule: |got - want| <= k |want -
    ref| + 1e-2 scale + 1e-6 (largest elementwise values; scale that of
    ref), with k = 6 where ``wide`` else 2."""
    got, want, ref = (t.double() for t in (got, want, ref))
    gap = float((got - want).abs().max())
    own = float((want - ref).abs().max())
    return gap <= (6 if wide else 2) * own + 1e-2 * float(ref.abs().max()) + 1e-6


def check_train_reference_bf16(torch, np, seed):
    """Phase 6's bf16 case: the small model's bfloat16 step on the card
    against the CPU's bfloat16 step from the same state dict and batch, at
    tests/test_torch_train_bf16.py's tolerances, the CPU's float32 step the
    reference: under the CPU's bfloat16 assignment, the loss within 1e-2
    (relative), the cls and mask logits within twice the CPU's bfloat16
    distance to float32 plus 1e-2 of their scale, every gradient within six
    times it and nine in ten within twice it. The trainers' own assignments
    are reported (near-ties of the small random model may order
    differently); the card's update must leave float32 parameters."""
    from openpvsg_torch.config import TrainConfig
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import random_state_dict

    t_phase = time.perf_counter()
    cfg32 = tiny_train_config()
    cfg = dataclasses.replace(cfg32, backbone=dataclasses.replace(
        cfg32.backbone, dtype="bfloat16"))
    state = random_state_dict(cfg32, seed)
    batch = train_batch(np, 2, 2, (64, 64), (64, 64), 3, cfg.num_classes, seed)
    tcfg = TrainConfig(warmup_ratio=1.0)
    cpu, gpu = (SegmenterTrainer(cfg, tcfg, steps_per_epoch=10, device=dev,
                                 state_dict=state) for dev in ("cpu", None))
    ref32 = SegmenterTrainer(cfg32, tcfg, steps_per_epoch=10, device="cpu",
                             state_dict=state)
    cpu.loss_and_grads(batch)
    gpu.loss_and_grads(batch)
    assigned = cpu.last_assigned
    own_equal = int(sum(np.array_equal(a, b) for a, b in zip(
        cpu.last_assigned.reshape(-1, cpu.last_assigned.shape[-1]),
        gpu.last_assigned.reshape(-1, gpu.last_assigned.shape[-1]))))
    (l_cpu, g_cpu, c_cpu, m_cpu), (l_gpu, g_gpu, c_gpu, m_gpu), (l_32, g_32, c_32, m_32) = (
        step_under(torch, tr, batch, assigned) for tr in (cpu, gpu, ref32))
    wide = [n for n in g_32 if not within_bf16(g_gpu[n], g_cpu[n], g_32[n], True)]
    narrow = sum(within_bf16(g_gpu[n], g_cpu[n], g_32[n], False) for n in g_32)
    gpu.apply_updates()
    params_f32 = all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
                     for p in gpu.params)
    row = {"size": "R-26, Q=8, 3 decoder layers, B=2, T=2, 64x64, N=3",
           "dtype": "bfloat16", "loss_cpu": l_cpu, "loss_gpu": l_gpu, "loss_f32": l_32,
           "loss_rel_diff": abs(l_gpu - l_cpu) / abs(l_cpu),
           "own_assignments_equal": own_equal, "problems": int(assigned.size
                                                               // assigned.shape[-1]),
           "cls_ok": within_bf16(c_gpu, c_cpu, c_32, False),
           "masks_ok": within_bf16(m_gpu, m_cpu, m_32, False),
           "grads": len(g_32), "grads_within_2x": narrow, "grads_beyond_6x": wide,
           "params_float32_after_update": params_f32}
    row["ok"] = (row["loss_rel_diff"] <= 1e-2 and row["cls_ok"] and row["masks_ok"]
                 and not wide and narrow >= 0.9 * len(g_32) and params_f32)
    row["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "train_reference_bf16", **row})
    if not row["ok"]:
        fail(f"the bfloat16 train step on the card disagrees with the CPU: {row}")


def run_train(torch, np, seed, steps=6, dtype="float32"):
    from openpvsg_torch.config import mask2former_vps
    from openpvsg_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from openpvsg_torch.train.segmenter import SegmenterTrainer

    t_phase = time.perf_counter()
    pvsg = mask2former_vps()
    cfg, tcfg = pvsg.model, pvsg.train
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, dtype=dtype))
    clips, frames = tcfg.samples_per_gpu, cfg.num_frames
    batch = train_batch(np, clips, frames, (360, 480), (384, 480), 20,
                        cfg.num_classes, seed)
    t0 = time.perf_counter()
    trainer = SegmenterTrainer(cfg, tcfg, steps_per_epoch=1000, seed=seed)
    build_s = time.perf_counter() - t0
    model = trainer.model
    tf32 = tf32_probe(torch, model)
    params0 = [p.detach().clone() for p in trainer.params]
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    had_grad = torch.zeros(len(trainer.params), dtype=torch.bool, device=trainer.device)
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, lap_ms, wait_ms = [], [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = trainer.step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(logs["loss"])
        lap_ms.append(trainer.last_timings["host_lap_s"] * 1e3)
        wait_ms.append(trainer.last_timings["cost_wait_s"] * 1e3)
        had_grad |= torch.stack([p.grad.abs().amax() > 0 for p in trainer.params])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = torch.stack([(p.detach() != p0).any() for p, p0 in
                         zip(trainer.params, params0)])
    names = [n for n, _ in model.named_parameters()]
    unmoved = [names[i] for i in torch.nonzero(had_grad & ~moved).flatten().tolist()]
    stats = dict(model.named_buffers())
    unchanged = [n for n, b in stats0.items() if torch.equal(stats[n], b)]
    checksum = float(sum(p.detach().double().sum() for p in trainer.params))
    n_inst = int(batch["gt_valid"].sum())
    med = statistics.median(step_ms[1:])
    row = {"config": "mask2former_vps", "dtype": dtype, "clips": clips,
           "frames_per_clip": frames, "frame_hw": [360, 480],
           "padded_hw": [384, 480], "max_instances": 20, "instances": n_inst,
           "steps": steps, "build_s": build_s, "losses": losses, "step_ms": step_ms,
           "step_ms_median_2_6": med, "host_lap_ms_median_2_6": statistics.median(lap_ms[1:]),
           "cost_wait_ms_median_2_6": statistics.median(wait_ms[1:]),
           "host_lap_share": statistics.median(lap_ms[1:]) / med,
           "frames_per_s": clips * frames / (med / 1e3), "peak_gib": peak_gib,
           "params": len(names), "params_with_grad": int(had_grad.sum()),
           "params_unmoved": unmoved, "bn_buffers": len(stats0),
           "bn_buffers_unchanged": unchanged, "param_checksum": checksum,
           "tf32_in_steps": sorted(set(tf32))}
    del params0, stats0
    if dtype != "float32":
        # float32 alone takes the checkpoint round trip (the CPU tests hold
        # a bfloat16 resume bitwise)
        problems = [p for p, bad in (
            ("a loss is not finite", not all(np.isfinite(losses))),
            (f"TF32 was on inside a step: {sorted(set(tf32))}",
             set(tf32) != {(False, False)}),
            (f"{len(unmoved)} parameters with a gradient did not move", unmoved),
            (f"{len(unchanged)} BN statistics did not change", unchanged)) if bad]
        row.update(ok=not problems, seconds=time.perf_counter() - t_phase)
        emit({"phase": "train", **row})
        if problems:
            fail("train: " + "; ".join(problems))
        return row

    # checkpoint round trip: the seventh step from a reloaded trainer
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.pt")
        save_checkpoint(path, trainer)
        before7 = [p.detach().clone() for p in trainer.params]
        logs7 = trainer.step(batch)
        after7 = [p.detach().clone() for p in trainer.params]
        del trainer
        resumed = SegmenterTrainer(cfg, tcfg, steps_per_epoch=1000, seed=seed + 1)
        load_checkpoint(path, resumed)
        logs7r = resumed.step(batch)
    loss_diff = max(abs(logs7r[k] - v) / max(abs(v), 1e-12) for k, v in logs7.items())
    param_diff = max(float((p.detach() - q).abs().max())
                     for p, q in zip(resumed.params, after7))
    gap, gap_at = update_gap(names, before7, after7,
                             [p.detach() for p in resumed.params])
    row.update(step7_loss=logs7["loss"], step7_loss_resumed=logs7r["loss"],
               step7_max_log_rel_diff=loss_diff, step7_max_param_abs_diff=param_diff,
               step7_max_update_gap_share=gap, step7_max_update_gap_at=gap_at)
    # the card's kernels are not bitwise deterministic (atomics in the
    # resize backward): equal means logs within 1e-5 relative and the
    # seventh update within 1% of itself (the key biases' noise aside)
    resumed_equal = loss_diff <= 1e-5 and gap <= 1e-2
    problems = []
    if not all(np.isfinite(losses)) or not np.isfinite(logs7["loss"]):
        problems.append("a loss is not finite")
    if set(tf32) != {(False, False)}:
        problems.append(f"TF32 was on inside a step: {sorted(set(tf32))}")
    if unmoved:
        problems.append(f"{len(unmoved)} parameters with a gradient did not move")
    if unchanged:
        problems.append(f"{len(unchanged)} BN statistics did not change")
    if not resumed_equal:
        problems.append("the resumed seventh step differs")
    row["ok"] = not problems
    row["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "train", **row})
    if problems:
        fail("train: " + "; ".join(problems))
    return row


# ---------------------------------------------------------------------------
# phases 8-9: the relation path (stages 3-5)
# ---------------------------------------------------------------------------

REL_FWD_BOUND = 1e-4    # card against CPU, of the output's scale (at least 1)
REL_LOSS_BOUND = 1e-5   # relative
REL_GRAD_BOUND = 1e-3   # of each tensor's scale
REL_RANK_TOL = 1e-4     # scores closer than this may swap; |logits| under it may flip


def relation_sets(np, n_sets, seed, num_relations=57, d=256):
    """``n_sets`` synthetic relation sets from the seed, made one at a time:
    (feats (N, T, d) float32, relations), N in 20-100 tubes, T in 150-1200
    frames, 1-30 GT relations, each with a span of at least 3 frames."""
    for i in range(n_sets):
        rng = np.random.default_rng([seed, i])
        n = int(rng.integers(20, 101))
        t = int(rng.integers(150, 1201))
        rels = []
        for _ in range(int(rng.integers(1, 31))):
            s, o = (int(v) for v in rng.choice(n, 2, replace=False))
            a = int(rng.integers(0, t - 3))
            span = np.zeros(t)
            span[a:a + int(rng.integers(3, min(t - a, 300) + 1))] = 1
            rels.append({"subject_index": s, "object_index": o,
                         "relation": int(rng.integers(0, num_relations)),
                         "relation_span": span})
        yield rng.standard_normal((n, t, d), dtype=np.float32), rels


def ranking_agreement(np, score_a, score_b, tol):
    """Whether two score arrays rank their entries the same way: exactly,
    and wherever adjacent scores of ``score_a`` differ by more than
    ``tol`` (entries closer than that form a block whose members may come
    in any order)."""
    a, b = score_a.ravel(), score_b.ravel()
    oa, ob = np.argsort(-a, kind="stable"), np.argsort(-b, kind="stable")
    exact = bool(np.array_equal(oa, ob))
    cuts = np.flatnonzero(np.diff(a[oa]) < -tol) + 1
    blocks = zip(np.split(oa, cuts), np.split(ob, cuts))
    return exact, all(set(x.tolist()) == set(y.tolist()) for x, y in blocks)


def check_rel_reference(torch, np, seed):
    """The relation model at a small width on the card and on the CPU from
    the same weights: the forward on a padded training batch, one train
    step's loss and gradients, and the ranked pairs, triplets and span bits
    of the evaluation."""
    import random

    from openpvsg_torch.config import RelationHeadConfig
    from openpvsg_torch.train.relation import (RelationTrainer, build_batch,
                                               device_batch, subsample_video)
    from openpvsg_torch.train.segmenter import ieee_float32
    from openpvsg_torch.weights import random_relation_state_dict

    t_phase = time.perf_counter()
    cfg = RelationHeadConfig(d_model=64, encoder_heads=2, encoder_ffn=128,
                             temporal_heads=2, temporal_ffn=128)
    state = random_relation_state_dict(cfg, seed)
    rng = np.random.default_rng(seed)
    n, t = 12, 100  # padded to the training buckets 20 and 128
    feats = rng.standard_normal((n, t, 64), dtype=np.float32)
    rels = []
    for _ in range(8):
        s, o = (int(v) for v in rng.choice(n, 2, replace=False))
        span = np.zeros(t)
        a = int(rng.integers(0, t - 10))
        span[a:a + 10] = 1
        rels.append({"subject_index": s, "object_index": o,
                     "relation": int(rng.integers(0, 57)), "relation_span": span})
    counts = np.bincount([r["relation"] for r in rels], minlength=57) + 1.0
    batch = build_batch(*subsample_video(feats, rels, cfg, random.Random(seed)),
                        cfg, random.Random(seed))
    trainers = {dev: RelationTrainer(cfg, counts, rng_seed=seed, device=dev,
                                     state_dict=state) for dev in ("cpu", None)}
    outs, ranks, grads, losses = {}, {}, {}, {}
    for dev, tr in trainers.items():
        b = device_batch(batch, tr.device)
        with torch.no_grad(), ieee_float32():
            out = tr.model(b["feats"], tube_valid=b["tube_valid"],
                           frame_valid=b["frame_valid"])
            pidx = b["pair_idx"]
            pair = torch.cat([out["sub_feats"][pidx[:, 0]],
                              out["obj_feats"][pidx[:, 1]]], -1)
            span, prob = tr.model.predict(pair, b["frame_valid"])
            outs[dev] = {"pred_matrix": out["pred_matrix"], "span_pred": span,
                         "prob": prob}
            # the evaluation's ranking: every pair of the unpadded video
            x = torch.from_numpy(feats).to(tr.device)
            o = tr.model(x)
            ii, jj = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
            keep = (ii != jj).flatten()
            si, oi = ii.flatten()[keep].to(tr.device), jj.flatten()[keep].to(tr.device)
            sp, pr = tr.model.predict(torch.cat([o["sub_feats"][si], o["obj_feats"][oi]], -1))
            ranks[dev] = {"pairs": o["pred_matrix"].cpu().numpy()[~np.eye(n, dtype=bool)],
                          "triplets": pr.cpu().numpy(), "spans": sp.cpu().numpy()}
        loss, _, g = tr.loss_and_grads(batch)
        losses[dev] = loss.item()
        grads[dev] = {name: x.detach().cpu() for (name, _), x in
                      zip(tr.model.named_parameters(), g)}
    fwd = {}
    for k in outs["cpu"]:
        ref, got = outs["cpu"][k], outs[None][k].cpu()
        fwd[k] = {"max_abs_err": max_abs(got, ref), "scale": float(ref.abs().max())}
    loss_rel = abs(losses[None] - losses["cpu"]) / max(abs(losses["cpu"]), 1e-12)
    grad_rel, grad_at = 0.0, None
    for name, ref in grads["cpu"].items():
        scale = float(ref.abs().max())
        if key_bias(name) or scale == 0.0:
            continue
        rel = float((grads[None][name] - ref).abs().max()) / scale
        if rel > grad_rel:
            grad_rel, grad_at = rel, name
    rc, rg = ranks["cpu"], ranks[None]
    pairs_exact, pairs_sep = ranking_agreement(np, rc["pairs"], rg["pairs"], REL_RANK_TOL)
    trip_exact, trip_sep = ranking_agreement(np, rc["triplets"], rg["triplets"], REL_RANK_TOL)
    sure = np.abs(rc["spans"]) > REL_RANK_TOL
    spans_sep = bool(np.array_equal((rc["spans"] > 0)[sure], (rg["spans"] > 0)[sure]))
    row = {"size": "d 64, 2 heads, ffn 128, pair MLP 1024, transformer head, "
                   f"N {n} (bucket 20), T {t} (bucket 128), 57 relations",
           "dtype": "float32", "forward": fwd,
           "loss_cpu": losses["cpu"], "loss_gpu": losses[None],
           "loss_rel_diff": loss_rel, "max_grad_rel_diff": grad_rel,
           "max_grad_rel_diff_at": grad_at,
           "pairs_ranked_equal": pairs_exact, "pairs_equal_where_separated": pairs_sep,
           "triplets_ranked_equal": trip_exact,
           "triplets_equal_where_separated": trip_sep,
           "span_bits_equal": bool(np.array_equal(rc["spans"] > 0, rg["spans"] > 0)),
           "span_bits_equal_where_separated": spans_sep,
           "bounds": {"forward": REL_FWD_BOUND, "loss": REL_LOSS_BOUND,
                      "grad": REL_GRAD_BOUND, "rank_tol": REL_RANK_TOL}}
    row["ok"] = (all(v["max_abs_err"] <= REL_FWD_BOUND * max(1.0, v["scale"])
                     for v in fwd.values())
                 and loss_rel <= REL_LOSS_BOUND and grad_rel <= REL_GRAD_BOUND
                 and pairs_sep and trip_sep and spans_sep)
    row["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "rel_reference", **row})
    if not row["ok"]:
        fail(f"the relation model on the card disagrees with the CPU: {row}")


def moving_objects(np, rng, T, H, W, n_obj, classes):
    """GT label maps (T, H, W) of ``n_obj`` moving rectangles, each present
    in at least half of the frames (later ones drawn over earlier ones),
    drawn from ``rng``; with their {"object_id", "category"} entries and
    {object id: (first frame, end frame)}."""
    masks = np.zeros((T, H, W), np.uint8)
    objects, present = [], {}
    for oid in range(1, n_obj + 1):
        a = int(rng.integers(0, T // 2))
        b = int(rng.integers(a + T // 2, T + 1))
        h, w = int(rng.integers(H // 10, H // 3)), int(rng.integers(W // 10, W // 3))
        y, x = int(rng.integers(0, H - h)), int(rng.integers(0, W - w))
        dy, dx = (float(d) for d in rng.uniform(-1.0, 1.0, 2))
        for t in range(a, b):
            yt = min(max(int(y + (t - a) * dy), 0), H - h)
            xt = min(max(int(x + (t - a) * dx), 0), W - w)
            masks[t, yt:yt + h, xt:xt + w] = oid
        objects.append({"object_id": oid,
                        "category": classes[int(rng.integers(0, len(classes)))]})
        present[oid] = (a, b)
    return masks, objects, present


def stage3_videos(np, seed, work_dir, n_videos=2, T=380, H=360, W=640, n_obj=20):
    """Synthetic videos and their oracle stage-2 outputs: each video has
    ``n_obj`` moving rectangles (random classes, each present in at least
    half of the frames, later ones drawn over earlier ones) and 1-30 GT
    relations between objects present together; the GT masks are written as
    the predicted ``masks.txt`` (track id = object id) with random 256-d
    query features, as tests/test_end2end.py's oracle does. The GT masks are
    written as palette PNGs under ``work_dir/data`` in the reference layout.
    Returns the pvsg.json path and the data directory."""
    from PIL import Image

    from openpvsg_torch.data import io as data_io
    from openpvsg_torch.data import rle as rle_codec
    from openpvsg_torch.tracker.tubes import SimpleTube

    # PVSG's cardinalities: 115 thing and 11 stuff classes, 57 relations
    anno = {"objects": {"thing": [f"thing{i}" for i in range(115)],
                        "stuff": [f"stuff{i}" for i in range(11)]},
            "relations": [f"rel{i}" for i in range(57)]}
    classes = anno["objects"]["thing"] + anno["objects"]["stuff"]
    data_dir = os.path.join(work_dir, "data")
    data, vids = [], []
    for v in range(n_videos):
        vid = f"{1000 + v:04d}_smoke{v}"
        rng = np.random.default_rng([seed, 1000 + v])
        masks, objects, present = moving_objects(np, rng, T, H, W, n_obj, classes)
        relations = []
        for _ in range(int(rng.integers(1, 31))):
            s, o = (int(i) + 1 for i in rng.choice(n_obj, 2, replace=False))
            lo, hi = max(present[s][0], present[o][0]), min(present[s][1], present[o][1])
            if hi - lo < 10:
                continue
            start = int(rng.integers(lo, hi - 5))
            end = int(rng.integers(start + 5, hi))
            relations.append([s, o, anno["relations"][int(rng.integers(0, 57))],
                              [[start, end]]])
        data.append({"video_id": vid, "meta": {"num_frames": T, "height": H, "width": W},
                     "objects": objects, "relations": relations})
        vids.append(vid)
        mask_dir = os.path.join(data_dir, "vidor", "masks", vid)
        os.makedirs(mask_dir)
        for t in range(T):
            Image.fromarray(masks[t]).save(os.path.join(mask_dir, f"{t:04d}.png"))
        cls_of = {o["object_id"]: classes.index(o["category"]) for o in objects}
        results, tubes = [], {oid: SimpleTube(oid) for oid in cls_of}
        for t in range(T):
            rles, tids = [], []
            for oid, cid in cls_of.items():
                m = masks[t] == oid
                if not m.any():
                    tubes[oid].append(None)
                    continue
                rle = rle_codec.encode(m.astype(np.uint8))
                rle["class_id"] = cid
                rles.append(rle)
                tids.append(oid)
                tubes[oid].append({"query_feat": rng.standard_normal(256, dtype=np.float32),
                                   "cls_id": cid})
            results.append((t + 1, rles, tids))
        data_io.write_masks_txt(os.path.join(work_dir, vid, "quantitive", "masks.txt"),
                                results)
        data_io.save_pickle(os.path.join(work_dir, vid, "query_feats.pickle"),
                            list(tubes.values()))
    anno.update(split={"vidor": {"train": [], "val": vids},
                       "epic_kitchen": {"train": [], "val": []},
                       "ego4d": {"train": [], "val": []}}, data=data)
    path = os.path.join(data_dir, "pvsg.json")
    with open(path, "w") as f:
        json.dump(anno, f)
    return path, data_dir


def train_relation_head(torch, np, cfg, counts, sets, seed):
    """Steps ``RelationTrainer`` (on the card) through the sets; returns
    the trainer and a row: step ms (steps that did not apply Adam), flush
    ms, videos/s over every step, peak GiB, losses, parameters without a
    gradient or that did not move, and the TF32 flags inside the steps."""
    from openpvsg_torch.train.relation import RelationTrainer

    trainer = RelationTrainer(cfg, counts, rng_seed=seed)
    tf32 = tf32_probe(torch, trainer.model)
    params0 = [p.detach().clone() for p in trainer.params]
    had_grad = torch.zeros(len(trainer.params), dtype=torch.bool, device=trainer.device)
    flush_ms = []
    flush = trainer.flush

    def timed_flush():
        nonlocal had_grad
        had_grad = had_grad | torch.stack([g.abs().amax() > 0 for g in trainer._accum])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flush()
        torch.cuda.synchronize()
        flush_ms.append((time.perf_counter() - t0) * 1e3)

    trainer.flush = timed_flush
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, shapes = [], [], []
    for feats, rels in sets:
        n_flush = len(flush_ms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.step(feats, rels)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if out is None:
            fail("a relation set had no GT pair")
        losses.append(out[0])
        shapes.append(list(feats.shape[:2]))
        step_ms.append((ms, len(flush_ms) > n_flush))
    names = [n for n, _ in trainer.model.named_parameters()]
    moved = torch.stack([(p.detach() != p0).any() for p, p0 in zip(trainer.params, params0)])
    no_grad = [names[i] for i in torch.nonzero(~had_grad).flatten().tolist()]
    unmoved = [names[i] for i in torch.nonzero(~moved).flatten().tolist()]
    plain = [ms for ms, flushed in step_ms if not flushed]
    total_s = sum(ms for ms, _ in step_ms) / 1e3
    row = {"videos": len(step_ms), "applies": len(flush_ms),
           "step_ms_median": statistics.median(plain), "step_ms_max": max(plain),
           "step_ms_first": step_ms[0][0], "flush_ms": flush_ms,
           "videos_per_s": len(step_ms) / total_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses_first_last": [losses[0], losses[-1]],
           "loss_mean_first_half": float(np.mean(losses[:len(losses) // 2])),
           "loss_mean_second_half": float(np.mean(losses[len(losses) // 2:])),
           "params": len(names), "params_without_grad": no_grad,
           "params_unmoved": unmoved, "tf32_in_steps": sorted(set(tf32)),
           "shapes_n_t": shapes}
    trainer.flush = flush
    return trainer, row


def run_relations(torch, np, seed, wrappers, n_train=64, n_eval=16):
    """Stages 3-5 at full width: ``run_rel_set`` on two oracle videos,
    ``relation_head('transformer')`` training over ``n_train`` synthetic
    sets plus one accumulation cycle of ``relation_conv_large``, ``evaluate``
    over ``n_eval`` sets and ``evaluate_full`` over the stage-3 videos."""
    from openpvsg_torch.config import relation_conv_large, relation_head
    from openpvsg_torch.data import io as data_io
    from openpvsg_torch.data.datasets import PVSGRelationDataset
    from openpvsg_torch.data.pvsg import PVSGRelationAnnotation
    from openpvsg_torch.eval.rel_eval import K_VALUES, evaluate
    from openpvsg_torch.eval.rel_full_eval import evaluate_full, save_metrics_to_csv
    from openpvsg_torch.infer.stages import run_rel_set
    from openpvsg_torch.train.checkpoint import (load_relation_checkpoint,
                                                 save_relation_checkpoint)
    from openpvsg_torch.train.relation import RelationTrainer

    t_phase = time.perf_counter()
    problems = []
    with tempfile.TemporaryDirectory() as work:
        # stage 3
        t0 = time.perf_counter()
        anno_file, data_dir = stage3_videos(np, seed, work)
        setup_s = time.perf_counter() - t0
        anno = PVSGRelationAnnotation(anno_file, "val")
        vids = anno.split_video_ids
        meta = anno[vids[0]]["meta"]
        stage3 = {"videos": len(vids), "frames": meta["num_frames"],
                  "frame_hw": [meta["height"], meta["width"]],
                  "gt_objects": len(anno[vids[0]]["objects"]), "setup_s": setup_s, "seconds_per_video": [],
                  "gt_relations": [], "relations_written": []}
        for vid in vids:
            t0 = time.perf_counter()
            path = run_rel_set(vid, work, anno, data_dir)
            stage3["seconds_per_video"].append(time.perf_counter() - t0)
            stage3["gt_relations"].append(len(anno[vid]["relations"]))
            stage3["relations_written"].append(len(data_io.load_pickle(path)["relations"]))
        if not sum(stage3["relations_written"]):
            problems.append("stage 3 wrote no relation")
        emit({"phase": "relations", "part": "stage3", **stage3})

        # stage 4
        cfg = relation_head("transformer").relation
        rel_of = [[r["relation"] for r in rels] for _, rels in relation_sets(np, n_train, seed)]
        counts = np.bincount(np.concatenate(rel_of), minlength=cfg.num_relations) + 1.0
        trainer, train = train_relation_head(
            torch, np, cfg, counts, relation_sets(np, n_train, seed), seed)
        # checkpoint round trip: the next step from a reloaded trainer
        feats, rels = next(relation_sets(np, 1, seed))
        path = os.path.join(work, "rel.pt")
        save_relation_checkpoint(path, trainer)
        loss_next = trainer.step(feats, rels)[0]
        resumed = RelationTrainer(cfg, counts, rng_seed=seed + 1)
        load_relation_checkpoint(path, resumed)
        loss_resumed = resumed.step(feats, rels)[0]
        del resumed
        train.update(next_loss=loss_next, next_loss_resumed=loss_resumed,
                     next_loss_rel_diff=abs(loss_resumed - loss_next) / abs(loss_next))
        emit({"phase": "relations", "part": "train", "config": "relation_transformer",
              "dtype": "float32", "d_model": cfg.d_model,
              "accumulation_steps": cfg.accumulation_steps, **train})
        large_cfg = relation_conv_large().relation
        large, train_large = train_relation_head(
            torch, np, large_cfg, counts,
            relation_sets(np, large_cfg.accumulation_steps, seed), seed)
        del large
        emit({"phase": "relations", "part": "train", "config": "relation_conv_large",
              "dtype": "float32", **train_large})
        for name, row in (("transformer", train), ("conv_large", train_large)):
            if not all(np.isfinite(row["losses_first_last"])):
                problems.append(f"{name}: a loss is not finite")
            if row["params_without_grad"] or row["params_unmoved"]:
                problems.append(f"{name}: parameters without a gradient "
                                f"{row['params_without_grad'][:4]} or unmoved "
                                f"{row['params_unmoved'][:4]}")
            if row["tf32_in_steps"] != [(False, False)]:
                problems.append(f"{name}: TF32 on inside a step {row['tf32_in_steps']}")
        if train["applies"] != n_train // cfg.accumulation_steps:
            problems.append(f"{train['applies']} Adam applies")
        if train["next_loss_rel_diff"] > 1e-5:
            problems.append("the resumed step's loss differs")

        # stage 5
        model = trainer.model
        items = [{"feats": f, "relations": r} for f, r in relation_sets(np, n_eval, seed)]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        proxy = evaluate(model, items, 100, anno.relations)
        proxy_s = time.perf_counter() - t0
        del items
        t0 = time.perf_counter()
        ds = PVSGRelationDataset(anno_file, "val", work, return_mask=True)
        full_items = [ds[i] for i in range(len(ds))]
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        full = evaluate_full(model, full_items, anno, data_dir, num_top_pairs=100)
        full_s = time.perf_counter() - t0
        csv_path = os.path.join(work, "metrics.csv")
        save_metrics_to_csv(full["metrics"], [proxy["pair_recall_20"]], K_VALUES,
                            csv_path, "relation_transformer")
        with open(csv_path) as f:
            csv_text = f.read()
        emit({"phase": "relations", "part": "eval", "proxy_videos": n_eval,
              "proxy_ms_per_video": proxy_s * 1e3 / n_eval, "proxy": proxy,
              "full_videos": len(full_items), "full_load_s": load_s,
              "full_ms_per_video": full_s * 1e3 / len(full_items), "full": full,
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "csv": csv_text})
        if not all(np.isfinite(v) for k in K_VALUES for v in proxy[k].values()):
            problems.append("proxy metrics not finite")
    launches = launch_counts(wrappers)
    row = {"launches": launches, "seconds": time.perf_counter() - t_phase,
           "problems": problems, "ok": not problems and not any(launches.values())}
    emit({"phase": "relations", "part": "summary", **row})
    if any(launches.values()):
        fail(f"the relation path launched a kernel of the inference path: {launches}")
    if problems:
        fail("relations: " + "; ".join(problems))
    return train, train_large


# ---------------------------------------------------------------------------
# phase 10: stage 1 through the port's CLIs
# ---------------------------------------------------------------------------

IPS_PIXEL_SHARE = 1e-3  # card float32 against CPU: share of IPS pixels that may differ


def stage1_videos(np, seed, data_dir, n_train=2, train_frames=17, n_val=1,
                  val_frames=24, H=360, W=640):
    """A PVSG-layout root with PVSG's cardinalities (115 thing and 11 stuff
    classes, 57 relations): frame PNGs and palette mask PNGs of ``n_train``
    train and ``n_val`` val videos, each with 1-20 moving rectangles of
    random classes and colours over a noise background (later ones drawn
    over earlier ones). Returns the pvsg.json path."""
    from PIL import Image

    anno = {"objects": {"thing": [f"thing{i}" for i in range(115)],
                        "stuff": [f"stuff{i}" for i in range(11)]},
            "relations": [f"rel{i}" for i in range(57)]}
    classes = anno["objects"]["thing"] + anno["objects"]["stuff"]
    data, split = [], {"train": [], "val": []}
    plan = [("train", train_frames)] * n_train + [("val", val_frames)] * n_val
    for v, (part, T) in enumerate(plan):
        vid = f"{2000 + v:04d}_stage1_{v}"
        rng = np.random.default_rng([seed, 2000 + v])
        frames = rng.integers(0, 60, (T, H, W, 3), dtype=np.uint8)
        masks = np.zeros((T, H, W), np.uint8)
        objects = []
        for oid in range(1, int(rng.integers(1, 21)) + 1):
            h, w = int(rng.integers(H // 10, H // 3)), int(rng.integers(W // 10, W // 3))
            y, x = int(rng.integers(0, H - h)), int(rng.integers(0, W - w))
            dy, dx = (float(d) for d in rng.uniform(-6.0, 6.0, 2))
            color = rng.integers(60, 256, 3, dtype=np.uint8)
            for t in range(T):
                yt = min(max(int(y + t * dy), 0), H - h)
                xt = min(max(int(x + t * dx), 0), W - w)
                masks[t, yt:yt + h, xt:xt + w] = oid
                frames[t, yt:yt + h, xt:xt + w] = color
            objects.append({"object_id": oid,
                            "category": classes[int(rng.integers(0, len(classes)))]})
        for kind, arrays in (("frames", frames), ("masks", masks)):
            out = os.path.join(data_dir, "vidor", kind, vid)
            os.makedirs(out)
            for t in range(T):
                Image.fromarray(arrays[t]).save(os.path.join(out, f"{t:04d}.png"))
        data.append({"video_id": vid, "meta": {"num_frames": T, "height": H, "width": W},
                     "objects": objects, "relations": []})
        split[part].append(vid)
    anno.update(split={"vidor": split, "epic_kitchen": {"train": [], "val": []},
                       "ego4d": {"train": [], "val": []}}, data=data)
    path = os.path.join(data_dir, "pvsg.json")
    with open(path, "w") as f:
        json.dump(anno, f)
    return path


def run_cli(name, args, timeout=600):
    """``python -m openpvsg_torch.tools.<name> args`` from the repository
    root; fails on a non-zero exit. Returns (seconds, its summary line or
    None, its standard output)."""
    from openpvsg_torch.tools.common import SUMMARY_PREFIX, parse_summary

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", f"openpvsg_torch.tools.{name}", *args],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"{name} {' '.join(args)} exited {out.returncode}: {out.stderr[-3000:]}")
    summary = parse_summary(out.stderr) if SUMMARY_PREFIX in out.stderr else None
    return seconds, summary, out.stdout


def train_rates(summary, seconds):
    """steps/s, clips/s and the loader-wait share of each epoch of a train
    CLI run (the epoch's wall time: loader waits, steps and their logs)."""
    clips = summary["global_batch"]
    rows = []
    for e in summary["epochs"]:
        busy = e["step_seconds"] + e["loader_wait_seconds"]
        rows.append({"epoch": e["epoch"], "steps": e["steps"], "seconds": e["seconds"],
                     "steps_per_s": e["steps"] / e["seconds"],
                     "clips_per_s": e["steps"] * clips / e["seconds"],
                     "loader_wait_share": e["loader_wait_seconds"] / busy,
                     "first_step_ms": e["step_seconds_each"][0] * 1e3,
                     "step_ms_median_after_first": statistics.median(
                         e["step_seconds_each"][1:] or e["step_seconds_each"]) * 1e3,
                     "host_lap_ms_median": statistics.median(
                         e["host_lap_seconds_each"]) * 1e3})
    return {"process_seconds": seconds, "start_epoch": summary["start_epoch"],
            "global_batch": clips, "steps": summary["steps"], "epochs": rows,
            "losses_first_last": [summary["losses"][0], summary["losses"][-1]],
            "losses_finite": all(math.isfinite(v) for v in summary["losses"]),
            "peak_gib": summary["peak_gib"], "launches": summary["launches"]}


def check_ips_reference(torch, np, cfg, state, frames):
    """``infer_frames_ips`` of the full-width model on 2 frames, float32, on
    the card (B1, B2) and on the CPU (plain versions): the share of pixels
    whose panoptic id differs, and the share that is not void."""
    from openpvsg_torch.infer.segmenter import SegmenterInference

    outs = {}
    for dev in ("cpu", None):
        seg = SegmenterInference(cfg, state, dtype=torch.float32, device=dev)
        outs[dev] = [o["pan_results"] for o in seg.infer_frames_ips(frames)]
        del seg
    diff = float(np.mean([np.mean(a != b) for a, b in zip(outs[None], outs["cpu"])]))
    segmented = float(np.mean([np.mean(b != cfg.num_classes) for b in outs["cpu"]]))
    return {"frames": list(frames.shape), "pixel_mismatch_share": diff,
            "non_void_share": segmented, "tol_share": IPS_PIXEL_SHARE,
            "ok": diff <= IPS_PIXEL_SHARE}


def run_stage1_cli(torch, np, seed, gen, dev, sm_clock_hz, wrappers):
    """Stage 1 through the port's CLIs at full ``mask2former_vps`` width:
    write the PVSG root, ``pack_train_cache``, ``train`` for 1 epoch from
    the PNGs, ``train --epochs 2 --auto-resume``, 1 epoch ``--packed-cache``,
    then ``test --eval PQ,VPQ`` of epoch_2 in bfloat16; the IPS path card
    against CPU in float32 on 2 val frames (the epoch_2 weights and the
    stage-2 random weights); B1 and B2 against their plain versions at the
    IPS batch's shapes. Returns B1's rows and B2's at those shapes and the
    test CLI's launch counts."""
    from openpvsg_torch.config import get_config
    from openpvsg_torch.data.pipeline import load_frame
    from openpvsg_torch.data.pvsg import frame_paths
    from openpvsg_torch.train.checkpoint import load_model_state
    from openpvsg_torch.weights import random_state_dict

    t_phase = time.perf_counter()
    problems = []
    # the in-process checks compare float32 results: TF32 off, as in phase 3
    # (the CLIs run in their own processes with torch's defaults)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "settings", "matmul_allow_tf32": False, "cudnn_allow_tf32": False})
    with tempfile.TemporaryDirectory() as tmp:
        data_dir, work = os.path.join(tmp, "data"), os.path.join(tmp, "work")
        t0 = time.perf_counter()
        anno = stage1_videos(np, seed, data_dir)
        setup_s = time.perf_counter() - t0
        common = ["--data-dir", data_dir, "--anno-file", anno, "--work-dir", work]
        train = ["--config", "mask2former_vps"] + common
        pack_s, _, _ = run_cli("pack_train_cache", train + [
            "--out", os.path.join(work, "packed")])
        runs = {}
        for name, extra in (("png", ["--epochs", "1"]),
                            ("png_resumed", ["--epochs", "2", "--auto-resume"]),
                            ("packed", ["--epochs", "1", "--work-dir",
                                        os.path.join(work, "packed_run"),
                                        "--packed-cache", os.path.join(work, "packed")])):
            seconds, summary, _ = run_cli("train", train + extra)
            runs[name] = train_rates(summary, seconds)
            emit({"phase": "stage1_cli", "part": f"train_{name}", **runs[name]})
        if runs["png_resumed"]["start_epoch"] != 1:
            problems.append("the resumed run did not start at epoch 1")
        for name, row in runs.items():
            if not row["losses_finite"]:
                problems.append(f"train {name}: a loss is not finite")
            if any(row["launches"].values()):
                problems.append(f"train {name} launched B1 or B2: {row['launches']}")
        run_dir = os.path.join(work, "mask2former_vps")
        ckpt = os.path.join(run_dir, "epoch_2")
        if not os.path.exists(ckpt):
            fail("the resumed train run wrote no epoch_2")
        # random-ish weights keep little: lower the keep thresholds, as stage 2
        keep = ["--set", "model.object_mask_thr=0.0", "model.iou_thr=0.1"]
        seconds, test, printed = run_cli("test", [
            "--config", os.path.join(run_dir, "config.json"), "--checkpoint", ckpt,
            "--eval", "PQ,VPQ", "--split", "val", "--batch-size", "8"] + common + keep)
        test_row = {"process_seconds": seconds, "dtype": test["dtype"],
                    "ips_frames": test["ips_frames"], "ips_batch": test["ips_batch"],
                    "ips_frames_per_s": test["ips_frames"] / test["ips_seconds"],
                    "vpq_frames": test["vpq_frames"],
                    "vpq_frames_per_s": test["vpq_frames"] / test["vpq_seconds"],
                    "vpq_scoring_share": test["vpq_scoring_seconds"] / test["vpq_seconds"],
                    "pq": test["pq"], "vpq": test["vpq"], "printed": printed.splitlines(),
                    "peak_gib": test["peak_gib"], "launches": test["launches"]}
        emit({"phase": "stage1_cli", "part": "test", **test_row})
        if not all(test["launches"].values()):
            problems.append(f"the test CLI did not launch every kernel: {test['launches']}")
        if not all(math.isfinite(v) for v in (test["pq"]["PQ"], test["vpq"]["VPQ"])):
            problems.append("PQ or VPQ is not finite")

        # the IPS path on the card against the CPU, float32, 2 val frames
        cfg = dataclasses.replace(get_config("mask2former_vps").model,
                                  object_mask_thr=0.0, iou_thr=0.1)
        val = frame_paths(data_dir, "2002_stage1_2", "frames")[:2]
        frames = np.stack([load_frame(p) for p in val])
        ips = {}
        for name, state in (("epoch_2", load_model_state(ckpt)),
                            ("random", random_state_dict(cfg, seed))):
            ips[name] = check_ips_reference(torch, np, cfg, state, frames)
            if not ips[name]["ok"]:
                problems.append(f"IPS pan_results on the card and the CPU differ "
                                f"({name} weights): {ips[name]}")
        emit({"phase": "stage1_cli", "part": "ips_reference", **ips})

    # B1 and B2 at the shapes the test CLI's IPS batch gives them: 8 frames
    # of 360x640, padded to 384x640, 96x160 at stride 4
    before = launch_counts(wrappers)
    fpn_rows = check_fpn(torch, gen, dev, B=8, H=96, W=160, at="stage1_ips")
    fusion_rows = check_fusion(torch, gen, dev, sm_clock_hz, N=8, h=96, w=160,
                               ori=(360, 640), inputs=("smoke",), at="stage1_ips")
    compared = launch_counts(wrappers)  # comparison launches, not the path's
    row = {"setup_s": setup_s, "pack_s": pack_s, "problems": problems,
           "comparison_launches": {k: v - before[k] for k, v in compared.items()},
           "seconds": time.perf_counter() - t_phase, "ok": not problems}
    emit({"phase": "stage1_cli", "part": "summary", **row})
    if problems:
        fail("stage1_cli: " + "; ".join(problems))
    return fpn_rows, fusion_rows["smoke"], test["launches"]


# ---------------------------------------------------------------------------
# phase 11: IPS stage 2 (segmenter, appearance encoder, tracker)
# ---------------------------------------------------------------------------

TRACK_COST_TOL = 1e-4  # reconsdot, card against CPU, absolute (costs in [0, 2])
PVSG_CLASSES = [f"thing{i}" for i in range(115)] + [f"stuff{i}" for i in range(11)]


def ips_frames(np, seed, n=64, H=360, W=640):
    """A synthetic 360x640 video: noise with 6 coloured rectangles moving
    at different speeds, one leaving the frame half way."""
    rng = np.random.default_rng([seed, 4000])
    frames = rng.integers(0, 60, (n, H, W, 3), dtype=np.uint8)
    boxes = [(int(rng.integers(0, H - 100)), int(rng.integers(0, W - 160)),
              int(rng.integers(50, 100)), int(rng.integers(60, 160)),
              *rng.uniform(-4.0, 4.0, 2)) for _ in range(6)]
    colors = rng.integers(60, 256, (6, 3), dtype=np.uint8)
    for t in range(n):
        for i, (y, x, h, w, dy, dx) in enumerate(boxes):
            if i == 5 and t >= n // 2:
                continue
            yt = min(max(int(y + t * dy), 0), H - h)
            xt = min(max(int(x + t * dx), 0), W - w)
            frames[t, yt:yt + h, xt:xt + w] = colors[i]
    return frames


def tracker_video(np, seed, start=130, n_frames=120):
    """Frames ``start`` to ``start + n_frames`` of the relations phase's
    first video (its GT label maps, the same draws), painted as frames: each
    object in a colour of its own over noise. Every object of that video is
    present from a frame before 190 for at least 190 frames, so this window
    holds most of the 20 at once (the first frames hold few). Returns
    (frames, label maps, {object id: class index})."""
    rng = np.random.default_rng([seed, 1000])
    masks, objects, _ = moving_objects(np, rng, 380, 360, 640, 20, PVSG_CLASSES)
    masks = masks[start:start + n_frames]
    paint = np.random.default_rng([seed, 3000])
    frames = paint.integers(0, 60, (*masks.shape, 3), dtype=np.uint8)
    colors = paint.integers(60, 256, (21, 3), dtype=np.uint8)
    for oid in range(1, 21):
        frames[masks == oid] = colors[oid]
    return frames, masks, {o["object_id"]: PVSG_CLASSES.index(o["category"])
                           for o in objects}


def gt_detections(np, masks_t, classes, feats, rng):
    """One frame's GT as detections: a binary mask per present object (by
    object id) and its query feature (fixed per object, plus noise)."""
    ids = [int(i) for i in np.unique(masks_t) if i]
    masks = np.stack([(masks_t == i).astype(np.uint8) for i in ids]) if ids else \
        np.zeros((0, *masks_t.shape), np.uint8)
    qf = [{"query_feat": feats[i] + 0.1 * rng.standard_normal(256).astype(np.float32),
           "cls_id": classes[i]} for i in ids]
    return ids, masks, qf


class TrackerTimer:
    """Wraps the tracker's two device calls (appearance extraction, the
    reconsdot cost) with synchronized host clocks and CUDA events, and keeps
    each cost matrix; ``restore`` puts the originals back."""

    def __init__(self, torch):
        from openpvsg_torch.tracker import matching, tracker

        self.torch, self.mods = torch, (tracker, matching)
        self.orig = (tracker.extract_object_embeddings, matching.reconsdot_distance)
        self.s = {"extract": 0.0, "reconsdot": 0.0, "reconsdot_device": 0.0}
        self.costs = []
        tracker.extract_object_embeddings = self._wrap("extract", self.orig[0])
        matching.reconsdot_distance = self._wrap("reconsdot", self.orig[1])

    def _wrap(self, name, fn):
        torch = self.torch

        def timed(*args, **kwargs):
            cuda = "cuda" in str(kwargs.get("device", "")) or any(
                isinstance(a, torch.nn.Module) and next(a.parameters()).is_cuda
                for a in args)
            if cuda:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if cuda:
                end.record()
                torch.cuda.synchronize()
                if name == "reconsdot":
                    self.s["reconsdot_device"] += start.elapsed_time(end) / 1e3
            self.s[name] += time.perf_counter() - t0
            if name == "reconsdot":
                self.costs.append(out)
            return out
        return timed

    def restore(self):
        self.mods[0].extract_object_embeddings = self.orig[0]
        self.mods[1].reconsdot_distance = self.orig[1]


def track_video(torch, np, tracker, frames, masks, classes, seed):
    """Feed the GT detections of each frame to ``tracker``; returns the
    per-frame (track ids, {track id: mask}) and the host seconds of each
    ``update``."""
    rng = np.random.default_rng([seed, 5000])
    feats = {i: rng.standard_normal(256).astype(np.float32) for i in range(1, 21)}
    out, seconds, n_dets = [], [], []
    for t in range(len(frames)):
        _, m, qf = gt_detections(np, masks[t], classes, feats, rng)
        if tracker.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        online, _ = tracker.update(frames[t], m, qf)
        seconds.append(time.perf_counter() - t0)
        out.append(([o.track_id for o in online], {o.track_id: o.mask for o in online}))
        n_dets.append(len(m))
    return out, seconds, n_dets


def run_stage2_ips(torch, np, seed, gen, dev, sm_clock_hz, wrappers):
    """IPS stage 2 at full ``mask2former_ips`` width: (a) ``run_query_tube_ips``
    on a 64-frame 360x640 video (bf16 segmenter, float32 ``imagenet50 s3``
    appearance encoder, batches of 8, two in flight) with the launch counts
    zeroed just before and read just after; (b) the tracker alone on the GT
    of the relations phase's first video (20 objects, 360x640, 120 frames):
    ms per frame split into appearance extraction, reconsdot and host, peak
    GiB, MOTA / IDF1 / HOTA against the GT; (c) the tracker on the card and
    on the CPU over the first 16 of those frames: every reconsdot matrix
    within 1e-4 and the same track ids. (a)-(c) run from torch's default
    TF32 settings (the tracker turns TF32 off for its device work); then B1
    and B2 against their plain versions at the IPS batch's shapes, TF32 off.
    Returns the path's launch counts and B1's and B2's rows."""
    from openpvsg_torch.config import TrackerConfig, mask2former_ips
    from openpvsg_torch.eval.mot_metrics import evaluate_hota, evaluate_mots
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.infer.stages import run_query_tube_ips
    from openpvsg_torch.tracker.tracker import MaskAssociationTracker
    from openpvsg_torch.weights import random_appearance_state_dict, random_state_dict

    t_phase = time.perf_counter()
    problems = []
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    emit({"phase": "settings", "matmul_allow_tf32": False, "cudnn_allow_tf32": True})
    cfg = dataclasses.replace(mask2former_ips().model, object_mask_thr=0.0, iou_thr=0.1)
    tcfg = TrackerConfig()
    app_state = random_appearance_state_dict(tcfg, seed)

    # (a) the IPS stage runner
    seg = SegmenterInference(cfg, random_state_dict(cfg, seed), dtype=torch.bfloat16)
    frames = list(ips_frames(np, seed))
    with tempfile.TemporaryDirectory() as tmp:
        run_query_tube_ips(seg, MaskAssociationTracker(tcfg, app_state), frames[:8],
                           os.path.join(tmp, "warm"))
        tracker = MaskAssociationTracker(tcfg, app_state)
        n_dets = []
        update = tracker.update
        tracker.update = lambda f, m, q, *a: (n_dets.append(len(m)), update(f, m, q, *a))[1]
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_tubes = run_query_tube_ips(seg, tracker, frames, os.path.join(tmp, "vid"),
                                     batch_size=8, pipeline_depth=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in wrappers}
        with open(os.path.join(tmp, "vid", "quantitive", "masks.txt")) as f:
            lines = f.read().splitlines()
    ips = {"frames": len(frames), "frame_hw": [360, 640], "batch": 8, "pipeline_depth": 2,
           "segmenter_dtype": "bfloat16", "appearance": "imagenet50 s3, float32",
           "seconds": wall, "frames_per_s": len(frames) / wall,
           "segments_per_frame": float(np.mean(n_dets)), "segments_max": max(n_dets),
           "tubes": n_tubes, "masks_txt_lines": len(lines),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "launches": launches}
    emit({"phase": "stage2_ips", "part": "run_query_tube_ips", **ips})
    del seg
    if not lines:
        problems.append("IPS masks.txt is empty")
    if any(v == 0 for v in launches.values()):
        problems.append(f"a kernel of the IPS path never launched: {launches}")

    # (b) the tracker alone on a PVSG-like association load
    vframes, vmasks, classes = tracker_video(np, seed)
    timer = TrackerTimer(torch)
    try:
        torch.cuda.reset_peak_memory_stats()
        tracker = MaskAssociationTracker(tcfg, app_state)
        track_video(torch, np, tracker, vframes[:4], vmasks[:4], classes, seed)  # warm-up
        timer.s = dict.fromkeys(timer.s, 0.0)
        tracker = MaskAssociationTracker(tcfg, app_state)
        out, seconds, n_dets = track_video(torch, np, tracker, vframes, vmasks, classes, seed)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        split = dict(timer.s)
    finally:
        timer.restore()
    n = len(vframes)
    total = sum(seconds)
    gt = [{int(i): (vmasks[t] == i).astype(np.uint8) for i in np.unique(vmasks[t]) if i}
          for t in range(n)]
    pred = [o[1] for o in out]
    mots, hota = evaluate_mots(gt, pred), evaluate_hota(gt, pred)
    track = {"frames": n, "frame_hw": [360, 640], "gt_objects_max": max(n_dets),
             "detections_per_frame": float(np.mean(n_dets)),
             "tracks_final": len(tracker.tracked_stracks) + len(tracker.lost_stracks),
             "ms_per_frame": total / n * 1e3,
             "extract_ms_per_frame": split["extract"] / n * 1e3,
             "reconsdot_ms_per_frame": split["reconsdot"] / n * 1e3,
             "reconsdot_device_ms_per_frame": split["reconsdot_device"] / n * 1e3,
             "host_ms_per_frame": (total - split["extract"] - split["reconsdot"]) / n * 1e3,
             "last_frame_ms": seconds[-1] * 1e3, "peak_gib": peak,
             "MOTA": mots["MOTA"], "IDF1": mots["IDF1"], "HOTA": hota["HOTA"],
             "id_switches": mots["id_switches"], "tubes": len(tracker.query_feat_tubes)}
    emit({"phase": "stage2_ips", "part": "tracker", **track})

    # (c) card against CPU on the first 16 frames
    runs = {}
    for name in ("cpu", "cuda"):
        timer = TrackerTimer(torch)
        try:
            tracker = MaskAssociationTracker(tcfg, app_state, device=name)
            out, _, _ = track_video(torch, np, tracker, vframes[:16], vmasks[:16],
                                    classes, seed)
        finally:
            timer.restore()
        runs[name] = ([o[0] for o in out], timer.costs)
    costs_cpu, costs_gpu = runs["cpu"][1], runs["cuda"][1]
    shapes_equal = [a.shape for a in costs_cpu] == [b.shape for b in costs_gpu]
    err = max((float(np.abs(a - b).max()) for a, b in zip(costs_cpu, costs_gpu) if a.size),
              default=0.0) if shapes_equal else float("inf")
    ref = {"frames": 16, "cost_matrices": len(costs_cpu),
           "cost_shapes": [list(a.shape) for a in costs_cpu],
           "reconsdot_max_abs_err": err, "tol": TRACK_COST_TOL,
           "track_ids_equal": runs["cpu"][0] == runs["cuda"][0],
           "track_ids_last": runs["cuda"][0][-1]}
    emit({"phase": "stage2_ips", "part": "tracker_reference", **ref})
    if not (ref["track_ids_equal"] and err <= TRACK_COST_TOL):
        problems.append(f"the tracker on the card and on the CPU disagree: {ref}")
    if not any(a.size for a in costs_cpu):
        problems.append("no reconsdot cost was computed in the first 16 frames")

    # B1 and B2 against their plain versions at the IPS batch's shapes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "settings", "matmul_allow_tf32": False, "cudnn_allow_tf32": False})
    fpn_rows = check_fpn(torch, gen, dev, B=8, H=96, W=160, at="stage2_ips")
    fusion_rows = check_fusion(torch, gen, dev, sm_clock_hz, N=8, h=96, w=160,
                               ori=(360, 640), inputs=("smoke",), at="stage2_ips")
    row = {"problems": problems, "seconds": time.perf_counter() - t_phase,
           "ok": not problems}
    emit({"phase": "stage2_ips", "part": "summary", **row})
    if problems:
        fail("stage2_ips: " + "; ".join(problems))
    return launches, fpn_rows, fusion_rows["smoke"]


# ---------------------------------------------------------------------------
# phase 12: the reference's Mask2Former (MSDA encoder, mmdet import, points)
# ---------------------------------------------------------------------------

REF_CHAIN_TOL = 5e-2    # B1 in bf16 against the unfused chain, of max(1, scale)
REF_ENCODER_TOL = 1e-4  # MSDA levels, card against CPU in float32, of max(1, scale)
REF_FPN32_TOL = 2e-4    # B1's float32 chain tolerance (check_fpn), of max(1, scale)


def reference_config(**kw):
    """``mask2former_vps`` with the reference's MSDA pixel encoder (6
    layers, 8 heads, 3 levels, 4 points, FFN 1024); keyword overrides of
    the model config (for serving: ``object_mask_thr`` and ``iou_thr``)."""
    from openpvsg_torch.config import mask2former_vps

    model = mask2former_vps().model
    pd = dataclasses.replace(model.pixel_decoder, encoder="msda")
    return dataclasses.replace(model, pixel_decoder=pd, **kw)


def synthetic_mmdet_sd(np, torch, seed, depth_blocks=(3, 4, 6, 3), num_classes=126,
                       Q=100, C=256, enc_layers=6, dec_layers=9, heads=8, levels=3,
                       points=4, enc_ffn=1024, dec_ffn=2048):
    """A state dict in mmdet 2.25's Mask2Former key layout (R-50 backbone,
    ``panoptic_head.pixel_decoder`` with the MSDA encoder,
    ``panoptic_head.transformer_decoder``, ``mask_embed.{0,2,4}``), float32
    tensors from the seed: weights N(0, 1/fan_in), norm scales 1, BN
    statistics near (0, 1), embeddings N(0, 1), the offsets' bias mmcv's
    directional grid plus noise (so locations fall between pixels)."""
    from openpvsg_torch.models.pixel_decoder import msda_offset_bias

    rng = np.random.default_rng(seed)
    sd = {}

    def w(k, *shape, scale=None):
        fan_in = math.prod(shape[1:])
        arr = rng.standard_normal(shape, dtype=np.float32)
        sd[k] = torch.from_numpy(arr * np.float32(scale or fan_in ** -0.5))

    def zeros(k, n):
        sd[k] = torch.zeros(n)

    def norm(prefix, n, bn=False):
        sd[f"{prefix}.weight"] = torch.ones(n)
        zeros(f"{prefix}.bias", n)
        if bn:
            sd[f"{prefix}.running_mean"] = torch.from_numpy(
                0.1 * rng.standard_normal(n, dtype=np.float32))
            sd[f"{prefix}.running_var"] = torch.from_numpy(
                1.0 + 0.1 * rng.random(n, dtype=np.float32))
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(1000)

    def linear(prefix, out_f, in_f):
        w(f"{prefix}.weight", out_f, in_f)
        zeros(f"{prefix}.bias", out_f)

    w("backbone.conv1.weight", 64, 3, 7, 7)
    norm("backbone.bn1", 64, bn=True)
    cin = 64
    for s, (blocks, planes) in enumerate(zip(depth_blocks, (64, 128, 256, 512)), start=1):
        for b in range(blocks):
            p = f"backbone.layer{s}.{b}"
            w(f"{p}.conv1.weight", planes, cin, 1, 1)
            w(f"{p}.conv2.weight", planes, planes, 3, 3)
            w(f"{p}.conv3.weight", planes * 4, planes, 1, 1)
            for i, n in ((1, planes), (2, planes), (3, planes * 4)):
                norm(f"{p}.bn{i}", n, bn=True)
            if b == 0:
                w(f"{p}.downsample.0.weight", planes * 4, cin, 1, 1)
                norm(f"{p}.downsample.1", planes * 4, bn=True)
            cin = planes * 4
    pd = "panoptic_head.pixel_decoder"
    for i, ch in enumerate((2048, 1024, 512)):
        w(f"{pd}.input_convs.{i}.conv.weight", C, ch, 1, 1)
        zeros(f"{pd}.input_convs.{i}.conv.bias", C)
        norm(f"{pd}.input_convs.{i}.gn", C)
    w(f"{pd}.level_encoding.weight", levels, C, scale=1.0)
    grid = msda_offset_bias(heads, levels, points).astype(np.float32)
    for li in range(enc_layers):
        p = f"{pd}.encoder.layers.{li}"
        a = f"{p}.attentions.0"
        w(f"{a}.sampling_offsets.weight", heads * levels * points * 2, C, scale=0.01)
        sd[f"{a}.sampling_offsets.bias"] = torch.from_numpy(
            grid + rng.uniform(-0.5, 0.5, grid.shape).astype(np.float32))
        w(f"{a}.attention_weights.weight", heads * levels * points, C, scale=0.01)
        zeros(f"{a}.attention_weights.bias", heads * levels * points)
        linear(f"{a}.value_proj", C, C)
        linear(f"{a}.output_proj", C, C)
        linear(f"{p}.ffns.0.layers.0.0", enc_ffn, C)
        linear(f"{p}.ffns.0.layers.1", C, enc_ffn)
        norm(f"{p}.norms.0", C)
        norm(f"{p}.norms.1", C)
    w(f"{pd}.lateral_convs.0.conv.weight", C, 256, 1, 1)
    zeros(f"{pd}.lateral_convs.0.conv.bias", C)
    norm(f"{pd}.lateral_convs.0.gn", C)
    w(f"{pd}.output_convs.0.conv.weight", C, C, 3, 3)
    zeros(f"{pd}.output_convs.0.conv.bias", C)
    norm(f"{pd}.output_convs.0.gn", C)
    linear(f"{pd}.mask_feature", C, C)
    sd[f"{pd}.mask_feature.weight"] = sd[f"{pd}.mask_feature.weight"][:, :, None, None]
    h = "panoptic_head"
    for name in ("query_embed", "query_feat"):
        w(f"{h}.{name}.weight", Q, C, scale=1.0)
    w(f"{h}.level_embed.weight", levels, C, scale=1.0)
    for li in range(dec_layers):
        p = f"{h}.transformer_decoder.layers.{li}"
        for a in (0, 1):
            w(f"{p}.attentions.{a}.attn.in_proj_weight", 3 * C, C)
            zeros(f"{p}.attentions.{a}.attn.in_proj_bias", 3 * C)
            linear(f"{p}.attentions.{a}.attn.out_proj", C, C)
        linear(f"{p}.ffns.0.layers.0.0", dec_ffn, C)
        linear(f"{p}.ffns.0.layers.1", C, dec_ffn)
        for n in range(3):
            norm(f"{p}.norms.{n}", C)
    norm(f"{h}.transformer_decoder.post_norm", C)
    linear(f"{h}.cls_embed", num_classes + 1, C)
    for j in (0, 2, 4):
        linear(f"{h}.mask_embed.{j}", C, C)
    return sd


def profiled(torch, fn):
    """Run ``fn`` once under ``torch.profiler``, synchronized: (wall s,
    device busy ms (the summed kernel time of one stream), idle share)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.device_time_total for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall, busy_us / 1e3, 1.0 - busy_us / 1e6 / wall


def run_reference_model(torch, np, seed, wrappers, dense_train):
    """The reference's Mask2Former at full width: (a) a synthetic mmdet
    state dict written as a .pth, read by ``load_mmdet_checkpoint`` and
    converted; (b) VPS stage 2 with those weights in bf16 (launch counts
    zeroed just before, read just after; the MSDA and axial encoders timed
    alone at a window's shapes; B1 and B2 in the model against their plain
    versions); (c) the MSDA pixel decoder in float32 on the card against
    the CPU; (d) 4 training steps with points and the thing/stuff split,
    float32, beside ``dense_train`` (phase ``train``'s row). Returns (b)'s
    launch counts."""
    from openpvsg_torch.config import mask2former_vps
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.infer.stages import run_query_tube_vps
    from openpvsg_torch.kernels import fpn, fusion
    from openpvsg_torch.models.axial_encoder import AxialPixelEncoder
    from openpvsg_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
    from openpvsg_torch.train.checkpoint import (convert_mmdet_mask2former,
                                                 load_mmdet_checkpoint)
    from openpvsg_torch.train.segmenter import SegmenterTrainer

    t_phase = time.perf_counter()
    problems = []
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    emit({"phase": "settings", "matmul_allow_tf32": False, "cudnn_allow_tf32": True})
    cfg = reference_config(object_mask_thr=0.0, iou_thr=0.1)

    # (a) import
    sd = synthetic_mmdet_sd(np, torch, seed)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mask2former_r50_msda.pth")
        torch.save({"meta": {"mmdet_version": "2.25.0", "epoch": 8}, "state_dict": sd}, path)
        t0 = time.perf_counter()
        loaded = load_mmdet_checkpoint(path)
        load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = convert_mmdet_mask2former(loaded, cfg)
    convert_s = time.perf_counter() - t0
    seg = SegmenterInference(cfg, state, dtype=torch.bfloat16)  # load_state_dict(strict=True)
    n_params = sum(t.numel() for k, t in state.items() if not k.endswith(("running_mean",
                                                                           "running_var")))
    emit({"phase": "reference_model", "part": "import", "mmdet_keys": len(sd),
          "port_keys": len(state), "params": n_params, "load_pth_s": load_s,
          "convert_s": convert_s, "strict": True})
    del sd, loaded

    # (b) serving
    n_frames = 16
    frames = list(synthetic_frames(np, n_frames, 360, 480, seed))
    with tempfile.TemporaryDirectory() as tmp:
        run_query_tube_vps(seg, frames[:4], os.path.join(tmp, "warm"), window=2)
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_tubes = run_query_tube_vps(seg, frames, os.path.join(tmp, "vid"), window=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(os.path.join(tmp, "vid", "quantitive", "masks.txt")) as f:
            lines = f.read().splitlines()
    # one window's tensors: encoders timed alone, B1 and B2 against plain
    model = seg.model
    x = torch.from_numpy(np.stack(frames[:2])).cuda()
    mean, std = seg._norm[0]
    x = (x.float() - mean) / std
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 24)).to(torch.bfloat16)
    pdec = model.pixel_decoder
    with torch.no_grad():
        feats = model.backbone(x)
        projs = [getattr(pdec, f"input_conv_{i}")(feats[3 - i]) for i in range(3)]
        axial = AxialPixelEncoder(mask2former_vps().model.pixel_decoder).cuda().to(
            torch.bfloat16).eval()
        # device ms from the profiler (the summed kernel time of one call);
        # CUDA events around one call on an idle device include the host's
        # launches, which a queue of back-to-back calls cannot hide here:
        # CUDA's launch queue fills before the device drains it
        encoders = {}
        for name, fn in (("msda", lambda: pdec._msda_encoder(projs)),
                         ("axial", lambda: axial(projs))):
            fn()
            wall_s, busy_ms, _ = profiled(torch, fn)
            encoders[name] = {"device_ms": busy_ms, "call_ms": call_ms(torch, fn, reps=5)}
        outs = pdec._msda_encoder(projs)
        chain = fpn.fpn_stride4(feats[0], outs[-1], pdec.fpn_params(), num_groups=32,
                                eps=1e-6)
        chain_ref = fpn.fpn_stride4_plain(feats[0], outs[-1], pdec.fpn_params(),
                                          num_groups=32, eps=1e-6)
        cls, low, _ = seg.forward_frames(np.stack(frames[:2]))
        probs = torch.softmax(cls.float(), -1)
        keep = (probs.argmax(-1) != cfg.num_classes) & (probs.amax(-1) > cfg.object_mask_thr)
        scores = torch.where(keep, probs.amax(-1), torch.full_like(probs[..., 0], float("-inf")))
        got = fusion.fusion_maps(low.float().contiguous(), scores, (384, 480), (360, 480))
        ref = fusion.fusion_maps_plain(low.float().contiguous(), scores, (360, 480))
    chain_scale = max(1.0, float(chain_ref.float().abs().max()))
    chain_err = max_abs(chain, chain_ref)
    fusion_mismatch = sum(int((a != b).sum()) for a, b in zip(got, ref))
    row_b = {"frames": n_frames, "frame_hw": [360, 480], "window": 2, "dtype": "bfloat16",
             "seconds": wall, "frames_per_s": n_frames / wall, "tubes": n_tubes,
             "masks_txt_lines": len(lines), "peak_gib": peak, "launches": launches,
             "msda_encoder_device_ms_per_window": encoders["msda"]["device_ms"],
             "msda_encoder_call_ms_per_window": encoders["msda"]["call_ms"],
             "axial_encoder_device_ms_per_window": encoders["axial"]["device_ms"],
             "axial_encoder_call_ms_per_window": encoders["axial"]["call_ms"],
             "encoder_levels": [list(p.shape[1:3]) for p in projs],
             "b1_in_model_max_abs_err": chain_err,
             "b1_in_model_tol": REF_CHAIN_TOL * chain_scale,
             "b2_in_model_mismatches": fusion_mismatch}
    emit({"phase": "reference_model", "part": "serving", **row_b})
    if not lines:
        problems.append("masks.txt is empty")
    if any(v == 0 for v in launches.values()):
        problems.append(f"a kernel of the MSDA serving path never launched: {launches}")
    if chain_err > REF_CHAIN_TOL * chain_scale:
        problems.append(f"B1 on the MSDA output disagrees with its plain version: {chain_err}")
    if fusion_mismatch:
        problems.append(f"B2 on the model's logits disagrees with its plain version: "
                        f"{fusion_mismatch}")
    del seg, model, pdec, axial, feats, projs, outs, x

    # (c) the MSDA pixel decoder, float32, card against CPU (TF32 off)
    torch.backends.cudnn.allow_tf32 = False
    pd_state = {k[len("pixel_decoder."):]: v for k, v in state.items()
                if k.startswith("pixel_decoder.")}
    gen = torch.Generator().manual_seed(seed)
    small = [torch.randn((1, 64 // s, 96 // s, c), generator=gen)
             for s, c in zip((4, 8, 16, 32), (256, 512, 1024, 2048))]
    outs = {}
    for dev in ("cpu", "cuda"):
        dec = MSDeformAttnPixelDecoder(cfg.pixel_decoder)
        dec.load_state_dict(pd_state, strict=True)
        dec = dec.to(dev).eval()
        with torch.no_grad():
            mf, levels = dec([f.to(dev) for f in small])
        outs[dev] = [t.float().cpu() for t in (*levels, mf)]
    errs = [max_abs(a, b) for a, b in zip(outs["cuda"], outs["cpu"])]
    scales = [max(1.0, float(b.abs().max())) for b in outs["cpu"]]
    row_c = {"input": [1, 64, 96], "dtype": "float32",
             "levels_max_abs_err": errs[:3], "mask_feature_max_abs_err": errs[3],
             "scales": scales}
    row_c["ok"] = (all(e <= REF_ENCODER_TOL * s for e, s in zip(errs[:3], scales[:3]))
                   and errs[3] <= REF_FPN32_TOL * scales[3])
    emit({"phase": "reference_model", "part": "card_vs_cpu", **row_c})
    if not row_c["ok"]:
        problems.append(f"the MSDA pixel decoder on the card disagrees with the CPU: {row_c}")
    torch.backends.cudnn.allow_tf32 = True
    del state, pd_state

    # (d) training: points, split, float32
    pvsg = mask2former_vps()
    tcfg = pvsg.train
    tr_cfg = reference_config(loss_sampling="points", split_thing_stuff=True)
    clips = tcfg.samples_per_gpu
    batch = train_batch(np, clips, tr_cfg.num_frames, (360, 480), (384, 480), 20,
                        tr_cfg.num_classes, seed)
    before = launch_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    trainer = SegmenterTrainer(tr_cfg, tcfg, steps_per_epoch=1000, seed=seed)
    losses, step_ms, lap_ms = [], [], []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = trainer.step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(logs["loss"])
        lap_ms.append(trainer.last_timings["host_lap_s"] * 1e3)
    wall, busy_ms, idle = profiled(torch, lambda: trainer.step(batch))
    peak_train = torch.cuda.max_memory_allocated() / 2 ** 30
    during = {k: v - before[k] for k, v in launch_counts(wrappers).items()}
    med = statistics.median(step_ms[1:])
    stuff_q = trainer.last_assigned[..., -tr_cfg.num_stuff_classes:]
    row_d = {"config": "mask2former_vps + msda, points, split_thing_stuff",
             "dtype": "float32", "clips": clips, "frames_per_clip": tr_cfg.num_frames,
             "padded_hw": [384, 480], "num_points": tr_cfg.num_points,
             "oversample_ratio": tr_cfg.oversample_ratio,
             "importance_sample_ratio": tr_cfg.importance_sample_ratio,
             "steps": 4, "losses": losses, "step_ms": step_ms,
             "step_ms_median_2_4": med,
             "host_lap_share": statistics.median(lap_ms[1:]) / med,
             "profiled_step_ms": wall * 1e3, "device_busy_ms": busy_ms,
             "device_idle_share": idle, "peak_gib": peak_train,
             "frames_per_s": clips * tr_cfg.num_frames / (med / 1e3),
             "stuff_queries_assigned": int((stuff_q >= 0).sum()),
             "launches": during,
             "dense_axial_step_ms_median": dense_train["step_ms_median_2_6"],
             "dense_axial_host_lap_share": dense_train["host_lap_share"],
             "dense_axial_peak_gib": dense_train["peak_gib"]}
    emit({"phase": "reference_model", "part": "train", **row_d})
    if not all(np.isfinite(losses)):
        problems.append(f"a points-mode loss is not finite: {losses}")
    if any(during.values()):
        problems.append(f"points-mode training launched a kernel: {during}")
    del trainer
    seconds = time.perf_counter() - t_phase
    emit({"phase": "reference_model", "ok": not problems, "seconds": seconds})
    if problems:
        fail("reference_model: " + "; ".join(problems))
    return launches


# ---------------------------------------------------------------------------
# phase 13: the Swin-T segmenter and the trainer's options
# ---------------------------------------------------------------------------

SWIN_FRAMES = 16
SWIN_TRAIN_CLIPS = 16  # as phase train's mask2former_vps batch
# card against CPU, tiny model, one step per option: loss (relative) and
# gradients (of each tensor's scale), as train_reference bounds them; with
# bfloat16 mask logits a rounding that flips on one side moves an element by
# one bfloat16 step (2^-8 relative)
OPTION_BOUNDS = {"float32": (1e-3, 1e-2), "bfloat16": (1e-2, 5e-2)}
TRAIN_OPTIONS = {
    "lapjv": dict(assigner="lapjv"),
    "greedy": dict(assigner="greedy"),
    "match_downsample": dict(match_downsample=2),
    "target_layout": dict(loss_layout="target"),
    "focal": dict(focal_cls=True, focal_gamma=1.5, focal_alpha=0.3),
    "sem_seg": dict(with_sem_seg=True, sem_seg_weight=0.7),
    "bf16_mask_logits": dict(mask_logits_dtype="bfloat16"),
}


def swin_config(**kw):
    """``mask2former_swin_vps``'s model config with keyword overrides."""
    from openpvsg_torch.config import mask2former_swin

    return dataclasses.replace(mask2former_swin(True).model, **kw)


def run_train_bf16_variants(torch, np, seed, steps=3):
    """Phase 7's bfloat16 steps of the other two models at full width and
    batch: the reference's MSDA model with the points objective and the
    split, and Swin-T (dense): losses (finite), median step ms of steps
    2-3, frames/s, peak GiB."""
    from openpvsg_torch.config import mask2former_vps
    from openpvsg_torch.train.segmenter import SegmenterTrainer

    tcfg = mask2former_vps().train
    for name, base in (("msda_points_split", reference_config(
            loss_sampling="points", split_thing_stuff=True)), ("swin", swin_config())):
        t_phase = time.perf_counter()
        cfg = dataclasses.replace(base, backbone=dataclasses.replace(
            base.backbone, dtype="bfloat16"))
        clips = tcfg.samples_per_gpu
        batch = train_batch(np, clips, cfg.num_frames, (360, 480), (384, 480), 20,
                            cfg.num_classes, seed)
        torch.cuda.reset_peak_memory_stats()
        trainer = SegmenterTrainer(cfg, tcfg, steps_per_epoch=1000, seed=seed)
        losses, step_ms = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.step(batch)["loss"])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(step_ms[1:])
        row = {"config": name, "dtype": "bfloat16", "clips": clips,
               "frames_per_clip": cfg.num_frames, "padded_hw": [384, 480],
               "losses": losses, "step_ms": step_ms, "step_ms_median_2_3": med,
               "frames_per_s": clips * cfg.num_frames / (med / 1e3),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "ok": bool(np.all(np.isfinite(losses))),
               "seconds": time.perf_counter() - t_phase}
        del trainer
        emit({"phase": "train_bf16", **row})
        if not row["ok"]:
            fail(f"train_bf16 {name}: a loss is not finite")


def check_train_options(torch, np, seed):
    """One step of the tests' small model per trainer option, on the card
    and on the CPU from the same state dict and batch: loss, assignment and
    gradients. Returns the rows."""
    from openpvsg_torch.config import TrainConfig
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import random_state_dict

    batch = train_batch(np, 2, 2, (64, 64), (64, 64), 3, 5, seed)
    batch["gt_semantic"] = np.random.default_rng(seed).integers(0, 6, (2, 2, 16, 16))
    rows = {}
    for name, kw in TRAIN_OPTIONS.items():
        cfg = dataclasses.replace(tiny_train_config(), **kw)
        state = random_state_dict(cfg, seed)
        out = {}
        for dev in ("cpu", None):
            tr = SegmenterTrainer(cfg, TrainConfig(), steps_per_epoch=10, device=dev,
                                  state_dict=state)
            loss, logs = tr.loss_and_grads(batch)
            out[dev] = (float(loss.detach()), tr.last_assigned,
                        {n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()})
        loss_rel = abs(out[None][0] - out["cpu"][0]) / abs(out["cpu"][0])
        grad_rel, grad_at = grad_rel_diff(out[None][2], out["cpu"][2])
        loss_bound, grad_bound = OPTION_BOUNDS[
            "bfloat16" if cfg.mask_logits_dtype == "bfloat16" else "float32"]
        same = bool(np.array_equal(out[None][1], out["cpu"][1]))
        rows[name] = {"loss_gpu": out[None][0], "loss_cpu": out["cpu"][0],
                      "loss_rel_diff": loss_rel, "assignments_equal": same,
                      "max_grad_rel_diff": grad_rel, "max_grad_rel_diff_at": grad_at,
                      "bounds": [loss_bound, grad_bound],
                      "sem_seg_loss": "loss_sem_seg" in logs,
                      "ok": (np.isfinite(out[None][0]) and same and loss_rel <= loss_bound
                             and grad_rel <= grad_bound)}
    return rows


def lapjv_against_host(torch, np, trainer, batch):
    """The costs of one full-width step (the trainer's model, its batch),
    solved by the host Hungarian (copy + C++ LAP) and by LAPJV and greedy on
    the card: each one's ms (synchronized), and whether LAPJV's assignment
    equals the host's."""
    from openpvsg_torch.train.assign import (assignment_costs, device_assign,
                                             lap_assign, lapjv_assign_from_cost)
    from openpvsg_torch.train.segmenter import ieee_float32

    cfg = trainer.cfg
    with torch.no_grad(), ieee_float32():
        images, labels, masks, valid = trainer.device_batch(batch)
        cls, mp, _ = trainer.model(images)
        costs = assignment_costs(cls, mp, labels, masks, valid, cfg.loss_cls_weight,
                                 cfg.loss_mask_weight, cfg.loss_dice_weight)
    del mp
    torch.cuda.synchronize()
    out = {}
    for name in ("hungarian", "lapjv", "greedy", "lapjv_again"):
        t0 = time.perf_counter()
        if name == "hungarian":
            a = lap_assign(costs.cpu().numpy())
        else:
            a = device_assign(costs, name.split("_")[0]).cpu().numpy()
        out[name] = ((time.perf_counter() - t0) * 1e3, a)
    host = out["hungarian"][1]
    stats = {}
    lapjv_assign_from_cost(costs.reshape(-1, *costs.shape[2:]), stats=stats)
    objective = {}
    c = costs.cpu().numpy()
    for name, (_, a) in out.items():
        q = np.nonzero(a >= 0)
        objective[name] = float(c[(*q, a[q])].astype(np.float64).sum())
    return {"problems": list(costs.shape[:2]), "queries": costs.shape[2],
            "targets": costs.shape[3],
            "host_lap_ms": out["hungarian"][0], "lapjv_ms": out["lapjv"][0],
            "lapjv_again_ms": out["lapjv_again"][0], "greedy_ms": out["greedy"][0],
            "lapjv_host_checks": stats["host_checks"],
            "lapjv_lockstep_iterations": stats["iterations"],
            "lapjv_equals_host": bool(np.array_equal(out["lapjv"][1], host)),
            "greedy_equals_host": bool(np.array_equal(out["greedy"][1], host)),
            "objective": objective}


def run_swin(torch, np, seed, gen, dev, wrappers):
    """The Swin-T segmenter (``mask2former_swin_vps``) at full width:
    (a) B1 at Swin-T's stride-4 width (Cin 96) against its plain versions;
    (b) the model on the card against the CPU; (c) VPS stage 2 with launch
    counts zeroed just before and read just after; (d) training: full-width
    steps, LAPJV on the card against the host Hungarian on one step's costs
    and step ms with each, and one step of the small model per trainer
    option, card against CPU. Returns ((a)'s rows, (c)'s launches)."""
    from openpvsg_torch.config import mask2former_swin
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.infer.stages import run_query_tube_vps
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import random_state_dict

    t_phase = time.perf_counter()
    problems = []
    # (a) and (b): float32 parity, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "settings", "matmul_allow_tf32": False, "cudnn_allow_tf32": False})
    fpn_rows = check_fpn(torch, gen, dev, B=2, H=96, W=120, at="swin", Cin=96)
    cfg = swin_config(object_mask_thr=0.0, iou_thr=0.1)
    state = random_state_dict(cfg, seed)
    check_reference(torch, np, cfg, state, seed, phase="swin")

    # (c) stage 2, bf16
    seg = SegmenterInference(cfg, state, dtype=torch.bfloat16)
    frames = list(synthetic_frames(np, SWIN_FRAMES, 360, 480, seed))
    with tempfile.TemporaryDirectory() as tmp:
        run_query_tube_vps(seg, frames[:4], os.path.join(tmp, "warm"), window=2)
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_tubes = run_query_tube_vps(seg, frames, os.path.join(tmp, "vid"), window=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        run_query_tube_vps(seg, frames, os.path.join(tmp, "again"), window=2)
        torch.cuda.synchronize()
        wall_again = time.perf_counter() - t0
        masks = [open(os.path.join(tmp, run, "quantitive", "masks.txt"), "rb").read()
                 for run in ("vid", "again")]
    lines = masks[0].decode().splitlines()
    row_c = {"config": "mask2former_swin_vps", "params": sum(
                 t.numel() for t in state.values()),
             "frames": SWIN_FRAMES, "frame_hw": [360, 480], "window": 2,
             "dtype": "bfloat16", "seconds": wall, "frames_per_s": SWIN_FRAMES / wall,
             "frames_per_s_rerun": SWIN_FRAMES / wall_again, "tubes": n_tubes,
             "masks_txt_lines": len(lines), "peak_gib": peak,
             "masks_txt_identical_on_rerun": masks[0] == masks[1],
             "launches": launches}
    emit({"phase": "swin", "part": "stage2", **row_c})
    if not lines:
        problems.append("Swin stage 2 wrote an empty masks.txt")
    if any(v == 0 for v in launches.values()):
        problems.append(f"a kernel of the Swin serving path never launched: {launches}")
    del seg

    # (d) training from torch's default TF32 settings; no kernel may launch
    torch.backends.cudnn.allow_tf32 = True
    emit({"phase": "settings", "matmul_allow_tf32": False, "cudnn_allow_tf32": True})
    before = launch_counts(wrappers)
    pvsg = mask2former_swin(True)
    tr_cfg, tcfg = pvsg.model, pvsg.train
    clips = SWIN_TRAIN_CLIPS
    batch = train_batch(np, clips, tr_cfg.num_frames, (360, 480), (384, 480), 20,
                        tr_cfg.num_classes, seed)
    torch.cuda.reset_peak_memory_stats()
    trainer = SegmenterTrainer(tr_cfg, tcfg, steps_per_epoch=1000, seed=seed)
    losses, step_ms, lap_ms = [], [], []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = trainer.step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(logs["loss"])
        lap_ms.append(trainer.last_timings["host_lap_s"] * 1e3)
    peak_train = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(step_ms[1:])
    lap = lapjv_against_host(torch, np, trainer, batch)
    # step ms with LAPJV on the card: a second trainer from the same seed
    del trainer
    lap_trainer = SegmenterTrainer(dataclasses.replace(tr_cfg, assigner="lapjv"), tcfg,
                                   steps_per_epoch=1000, seed=seed)
    lap_step_ms, lap_losses, assign_ms = [], [], []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = lap_trainer.step(batch)
        torch.cuda.synchronize()
        lap_step_ms.append((time.perf_counter() - t0) * 1e3)
        lap_losses.append(logs["loss"])
        assign_ms.append(lap_trainer.last_timings["device_assign_s"] * 1e3)
    del lap_trainer
    lap_med = statistics.median(lap_step_ms[1:])
    row_d = {"config": "mask2former_swin_vps", "dtype": "float32", "clips": clips,
             "frames_per_clip": tr_cfg.num_frames,
             "padded_hw": [384, 480], "steps": 4, "losses": losses, "step_ms": step_ms,
             "step_ms_median_2_4": med, "host_lap_ms_median_2_4": statistics.median(lap_ms[1:]),
             "host_lap_share": statistics.median(lap_ms[1:]) / med,
             "frames_per_s": clips * tr_cfg.num_frames / (med / 1e3), "peak_gib": peak_train,
             "lapjv_step_ms": lap_step_ms, "lapjv_step_ms_median_2_4": lap_med,
             "lapjv_device_assign_ms_median_2_4": statistics.median(assign_ms[1:]),
             "lapjv_losses": lap_losses,
             "same_costs": lap}
    emit({"phase": "swin", "part": "train", **row_d})
    if not (all(np.isfinite(losses)) and all(np.isfinite(lap_losses))):
        problems.append(f"a Swin training loss is not finite: {losses} {lap_losses}")
    if not lap["lapjv_equals_host"]:
        problems.append("LAPJV on the card disagrees with the host Hungarian")
    options = check_train_options(torch, np, seed)
    for name, row in options.items():
        emit({"phase": "swin", "part": "train_option", "option": name, **row})
        if not row["ok"]:
            problems.append(f"option {name}: card and CPU disagree: {row}")
    during = {k: v - before[k] for k, v in launch_counts(wrappers).items()}
    emit({"phase": "swin", "part": "train_launches", "launches": during})
    if any(during.values()):
        problems.append(f"training launched a kernel of the inference path: {during}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "swin", "ok": not problems, "seconds": seconds})
    if problems:
        fail("swin: " + "; ".join(problems))
    return fpn_rows, launches


# ---------------------------------------------------------------------------
# phase 14: stages 3-5 and end2end through the CLIs, and the streaming engine
# ---------------------------------------------------------------------------

STREAM_RANK_TOL = 1e-4  # triplets closer than this in probability may swap


def reference_relation_bundle(torch, seed, model_name="transformer", d=256, heads=8,
                              ffn=512, temporal_heads=4, temporal_ffn=512,
                              num_relations=57):
    """The reference's four relation models (its rel_train's ``.pth``
    bundle, tests/test_convert.py:70) at the ``relation_head(model_name)``
    widths, random from the seed: torch encoder layers, the pair MLP, and
    the temporal transformer or, for ``conv``, one Conv1d(2d, 2d, 5) + ReLU.
    tests/test_torch_e2e.py builds its bundles with this function too."""
    nn = torch.nn
    with torch.random.fork_rng():
        torch.manual_seed(seed)

        def encoder(dim, h, f, layers):
            m = nn.Module()
            m.transformer_encoder = nn.TransformerEncoder(
                nn.TransformerEncoderLayer(dim, h, f, dropout=0.0), layers,
                enable_nested_tensor=False)
            return m

        sub, obj = encoder(d, heads, ffn, 2), encoder(d, heads, ffn, 2)
        pair = nn.Module()
        pair.pair_ffn = nn.Sequential(nn.Linear(2 * d, 1024), nn.ReLU(), nn.Linear(1024, 1))
        if model_name == "transformer":
            rel = encoder(2 * d, temporal_heads, temporal_ffn, 1)
            rel.layer_norm = nn.LayerNorm(2 * d)
        else:
            rel = nn.Module()
            rel.conv_layers = nn.Sequential(nn.Conv1d(2 * d, 2 * d, 5, padding=2), nn.ReLU())
        rel.fc1, rel.fc2 = nn.Linear(2 * d, d), nn.Linear(d, d // 2)
        rel.span_head = nn.Linear(d // 2, num_relations)
        rel.pred_head = nn.Linear(d // 2, num_relations)
    return {"subject_encoder": sub.state_dict(), "object_encoder": obj.state_dict(),
            "pair_proposal_model": pair.state_dict(), "relation_model": rel.state_dict()}


def eval_row(seconds, summary, printed):
    row = {"process_seconds": seconds, "videos": summary["videos"],
           "eval_seconds": summary["seconds"],
           "printed": [ln for ln in printed.splitlines() if "Recall" in ln],
           "launches": summary["launches"]}
    for key in ("pair_recall_20", "metrics", "soft_metrics"):
        if key in summary:
            row[key] = summary[key]
    return row


def run_rel_clis(np, torch, seed, tmp, problems):
    """(a): the rich synthetic root with oracle stage 2, ``prepare_rel_set
    --jobs 4`` on both splits, ``rel_train --epochs 1``, then ``rel_test``
    and ``rel_test_full`` on its epoch_1 and on a reference bundle. Returns
    the root's paths, the epoch_1 checkpoint and the launch counts of every
    CLI."""
    data, work = os.path.join(tmp, "data"), os.path.join(tmp, "work")
    anno = os.path.join(data, "pvsg.json")
    gen_s, _, _ = run_cli("make_synthetic_data", [
        "--out", data, "--style", "rich", "--train-videos", "4", "--val-videos", "2",
        "--frames", "120", "--size", "360", "640", "--oracle-stage2", work,
        "--seed", str(seed)])
    with open(anno) as f:
        meta = json.load(f)
    emit({"phase": "end2end", "part": "data", "seconds": gen_s,
          "videos": {d["video_id"]: {"objects": len(d["objects"]),
                                     "relations": len(d["relations"])} for d in meta["data"]},
          "classes": len(meta["objects"]["thing"]) + len(meta["objects"]["stuff"]),
          "relations": len(meta["relations"])})
    common = ["--config", "relation_transformer", "--data-dir", data, "--anno-file", anno,
              "--work-dir", work]
    launches = {}
    for split in ("train", "val"):
        seconds, s, _ = run_cli("prepare_rel_set", common + ["--split", split, "--jobs", "4"])
        row = {"process_seconds": seconds, **s, "videos_per_s": s["videos"] / s["seconds"]}
        emit({"phase": "end2end", "part": f"prepare_rel_set_{split}", **row})
        launches[f"prepare_rel_set_{split}"] = s["launches"]
        if s["failed"] or s["written"] != s["videos"] or not s["videos"]:
            problems.append(f"prepare_rel_set {split}: {s['written']} of {s['videos']} "
                            f"videos wrote relations.pickle, failed {s['failed']}")
    seconds, tr, _ = run_cli("rel_train", common + ["--epochs", "1", "--ps-type", "vps"])
    steps_ms = [t * 1e3 for t in tr["step_seconds_each"]]
    row = {"process_seconds": seconds, "videos": tr["videos"], "steps": tr["steps"],
           "order": tr["order"], "step_ms": steps_ms,
           "step_ms_median": statistics.median(steps_ms),
           "videos_per_s": tr["steps"] / sum(tr["step_seconds_each"]),
           "losses": tr["losses"], "losses_finite": all(map(math.isfinite, tr["losses"])),
           "eval_seconds": tr["eval_seconds"], "pair_recall_20": tr["pair_recall_20"],
           "metrics": tr["metrics"], "peak_gib": tr["peak_gib"], "launches": tr["launches"]}
    emit({"phase": "end2end", "part": "rel_train", **row})
    launches["rel_train"] = tr["launches"]
    if not row["losses_finite"] or not tr["losses"]:
        problems.append(f"rel_train: a loss is not finite: {tr['losses']}")
    ckpt = tr["checkpoints"][-1]
    bundle = os.path.join(tmp, "relation_bundle.pth")
    torch.save(reference_relation_bundle(torch, seed), bundle)
    for weights, path in (("epoch_1", ckpt), ("bundle", bundle)):
        for tool in ("rel_test", "rel_test_full"):
            seconds, s, printed = run_cli(tool, common + ["--checkpoint", path, "--split", "val"])
            emit({"phase": "end2end", "part": f"{tool}_{weights}",
                  **eval_row(seconds, s, printed)})
            launches[f"{tool}_{weights}"] = s["launches"]
    return data, anno, ckpt, launches


def run_end2end_clis(tmp, data, anno, ckpt, problems):
    """(b): ``end2end_inference --eval`` on the val videos, VPS (window 2)
    then IPS (batches of 8, the ``imagenet50 s3`` encoder in float32), with
    the relation head rel_train wrote. Returns each run's launch counts."""
    launches = {}
    for ps, config in (("vps", "mask2former_vps"), ("ips", "mask2former_ips")):
        out_dir = os.path.join(tmp, f"end2end_{ps}")
        seconds, s, _ = run_cli("end2end_inference", [
            "--config", config, "--ps-type", ps, "--data-dir", data, "--anno-file", anno,
            "--split", "val", "--out-dir", out_dir, "--relation-checkpoint", ckpt,
            "--eval",
            "--set", "model.object_mask_thr=0.0", "model.iou_thr=0.1"])
        videos = s["per_video"]
        frames = sum(v["frames"] for v in videos)
        seg_s = sum(v["segment_seconds"] for v in videos)
        rel_s = sum(v.get("relation_seconds", 0.0) for v in videos)
        row = {"process_seconds": seconds, "dtype": s["dtype"], "frames": frames,
               "frames_per_s": frames / (seg_s + rel_s), "segment_seconds": seg_s,
               "relation_seconds": rel_s, "relation_share": rel_s / (seg_s + rel_s),
               "per_video": videos, "protocol": s.get("protocol"),
               "peak_gib": s["peak_gib"], "launches": s["launches"]}
        emit({"phase": "end2end", "part": f"end2end_{ps}", **row})
        launches[ps] = s["launches"]
        if not all(s["launches"].values()):
            problems.append(f"end2end {ps} did not launch every kernel: {s['launches']}")
        for v in videos:
            root = os.path.join(out_dir, v["vid"])
            if not os.path.exists(os.path.join(root, "triplets.json")):
                problems.append(f"end2end {ps}: {v['vid']} wrote no triplets.json")
            if (os.path.exists(os.path.join(root, "relations.pickle"))
                    and not os.path.exists(os.path.join(out_dir, "protocol_metrics.json"))):
                problems.append(f"end2end {ps}: relations.pickle but no protocol_metrics.json")
    return launches


def stream_frames(np, n, seed, h=360, w=480):
    """Noise frames with blocks that cross the frame (wrapping), one of
    them only in the first half: tubes appear, persist and age out."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (n, h, w, 3), dtype=np.uint8)
    for t in range(n):
        x = (40 + 6 * t) % (w - 120)
        frames[t, 60:180, x:x + 120] = (250, 30, 30)
        if t < n // 2:
            y = (200 + 2 * t) % (h - 160)
            frames[t, y:y + 60, 300:380] = (30, 30, 250)
        frames[t, 300:] = (30, 250, 30)
    return frames


def run_streaming(torch, np, seed, wrappers, problems, n_frames=128):
    """(c): ``StreamingPVSG`` on ``n_frames`` 360x480 frames pushed one at
    a time (window 2, relation_interval 16, num_top_pairs 20, max_history
    64) with the device ring, then the host backend on the same stream.
    Returns the device run's launch counts."""
    from openpvsg_torch.config import relation_head
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.infer.streaming import StreamingPVSG, triplets_agree
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.weights import random_relation_state_dict, random_state_dict

    cfg = stage2_config()
    seg = SegmenterInference(cfg, random_state_dict(cfg, seed), dtype=torch.bfloat16)
    rel_cfg = relation_head("transformer").relation
    rel = RelationModel.from_config(rel_cfg)
    rel.load_state_dict(random_relation_state_dict(rel_cfg, seed))
    frames = stream_frames(np, n_frames, seed)
    kw = dict(window=2, relation_interval=16, num_top_pairs=20, max_history=64)
    for f in frames[:4]:  # warm-up: the first forward builds the kernels' plans
        seg.infer_window_vps(np.stack([f, f]))
    runs = {}
    for backend, device_history in (("device", True), ("host", False)):
        engine = StreamingPVSG(seg, rel, device_history=device_history, **kw)
        score_ms = []
        score = engine._score_relations

        def timed_score():
            t0 = time.perf_counter()
            out = score()
            score_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        engine._score_relations = timed_score
        windows = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers:
            fn.launches = 0
        t_run = time.perf_counter()
        for f in frames:
            t0 = time.perf_counter()
            r = engine.push(f)
            if r is not None:
                windows.append({"ms": (time.perf_counter() - t0) * 1e3, "out": r,
                                "scores": engine.last_scores if r["triplets"] is not None
                                else None})
        final = engine.finish()
        final_scores = engine.last_scores
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = launch_counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = [w["ms"] for w in windows]
        plain = [w["ms"] for w in windows if w["out"]["triplets"] is None]
        row = {"backend": backend, "frames": n_frames, "frame_hw": [360, 480], **kw,
               "dtype": "bfloat16", "seconds": wall, "frames_per_s": n_frames / wall,
               "window_ms_median": statistics.median(ms),
               "window_ms_p95": float(np.percentile(ms, 95)),
               "window_ms_median_unscored": statistics.median(plain),
               "scorings": len(score_ms), "score_ms": score_ms,
               "score_ms_median": statistics.median(score_ms),
               "tubes_seen": final["num_tubes"], "final_triplets": len(final["triplets"]),
               "peak_gib": peak, "launches": launches}
        if device_history:
            ring = engine._ring
            row.update(ring_device=str(ring.hist.device), ring_shape=list(ring.hist.shape),
                       live_tubes=len(ring.live_tids()),
                       aged_out=final["num_tubes"] - len(ring.live_tids()),
                       t_valid=ring.t_valid, ring_lo=ring.lo)
            if ring.hist.device.type != "cuda":
                problems.append(f"the ring lives on {ring.hist.device}, not the card")
            if not all(launches.values()):
                problems.append(f"streaming did not launch every kernel: {launches}")
        emit({"phase": "end2end", "part": f"streaming_{backend}", **row})
        runs[backend] = {"windows": windows, "final": final, "row": row,
                         "final_scores": final_scores}
    dev, host = runs["device"], runs["host"]
    same_pans = all(np.array_equal(a, b) for x, y in zip(dev["windows"], host["windows"])
                    for a, b in zip(x["out"]["pan_results"], y["out"]["pan_results"]))
    scored = exact = agree = 0
    for x, y in zip(dev["windows"], host["windows"]):
        if x["out"]["triplets"] is None and y["out"]["triplets"] is None:
            continue
        scored += 1
        if (x["out"]["triplets"] is None) != (y["out"]["triplets"] is None):
            continue
        exact += x["out"]["triplets"] == y["out"]["triplets"]
        agree += triplets_agree(y["out"]["triplets"], x["out"]["triplets"], x["scores"],
                                STREAM_RANK_TOL)
    final_ok = triplets_agree(host["final"]["triplets"], dev["final"]["triplets"],
                              dev["final_scores"], STREAM_RANK_TOL)
    row = {"pan_results_equal": same_pans, "scorings": scored,
           "scorings_exactly_equal": exact, "scorings_equal_where_separated": agree,
           "final_equal_where_separated": final_ok, "rank_tol": STREAM_RANK_TOL,
           "ok": same_pans and agree == scored and final_ok}
    emit({"phase": "end2end", "part": "streaming_backends", **row})
    if not row["ok"]:
        problems.append(f"the streaming backends disagree: {row}")
    return dev["row"]["launches"]


def run_end2end(torch, np, seed, gen, dev, sm_clock_hz, wrappers):
    """Phase 14: (a) stages 3-5 and (b) end2end_inference through the
    CLIs, each in its own process (their launch counts come from their
    summary lines), (c) the streaming engine in this process (360x480
    frames: phases 3 and 5 hold both kernels at its shapes), then B1 and B2
    against their plain versions at (b)'s VPS shapes (its synthetic root's
    360x640 frames, padded to 384x640), TF32 off. Returns the launch counts of
    end2end (VPS, IPS) and of streaming, and the kernel rows at end2end
    VPS's shapes (its IPS batches have phase 10's shapes)."""
    t_phase = time.perf_counter()
    problems = []
    with tempfile.TemporaryDirectory() as tmp:
        data, anno, ckpt, rel_launches = run_rel_clis(np, torch, seed, tmp, problems)
        for name, counts in rel_launches.items():
            if any(counts.values()):
                problems.append(f"{name} launched a kernel of the segmenter: {counts}")
        e2e_launches = run_end2end_clis(tmp, data, anno, ckpt, problems)
    stream_launches = run_streaming(torch, np, seed, wrappers, problems)
    # float32 parity, TF32 off (phase 13 leaves cuDNN's on)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "settings", "matmul_allow_tf32": False, "cudnn_allow_tf32": False})
    fpn_rows = check_fpn(torch, gen, dev, B=2, H=96, W=160, at="end2end_vps")
    fusion_rows = check_fusion(torch, gen, dev, sm_clock_hz, N=2, h=96, w=160,
                               ori=(360, 640), at="end2end_vps")
    emit({"phase": "end2end", "ok": not problems, "problems": problems,
          "seconds": time.perf_counter() - t_phase})
    if problems:
        fail("end2end: " + "; ".join(problems))
    return e2e_launches, stream_launches, fpn_rows, fusion_rows


# ---------------------------------------------------------------------------
# phase 15: the multi-device half (mesh serving, time-sharded relation
# scoring, data-parallel training)
# ---------------------------------------------------------------------------

def attribute_launches(seg, wrappers):
    """Per-replica launch counts of a mesh ``SegmenterInference``: its
    per-replica forward (B1) and fusion (B2) are wrapped to add each call's
    launches to its replica's row. Returns the rows (one dict per replica)."""
    rows = [{fn.__name__: 0 for fn in wrappers} for _ in seg.replicas]

    def wrap(method):
        def wrapped(i, *args, **kw):
            before = launch_counts(wrappers)
            out = method(i, *args, **kw)
            for name, n in launch_counts(wrappers).items():
                rows[i][name] += n - before[name]
            return out
        return wrapped

    seg._forward = wrap(seg._forward)
    seg._fuse = wrap(seg._fuse)
    return rows


def mesh_serving(torch, np, cfg, state, seed, wrappers, dev, n_frames=16):
    """(a): stage 2 on a (data=2) mesh of two replicas on one card at 2
    windows per forward against the serial run, bf16 then float32."""
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.infer.stages import run_query_tube_vps
    from openpvsg_torch.parallel.mesh import make_mesh

    frames = list(synthetic_frames(np, n_frames, 360, 480, seed))
    mesh = make_mesh(n_data=2, devices=[dev, dev])
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            runs = {}
            for kind in ("serial", "mesh"):
                seg = SegmenterInference(cfg, state, dtype=dtype,
                                         mesh=mesh if kind == "mesh" else None)
                wpb = 2 if kind == "mesh" else 1
                run_query_tube_vps(seg, frames[:4], os.path.join(tmp, f"warm_{kind}"),
                                   window=2, windows_per_batch=wpb)
                per_replica = attribute_launches(seg, wrappers) if kind == "mesh" else None
                for fn in wrappers:
                    fn.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                root = os.path.join(tmp, f"{name}_{kind}")
                run_query_tube_vps(seg, frames, root, window=2, windows_per_batch=wpb)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                with open(os.path.join(root, "quantitive", "masks.txt"), "rb") as f:
                    runs[kind] = {"masks": f.read(), "seconds": seconds,
                                  "launches": launch_counts(wrappers),
                                  "per_replica": per_replica,
                                  "replica_devices": [str(next(m.parameters()).device)
                                                      for m in seg.replicas]}
                del seg
            rows[name] = {
                "frames": n_frames, "window": 2, "windows_per_batch_mesh": 2,
                "masks_txt_identical": runs["mesh"]["masks"] == runs["serial"]["masks"],
                "masks_txt_lines": len(runs["serial"]["masks"].decode().splitlines()),
                "serial_frames_per_s": n_frames / runs["serial"]["seconds"],
                "mesh_frames_per_s": n_frames / runs["mesh"]["seconds"],
                "serial_launches": runs["serial"]["launches"],
                "mesh_launches": runs["mesh"]["launches"],
                "mesh_launches_per_replica": runs["mesh"]["per_replica"],
                "replica_devices": runs["mesh"]["replica_devices"]}
    return rows


def time_sharded_relation(torch, np, seed, mesh, n_tubes=20, n_pairs=50, T=900):
    """(b): the d-256, 57-relation transformer head over ``mesh`` (a (1, 2)
    mesh of one card here) against the one-device head on the mesh's first
    device, both from host features as the
    evaluation feeds them: the pair matrix, then the pairs gathered on the
    device and scored (``predict_pairs``); and the span logits of
    ``predict`` on the same pair tensor."""
    from openpvsg_torch.config import RelationHeadConfig
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.parallel.tp import TimeShardedRelation
    from openpvsg_torch.train.segmenter import ieee_float32
    from openpvsg_torch.weights import random_relation_state_dict

    dev = mesh.first
    rcfg = RelationHeadConfig(model_name="transformer")
    model = RelationModel.from_config(rcfg)
    model.load_state_dict(random_relation_state_dict(rcfg, seed))
    model = model.to(dev).eval()
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n_tubes, T, rcfg.d_model)).astype(np.float32)
    idx = np.stack([rng.permutation(n_tubes)[:2] for _ in range(n_pairs)]).astype(np.int64)
    ts = TimeShardedRelation(mesh, model)

    def one():
        with torch.no_grad(), ieee_float32():
            out = model(torch.from_numpy(feats).to(dev))
            r = torch.from_numpy(idx).to(dev)
            pair = torch.cat([out["sub_feats"][r[:, 0]], out["obj_feats"][r[:, 1]]], -1)
            span, prob = model.predict(pair)
            return out["pred_matrix"], pair, span, prob

    def sharded():
        out = ts.propose(feats)
        return (out["pred_matrix"],) + ts.predict_pairs(out, idx)

    (pm1, pair, span1, prob1), (pm2, span_bin, prob2) = one(), sharded()
    span2, _ = ts.predict(pair)
    scale = max(float(span1.abs().max()), float(prob1.abs().max()), 1.0)
    flips = (span1 > 0).cpu().numpy() != span_bin
    near = float(np.abs(span1.cpu().numpy()[flips]).max()) if flips.any() else 0.0
    row = {"model": "relation_head('transformer') d 256, 57 relations",
           "tubes": n_tubes, "pairs": n_pairs, "frames": T,
           "mesh": [mesh.shape["data"], mesh.shape["time"]],
           "devices": [str(d) for d in mesh.axis_devices(None)],
           "span_max_abs_err": max_abs(span1, span2),
           "prob_max_abs_err": max_abs(prob1, torch.from_numpy(prob2).to(dev)),
           "pred_matrix_max_abs_err": max_abs(pm1, pm2), "scale": scale,
           "spans_binarized_equal": not bool(flips.any()),
           "span_flips": int(flips.sum()), "span_flips_max_abs_logit": near,
           "one_device_ms": call_ms(torch, one, reps=5, warmup=1),
           "time_sharded_ms": call_ms(torch, sharded, reps=5, warmup=1)}
    # binarized spans equal, save where the one-device logit is within the
    # tolerance of 0 (two float32 summation orders may put it either side)
    row["ok"] = (row["prob_max_abs_err"] <= 1e-4 * scale
                 and row["pred_matrix_max_abs_err"] <= 1e-4 * scale
                 and row["span_max_abs_err"] <= 1e-4 * scale and near <= 1e-4 * scale)
    return row


def ddp_worker(argv):
    """One rank of (c)'s two-rank train step (``chip_smoke.py --ddp-worker
    RANK WORLD PORT OUT SEED``): phase 6's small model and batch, gloo on
    cuda:0; writes the step's logs, global gradients and parameters."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from openpvsg_torch.config import TrainConfig
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import random_state_dict

    rank, world, port, out, seed = int(argv[0]), int(argv[1]), int(argv[2]), argv[3], int(argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        cfg = tiny_train_config()
        batch = train_batch(np, 2, 2, (64, 64), (64, 64), 3, cfg.num_classes, seed)
        trainer = SegmenterTrainer(cfg, TrainConfig(warmup_ratio=1.0), steps_per_epoch=10,
                                   device="cuda:0", state_dict=random_state_dict(cfg, seed),
                                   process_group=dist.group.WORLD)
        _, logs = trainer.loss_and_grads(batch)
        grads = {n: p.grad.detach().cpu().clone() for n, p in trainer.model.named_parameters()}
        trainer.apply_updates()
        torch.save({"logs": {k: float(v) for k, v in logs.items()}, "grads": grads,
                    "params": [p.detach().cpu().clone() for p in trainer.params]}, out)
    finally:
        dist.destroy_process_group()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def wait_all(procs, timeout):
    """(return code, output) of each process; all are killed at the limit."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))
    return outs


def two_rank_step(torch, np, seed):
    """(c) first half: two spawned ranks over gloo on cuda:0 against one
    process on the global batch, at phase 6's tolerances."""
    from openpvsg_torch.config import TrainConfig
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import random_state_dict

    here = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        procs = [subprocess.Popen([sys.executable, here, "--ddp-worker", str(r), "2",
                                   str(port), os.path.join(tmp, f"rank{r}.pt"), str(seed)],
                                  cwd=os.path.dirname(here), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        for r, (rc, out) in enumerate(wait_all(procs, 300)):
            if rc != 0:
                fail(f"multi_device: DDP rank {r} exited {rc}: {out[-3000:]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    cfg = tiny_train_config()
    batch = train_batch(np, 2, 2, (64, 64), (64, 64), 3, cfg.num_classes, seed)
    one = SegmenterTrainer(cfg, TrainConfig(warmup_ratio=1.0), steps_per_epoch=10,
                           state_dict=random_state_dict(cfg, seed))
    _, logs = one.loss_and_grads(batch)
    logs = {k: float(v.detach()) for k, v in logs.items()}
    names = [n for n, _ in one.model.named_parameters()]
    grads = {n: p.grad.detach().cpu().clone() for n, p in zip(names, one.params)}
    before = [p.detach().cpu().clone() for p in one.params]
    one.apply_updates()
    after = [p.detach().cpu() for p in one.params]
    loss_rel = max(abs(ranks[0]["logs"][k] - v) / max(abs(v), 1e-12) for k, v in logs.items())
    grad_rel, grad_at = grad_rel_diff(ranks[0]["grads"], {n: g.double() for n, g in grads.items()})
    gap, gap_at = update_gap(names, before, after, ranks[0]["params"])
    ranks_equal = all(torch.equal(a, b) for a, b in zip(ranks[0]["params"], ranks[1]["params"]))
    row = {"size": "phase 6's small model, B=2 (one clip per rank), gloo on cuda:0",
           "loss_one_process": logs["loss"], "loss_two_ranks": ranks[0]["logs"]["loss"],
           "max_loss_rel_diff": loss_rel, "max_grad_rel_diff": grad_rel,
           "max_grad_rel_diff_at": grad_at, "max_update_gap_share": gap,
           "max_update_gap_at": gap_at, "ranks_params_equal": ranks_equal}
    row["ok"] = loss_rel <= 1e-3 and grad_rel <= 1e-2 and gap <= 1e-2 and ranks_equal
    return row


def two_process_stage2(np, seed, cfg):
    """(c) second half: ``prepare_query_tube_vps`` over two ranks (gloo, one
    card) through the --dist-* flags against one process: masks.txt bytes."""
    from openpvsg_torch.tools.common import parse_summary

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        run_cli("make_synthetic_data", ["--out", data, "--train-videos", "0",
                                        "--val-videos", "3", "--frames", "6",
                                        "--size", "360", "480", "--seed", str(seed)])
        args = ["--config", "mask2former_vps", "--data-dir", data,
                "--anno-file", os.path.join(data, "pvsg.json"), "--split", "val",
                "--set", f"model.object_mask_thr={cfg.object_mask_thr}",
                f"model.iou_thr={cfg.iou_thr}"]
        t0 = time.perf_counter()
        _, one, _ = run_cli("prepare_query_tube_vps", args + ["--work-dir",
                                                              os.path.join(tmp, "one")])
        one_s = time.perf_counter() - t0
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "openpvsg_torch.tools.prepare_query_tube_vps", *args,
             "--work-dir", os.path.join(tmp, "two"), "--dist-coordinator",
             f"localhost:{port}", "--dist-num-processes", "2", "--dist-process-id", str(r)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = wait_all(procs, 600)
        two_s = time.perf_counter() - t0
        for r, (rc, out) in enumerate(outs):
            if rc != 0:
                fail(f"multi_device: prepare_query_tube_vps rank {r} exited {rc}: "
                     f"{out[-3000:]}")
        summaries = [parse_summary(out) for _, out in outs]
        vids = sorted(os.listdir(os.path.join(tmp, "one", "val_save_qf")))
        vids = [v for v in vids if os.path.isdir(os.path.join(tmp, "one", "val_save_qf", v))]
        same = []
        for vid in vids:
            files = [os.path.join(tmp, run, "val_save_qf", vid, "quantitive", "masks.txt")
                     for run in ("one", "two")]
            with open(files[0], "rb") as a, open(files[1], "rb") as b:
                same.append(a.read() == b.read())
    return {"videos": len(vids), "frames_per_video": 6, "frame_hw": [360, 480],
            "videos_per_rank": [s["videos"] for s in summaries],
            "launches_per_rank": [s["launches"] for s in summaries],
            "one_process_launches": one["launches"],
            "one_process_seconds": one_s, "two_process_seconds": two_s,
            "masks_txt_identical": same, "ok": len(vids) == 3 and all(same)
            and sorted(s["videos"] for s in summaries) == [1, 2]}


def nccl_world_one_step(torch, np, seed, clips=4):
    """(d): one full-width ``mask2former_vps`` step under an NCCL process
    group of one rank against the plain step from the same state: logs
    within 1e-6 of their scale; then a second step of each, timed."""
    import torch.distributed as dist

    from openpvsg_torch.config import mask2former_vps
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import random_state_dict

    pvsg = mask2former_vps()
    cfg, tcfg = pvsg.model, pvsg.train
    batch = train_batch(np, clips, cfg.num_frames, (360, 480), (384, 480), 20,
                        cfg.num_classes, seed)
    state = random_state_dict(cfg, seed)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        runs = {}
        for kind in ("plain", "nccl"):
            trainer = SegmenterTrainer(cfg, tcfg, steps_per_epoch=1000, seed=seed,
                                       state_dict=state,
                                       process_group=dist.group.WORLD if kind == "nccl" else None)
            first = trainer.step(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            second = trainer.step(batch)
            torch.cuda.synchronize()
            runs[kind] = {"logs": first, "second_loss": second["loss"],
                          "ms": (time.perf_counter() - t0) * 1e3,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            del trainer
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    scale = max(abs(v) for v in runs["plain"]["logs"].values())
    diff = max(abs(runs["nccl"]["logs"][k] - v) for k, v in runs["plain"]["logs"].items())
    row = {"config": "mask2former_vps", "clips": clips, "frames_per_clip": cfg.num_frames,
           "frame_hw": [360, 480], "backend": "nccl", "world": 1,
           "loss_plain": runs["plain"]["logs"]["loss"], "loss_nccl": runs["nccl"]["logs"]["loss"],
           "max_log_abs_diff": diff, "log_scale": scale,
           "step_ms_plain": runs["plain"]["ms"], "step_ms_nccl": runs["nccl"]["ms"],
           "peak_gib_plain": runs["plain"]["peak_gib"], "peak_gib_nccl": runs["nccl"]["peak_gib"],
           "second_loss_finite": bool(np.isfinite(runs["nccl"]["second_loss"]))}
    row["ok"] = diff <= 1e-6 * scale and row["second_loss_finite"]
    return row


def run_multi_device(torch, np, seed, wrappers, cfg, state, dev):
    """Phase 15: (a) mesh serving, (b) the time-sharded relation head, (c)
    two ranks over gloo on the one card (a train step, then stage 2 through
    the CLI), (d) an NCCL step at world size 1. Returns (a)'s bf16 launch
    counts: the whole mesh run's, and each replica's."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    problems = []
    serving = mesh_serving(torch, np, cfg, state, seed, wrappers, dev)
    for name, r in serving.items():
        emit({"phase": "multi_device", "part": "mesh_serving", "dtype": name, **r})
        if not r["masks_txt_identical"]:
            problems.append(f"the mesh's {name} masks.txt differs from the serial run's")
        if any(v == 0 for rep in r["mesh_launches_per_replica"] for v in rep.values()):
            problems.append(f"a replica launched no B1 or B2 ({name}): "
                            f"{r['mesh_launches_per_replica']}")
    from openpvsg_torch.parallel.mesh import make_mesh

    tsr = time_sharded_relation(torch, np, seed, make_mesh(n_data=1, n_time=2,
                                                           devices=[dev, dev]))
    emit({"phase": "multi_device", "part": "time_sharded_relation", **tsr})
    if not tsr["ok"]:
        problems.append("the time-sharded relation head disagrees with one device")
    ddp = two_rank_step(torch, np, seed)
    emit({"phase": "multi_device", "part": "two_rank_gloo_step", **ddp})
    if not ddp["ok"]:
        problems.append("the two-rank step disagrees with one process")
    st2 = two_process_stage2(np, seed, cfg)
    emit({"phase": "multi_device", "part": "two_process_stage2", **st2})
    if not st2["ok"]:
        problems.append("the two-process stage 2 differs from one process")
    nccl = nccl_world_one_step(torch, np, seed)
    emit({"phase": "multi_device", "part": "nccl_world_one_step", **nccl})
    if not nccl["ok"]:
        problems.append("the NCCL step at world size 1 differs from the plain step")
    emit({"phase": "multi_device", "ok": not problems, "problems": problems,
          "seconds": time.perf_counter() - t_phase})
    if problems:
        fail("multi_device: " + "; ".join(problems))
    bf16 = serving["bfloat16"]
    return bf16["mesh_launches"], bf16["mesh_launches_per_replica"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    try:
        import numpy as np
        from openpvsg_torch.kernels import build, fpn, fusion
        from openpvsg_torch.weights import random_state_dict
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "root of the repository", file=sys.stderr)
        return 2

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    reports = build.build()
    seconds = time.perf_counter() - t0
    # each kernel entry's name, then its registers and spills
    ptxas = {name: [ln.split("'")[1] if "Compiling entry function" in ln
                    else ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                    if "Compiling entry function" in ln or "Used" in ln or "spill" in ln]
             for name, log in reports.items()}
    emit({"phase": "build", "seconds": seconds, "sources": list(build.SOURCES),
          "ptxas": ptxas})

    # 3. kernels against their plain versions, TF32 off for float32 parity
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "settings", "matmul_allow_tf32": False, "cudnn_allow_tf32": False})
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(args.seed)
    fpn_rows = check_fpn(torch, gen, dev)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True,
                           text=True, check=True, timeout=60).stdout.split()[0]
    fusion_rows = check_fusion(torch, gen, dev, float(clock) * 1e6)
    fusion_row = fusion_rows["smoke"]

    # 4. the full-width model on a small input against the CPU path
    cfg = stage2_config()
    state = random_state_dict(cfg, args.seed)
    check_reference(torch, np, cfg, state, args.seed)

    # 5. stage 2 at full width, bf16, at 1, 2 and 4 windows per forward; then
    # B1 and B2 at the 4-window batch's shapes (8 frames), TF32 off as set
    # for phase 3
    wrappers = fpn.KERNEL_WRAPPERS + fusion.KERNEL_WRAPPERS
    launches, wpb_launches = run_stage2(torch, np, cfg, state, args.seed, wrappers)
    wpb_fpn = check_fpn(torch, gen, dev, B=8, H=96, W=120, at="stage2_wpb4")
    wpb_fusion = check_fusion(torch, gen, dev, float(clock) * 1e6, N=8, h=96, w=120,
                              ori=(360, 480), inputs=("smoke",), at="stage2_wpb4")

    # 6-7. stage-1 training with torch's default TF32 settings, as a caller
    # would leave them (the trainer turns TF32 off in its step); neither B1
    # nor B2 may launch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    emit({"phase": "settings", "matmul_allow_tf32": False, "cudnn_allow_tf32": True})
    before = launch_counts(wrappers)
    check_train_reference(torch, np, args.seed)
    check_train_reference_bf16(torch, np, args.seed)
    dense_train = run_train(torch, np, args.seed)
    run_train(torch, np, args.seed, dtype="bfloat16")
    run_train_bf16_variants(torch, np, args.seed)
    during = {k: v - before[k] for k, v in launch_counts(wrappers).items()}
    emit({"phase": "train_launches", "launches": during})
    if any(during.values()):
        fail(f"training launched a kernel of the inference path: {during}")

    # 8-9. the relation path, from torch's default TF32 settings as well;
    # the counts start at 0 and neither B1 nor B2 may launch
    for fn in wrappers:
        fn.launches = 0
    check_rel_reference(torch, np, args.seed)
    run_relations(torch, np, args.seed, wrappers)

    # 10. stage 1 through the CLIs (in their own processes: the launch counts
    # of the train and test CLIs come from their summary lines), then B1 and
    # B2 at the test CLI's IPS shapes
    ips_fpn, ips_fusion, cli_launches = run_stage1_cli(
        torch, np, args.seed, gen, dev, float(clock) * 1e6, wrappers)

    # 11. IPS stage 2 (its launch counts are zeroed just before its run and
    # read just after), the tracker alone, the tracker card against CPU, then
    # B1 and B2 at the IPS batch's shapes
    ips2_launches, ips2_fpn, ips2_fusion = run_stage2_ips(
        torch, np, args.seed, gen, dev, float(clock) * 1e6, wrappers)

    # 12. the reference's Mask2Former: mmdet import, MSDA serving (its launch
    # counts are zeroed just before its run and read just after), the MSDA
    # decoder card against CPU, points training
    ref_launches = run_reference_model(torch, np, args.seed, wrappers, dense_train)

    # 13. the Swin-T segmenter: B1 at its stride-4 width, the model card
    # against CPU, stage 2 (its launch counts are zeroed just before its run
    # and read just after), training and the trainer's options
    swin_fpn, swin_launches = run_swin(torch, np, args.seed, gen, dev, wrappers)

    # 14. stages 3-5 and end2end through the CLIs (their launch counts come
    # from their summary lines), the streaming engine (its launch counts are
    # zeroed just before its run and read just after), then B1 and B2 at
    # end2end VPS's shapes
    e2e_launches, stream_launches, e2e_fpn, e2e_fusion = run_end2end(
        torch, np, args.seed, gen, dev, float(clock) * 1e6, wrappers)

    # 15. the multi-device half on the one card (its mesh run's launch counts
    # are zeroed just before it and read just after)
    md_launches, md_per_replica = run_multi_device(torch, np, args.seed, wrappers,
                                                   cfg, state, dev)

    # 16. the kernels line and the result
    spec = [("fpn_lateral", fpn.lateral_stats, "openpvsg_torch/csrc/fpn.cu",
             "openpvsg_tpu/ops/pallas/fpn_kernel.py:140"),
            ("fpn_conv3x3", fpn.conv3x3_stats, "openpvsg_torch/csrc/fpn.cu",
             "openpvsg_tpu/ops/pallas/fpn_kernel.py:207"),
            ("fpn_mask", fpn.mask_proj, "openpvsg_torch/csrc/fpn.cu",
             "openpvsg_tpu/ops/pallas/fpn_kernel.py:250"),
            ("fusion_maps", fusion.fusion_maps, "openpvsg_torch/csrc/fusion.cu",
             "openpvsg_tpu/ops/pallas/fusion_kernel.py:164")]
    kernels = []
    for name, fn, src, tpu in spec:
        row = fusion_row if name == "fusion_maps" else fpn_rows[(name, "bfloat16")]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
                 "launches": launches[fn.__name__],
                 "max_abs_err": row["max_abs_err"],
                 "ms": row["ms"], "plain_ms": row["plain_ms"],
                 "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"], "tflops": row["tflops"],
                 "bound_share": row["bound_share"], "design": row["design"],
                 "parity": "pass",
                 "dtype": "float32" if name == "fusion_maps" else "bfloat16"}
        ips = ips_fusion if name == "fusion_maps" else ips_fpn[(name, "bfloat16")]
        entry.update(stage1_cli_launches=cli_launches[fn.__name__],
                     ips_shape=([8, 100, 96, 160] if name == "fusion_maps"
                                else [8, 96, 160, 256]),
                     ips_max_abs_err=ips["max_abs_err"], ips_ms=ips["ms"],
                     ips_plain_ms=ips["plain_ms"], ips_bound_ms=ips["bound_ms"],
                     ips_library_ms=ips["library_ms"])
        ips2 = ips2_fusion if name == "fusion_maps" else ips2_fpn[(name, "bfloat16")]
        entry.update(reference_model_launches=ref_launches[fn.__name__],
                     swin_launches=swin_launches[fn.__name__],
                     end2end_launches=(e2e_launches["vps"][fn.__name__]
                                       + e2e_launches["ips"][fn.__name__]),
                     end2end_vps_launches=e2e_launches["vps"][fn.__name__],
                     end2end_ips_launches=e2e_launches["ips"][fn.__name__],
                     streaming_launches=stream_launches[fn.__name__],
                     multi_device_launches=md_launches[fn.__name__],
                     multi_device_launches_per_replica=[r[fn.__name__]
                                                        for r in md_per_replica])
        e2e = e2e_fusion["smoke"] if name == "fusion_maps" else e2e_fpn[(name, "bfloat16")]
        entry.update(end2end_vps_shape=([2, 100, 96, 160] if name == "fusion_maps"
                                        else [2, 96, 160, 256]),
                     end2end_vps_max_abs_err=e2e["max_abs_err"],
                     end2end_vps_ms=e2e["ms"], end2end_vps_plain_ms=e2e["plain_ms"],
                     end2end_vps_bound_ms=e2e["bound_ms"],
                     end2end_vps_library_ms=e2e["library_ms"])
        if name != "fusion_maps":
            sw = swin_fpn[(name, "bfloat16")]
            entry.update(swin_shape=[2, 96, 120, 96], swin_max_abs_err=sw["max_abs_err"],
                         swin_ms=sw["ms"], swin_plain_ms=sw["plain_ms"],
                         swin_bound_ms=sw["bound_ms"], swin_bound_by=sw["bound_by"],
                         swin_library_ms=sw["library_ms"],
                         swin_f32_max_abs_err=swin_fpn[(name, "float32")]["max_abs_err"],
                         swin_f32_ms=swin_fpn[(name, "float32")]["ms"])
        wpb = wpb_fusion["smoke"] if name == "fusion_maps" else wpb_fpn[(name, "bfloat16")]
        entry.update(stage2_wpb2_launches=wpb_launches[2][fn.__name__],
                     stage2_wpb4_launches=wpb_launches[4][fn.__name__],
                     stage2_wpb4_shape=([8, 100, 96, 120] if name == "fusion_maps"
                                        else [8, 96, 120, 256]),
                     stage2_wpb4_max_abs_err=wpb["max_abs_err"],
                     stage2_wpb4_ms=wpb["ms"], stage2_wpb4_plain_ms=wpb["plain_ms"],
                     stage2_wpb4_bound_ms=wpb["bound_ms"],
                     stage2_wpb4_bound_by=wpb["bound_by"],
                     stage2_wpb4_library_ms=wpb["library_ms"])
        if name != "fusion_maps":
            entry.update(stage2_wpb4_f32_max_abs_err=wpb_fpn[(name, "float32")]["max_abs_err"],
                         stage2_wpb4_f32_ms=wpb_fpn[(name, "float32")]["ms"])
        entry.update(stage2_ips_launches=ips2_launches[fn.__name__],
                     stage2_ips_max_abs_err=ips2["max_abs_err"],
                     stage2_ips_ms=ips2["ms"], stage2_ips_plain_ms=ips2["plain_ms"])
        if name == "fusion_maps":
            ns = fusion_rows["no_skip"]
            entry.update(bound_term=row["bound_term"],
                         no_skip_ms=ns["ms"], no_skip_plain_ms=ns["plain_ms"],
                         no_skip_bound_ms=ns["bound_ms"], no_skip_bound_term=ns["bound_term"])
        else:
            f32 = fpn_rows[(name, "float32")]
            entry.update(f32_max_abs_err=f32["max_abs_err"], f32_ms=f32["ms"],
                         f32_plain_ms=f32["plain_ms"], f32_bound_ms=f32["bound_ms"])
        kernels.append(entry)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        ddp_worker(sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
