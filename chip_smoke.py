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
             byte-identical is reported.
6. the ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

Any failure raises, so the script exits non-zero without the last line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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

def check_fpn(torch, gen, dev):
    from openpvsg_torch.kernels import fpn
    from openpvsg_torch.ops.resize import resize_bilinear

    B, H, W, Cin, C, Cout, G, eps = 2, 96, 120, 256, 256, 256, 32, 1e-6
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
            emit({"phase": "kernel_vs_plain", "kernel": name, "dtype": dt_name, **row})
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
              "dtype": dt_name, **row})
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


def check_fusion(torch, gen, dev, sm_clock_hz):
    from openpvsg_torch.kernels import fusion

    rows = {}
    for name in ("smoke", "no_skip"):
        low, scores = fusion_input(torch, gen, dev, no_skip=name == "no_skip")
        N, Q, h, w = low.shape
        H, W = 4 * h, 4 * w
        ori = (360, 480)
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
        emit({"phase": "kernel_vs_plain", "kernel": "fusion_maps", "dtype": "float32", **row})
        if not row["ok"]:
            fail(f"fusion_maps disagrees with its plain version on the {name} input: {row}")
        rows[name] = row
        del low, scores, got, ref
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


def check_reference(torch, np, cfg, state, seed):
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
    emit({"phase": "reference", "input": [2, 64, 64, 3], "dtype": "float32",
          **row, "ok": ok})
    if not ok:
        fail(f"GPU forward disagrees with the CPU reference: {row}")


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
    row = {"frames": n_frames, "frame_hw": [360, 480], "window": 2,
           "dtype": "bfloat16", "seconds": wall, "frames_per_s": n_frames / wall,
           "tubes": n_tubes, "masks_txt_lines": len(lines),
           "frames_per_s_rerun": n_frames / wall_again,
           "masks_txt_identical_on_rerun": masks[0] == masks[1],
           "masks_txt_lines_rerun": len(masks[1].decode().splitlines()),
           "query_feats_pickle_bytes": pickle_bytes, "launches": launches}
    emit({"phase": "stage2", **row})
    if not lines:
        fail("masks.txt is empty")
    if any(v == 0 for v in launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    return launches


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

    # 5. stage 2 at full width, bf16
    wrappers = fpn.KERNEL_WRAPPERS + fusion.KERNEL_WRAPPERS
    launches = run_stage2(torch, np, cfg, state, args.seed, wrappers)

    # 6. the kernels line and the result
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
    sys.exit(main())
