#!/usr/bin/env python3
"""The multi-device half of the PyTorch port (``openpvsg_torch.parallel``)
on several GPUs of one host: what one card cannot show. Run from the root
of the repository with two or more GPUs visible:

    python3 multi_gpu_torch.py [--seed 0]

Parts, each printing one JSON line (the card's name and power limit first):

(a) kernels B1 and B2 on ``cuda:1`` launched from ``cuda:0``
    (``tests/test_torch_cuda.py::test_kernels_launch_on_their_tensors_device``);
(b) VPS stage 2 (``chip_smoke.py``'s 16 360x480 frames, full-width
    ``mask2former_vps``, window 2) on a (data=N) mesh of the N GPUs at N
    windows per forward (each replica's batch is the serial run's), bf16
    and float32: ``masks.txt`` against the serial run's bytes, frames/s, and
    each replica's launches and device;
(c) ``TimeShardedRelation`` of the d-256 transformer head (57 relations,
    20 tubes x 900 frames, 50 pairs) on a (N/2, 2) mesh against one device
    (``chip_smoke.py``'s phase 15 (b) rule), ms of each;
(d) ``DataParallelRelationTrainer`` over the N GPUs against
    ``RelationTrainer``: 2N videos, one Adam apply; losses and parameters
    (1e-4 of each tensor's scale plus 1e-6; key biases within 2 lr);
(e) N ranks under NCCL, one GPU each: ``chip_smoke.py``'s phase 6 step
    (one clip per rank) against one process on the global batch: the loss
    within 1e-3 (relative), and the ranks' gradients no further from the
    step's float64 gradients on the CPU (same assignment) than twice the
    one-process gradients are, plus 1e-3 of each tensor's scale (float32
    gradients through training BatchNorm on 2x2 maps are ill-conditioned:
    the one process's are themselves a few percent of their scale from
    float64 at this batch); then
    full-width float32 steps of 4 clips per rank (the second timed) against
    the same step of one process at world size 1: ms, frames/s, the
    scaling efficiency (one rank's ms over N ranks' ms).

Exits non-zero on a failure or with fewer than two GPUs.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"multi_gpu_torch: FAILED: {msg}")


def mesh_stage2(torch, np, cs, n, seed, wrappers):
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.infer.stages import run_query_tube_vps
    from openpvsg_torch.parallel.mesh import make_mesh
    from openpvsg_torch.weights import random_state_dict

    cfg = cs.stage2_config()
    state = random_state_dict(cfg, seed)
    frames = list(cs.synthetic_frames(np, 16, 360, 480, seed))
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            runs = {}
            for kind in ("serial", "mesh"):
                seg = SegmenterInference(cfg, state, dtype=dtype,
                                         mesh=make_mesh(n_data=n) if kind == "mesh" else None)
                wpb = n if kind == "mesh" else 1
                run_query_tube_vps(seg, frames[:2 * wpb], os.path.join(tmp, "warm"),
                                   window=2, windows_per_batch=wpb)
                per_replica = cs.attribute_launches(seg, wrappers) if kind == "mesh" else None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                root = os.path.join(tmp, f"{name}_{kind}")
                run_query_tube_vps(seg, frames, root, window=2, windows_per_batch=wpb)
                for d in range(torch.cuda.device_count()):
                    torch.cuda.synchronize(d)
                seconds = time.perf_counter() - t0
                with open(os.path.join(root, "quantitive", "masks.txt"), "rb") as f:
                    runs[kind] = (f.read(), seconds, per_replica,
                                  [str(next(m.parameters()).device) for m in seg.replicas])
                del seg
            rows[name] = {"masks_txt_identical": runs["mesh"][0] == runs["serial"][0],
                          "serial_frames_per_s": 16 / runs["serial"][1],
                          "mesh_frames_per_s": 16 / runs["mesh"][1],
                          "launches_per_replica": runs["mesh"][2],
                          "replica_devices": runs["mesh"][3]}
    return rows


def relation_dp(torch, np, n, seed):
    from openpvsg_torch.config import RelationHeadConfig
    from openpvsg_torch.parallel.mesh import make_mesh
    from openpvsg_torch.train.relation import DataParallelRelationTrainer, RelationTrainer

    cfg = RelationHeadConfig(accumulation_steps=2 * n)
    counts = np.ones(cfg.num_relations)
    rng = np.random.default_rng(seed)
    videos = []
    for i in range(2 * n):
        t = 120
        feats = rng.standard_normal((20, t, cfg.d_model)).astype(np.float32)
        rels = [{"subject_index": 0, "object_index": 1, "relation": i % cfg.num_relations,
                 "relation_span": np.ones(t)},
                {"subject_index": 2, "object_index": 3, "relation": (i + 5) % cfg.num_relations,
                 "relation_span": (np.arange(t) < t // 2).astype(np.float64)}]
        videos.append((feats, rels))
    seq = RelationTrainer(cfg, counts, rng_seed=seed, device="cuda:0")
    dp = DataParallelRelationTrainer(cfg, counts, make_mesh(n_data=n), rng_seed=seed,
                                     state_dict=seq.model.state_dict())
    seq_losses, dp_losses = [], []
    for feats, rels in videos:
        seq_losses.append(seq.step(feats, rels)[0])
        r = dp.step(feats, rels)
        if r is not None:
            dp_losses.append(r[0])
    dp.flush()
    worst, at = 0.0, None
    for (name, p), q in zip(seq.model.named_parameters(), dp.model.parameters()):
        tol = (2 * cfg.lr if name.endswith("k_proj.bias")
               else 1e-4 * float(p.detach().abs().max()) + 1e-6)
        gap = float((p - q).detach().abs().max()) / tol
        if gap > worst:
            worst, at = gap, name
    loss_gap = abs(np.mean(seq_losses) - np.mean(dp_losses)) / abs(np.mean(seq_losses))
    return {"videos": len(videos), "replica_devices": [str(next(m.parameters()).device)
                                                       for m in dp.replicas],
            "mean_loss_rel_diff": loss_gap, "worst_param_gap_over_tol": worst,
            "worst_param_at": at, "ok": loss_gap <= 1e-5 and worst <= 1.0}


def rank_main(argv):
    """One NCCL rank of (e): ``--rank R --world N --port P --out F --seed S``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from openpvsg_torch.config import TrainConfig, mask2former_vps
    from openpvsg_torch.parallel.mesh import init_distributed
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import random_state_dict

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--port", "--seed"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    dev = init_distributed(f"tcp://localhost:{args.port}", args.world, args.rank)
    try:
        group = dist.group.WORLD
        cfg = cs.tiny_train_config()
        batch = cs.train_batch(np, args.world, 2, (64, 64), (64, 64), 3, cfg.num_classes,
                               args.seed)
        small = SegmenterTrainer(cfg, TrainConfig(warmup_ratio=1.0), steps_per_epoch=10,
                                 device=dev, state_dict=random_state_dict(cfg, args.seed),
                                 process_group=group)
        _, logs = small.loss_and_grads(batch)
        out = {"logs": {k: float(v) for k, v in logs.items()},
               "grads": {n: p.grad.detach().cpu().clone()
                         for n, p in small.model.named_parameters()}}
        small.apply_updates()
        out["params"] = [p.detach().cpu().clone() for p in small.params]
        del small
        pvsg = mask2former_vps()
        full = pvsg.model
        big = cs.train_batch(np, 4 * args.world, full.num_frames, (360, 480), (384, 480), 20,
                             full.num_classes, args.seed)
        trainer = SegmenterTrainer(full, pvsg.train, steps_per_epoch=1000, device=dev,
                                   seed=args.seed, process_group=group)
        trainer.step(big)
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        logs = trainer.step(big)
        torch.cuda.synchronize(dev)
        out.update(full_ms=(time.perf_counter() - t0) * 1e3, full_loss=logs["loss"],
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        torch.save(out, args.out)
    finally:
        dist.destroy_process_group()


def nccl_ranks(torch, np, cs, n, seed):
    from openpvsg_torch.config import TrainConfig, mask2former_vps
    from openpvsg_torch.train.segmenter import SegmenterTrainer
    from openpvsg_torch.weights import random_state_dict

    with tempfile.TemporaryDirectory() as tmp:
        port = cs.free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank-main",
                                   "--rank", str(r), "--world", str(n), "--port", str(port),
                                   "--seed", str(seed), "--out", os.path.join(tmp, f"{r}.pt")],
                                  cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(n)]
        for r, (rc, out) in enumerate(cs.wait_all(procs, 900)):
            if rc != 0:
                fail(f"NCCL rank {r} exited {rc}: {out[-3000:]}")
        ranks = [torch.load(os.path.join(tmp, f"{r}.pt")) for r in range(n)]
    cfg = cs.tiny_train_config()
    batch = cs.train_batch(np, n, 2, (64, 64), (64, 64), 3, cfg.num_classes, seed)
    one = SegmenterTrainer(cfg, TrainConfig(warmup_ratio=1.0), steps_per_epoch=10,
                           state_dict=random_state_dict(cfg, seed))
    _, logs = one.loss_and_grads(batch)
    names = [k for k, _ in one.model.named_parameters()]
    grads = {k: p.grad.detach().cpu().double() for k, p in zip(names, one.params)}
    before = [p.detach().cpu().clone() for p in one.params]
    one.apply_updates()
    after = [p.detach().cpu() for p in one.params]
    loss_rel = max(abs(ranks[0]["logs"][k] - float(v)) / max(abs(float(v)), 1e-12)
                   for k, v in logs.items())
    grad_rel, grad_at = cs.grad_rel_diff(ranks[0]["grads"], grads)
    gap, gap_at = cs.update_gap(names, before, after, ranks[0]["params"])
    exact = cs.float64_grads(torch, cfg, random_state_dict(cfg, seed),
                             one.device_batch(batch)[0].cpu(), batch, one.last_assigned)
    worst, worst_at = 0.0, None
    for k in names:
        e = exact[k]
        scale = float(e.abs().max())
        if scale <= 1e-6 or cs.key_bias(k):
            continue
        d_one = float((grads[k] - e).abs().max()) / scale
        d_ranks = float((ranks[0]["grads"][k].double() - e).abs().max()) / scale
        share = (d_ranks - 1e-3) / (2 * d_one) if d_one > 0 else float(d_ranks > 1e-3)
        if share > worst:
            worst, worst_at = share, k
    equal = all(torch.equal(a, b) for r in ranks[1:] for a, b in zip(ranks[0]["params"],
                                                                      r["params"]))
    # world size 1: the same full-width step of 4 clips in this process
    pvsg = mask2former_vps()
    full = pvsg.model
    big = cs.train_batch(np, 4, full.num_frames, (360, 480), (384, 480), 20,
                         full.num_classes, seed)
    trainer = SegmenterTrainer(full, pvsg.train, steps_per_epoch=1000, seed=seed)
    trainer.step(big)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.step(big)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    n_ms = max(r["full_ms"] for r in ranks)
    row = {"world": n, "small_max_loss_rel_diff": loss_rel, "small_max_grad_rel_diff": grad_rel,
           "small_max_grad_rel_diff_at": grad_at, "small_max_update_gap_share": gap,
           "small_max_update_gap_at": gap_at, "ranks_params_equal": equal,
           "small_float64_share": worst, "small_float64_share_at": worst_at,
           "full_clips_per_rank": 4, "full_ms_per_rank": [r["full_ms"] for r in ranks],
           "full_ms_world1": one_ms,
           "full_frames_per_s": 4 * n * full.num_frames / (n_ms / 1e3),
           "full_frames_per_s_world1": 4 * full.num_frames / (one_ms / 1e3),
           "scaling_efficiency": one_ms / n_ms,
           "peak_gib_per_rank": [r["peak_gib"] for r in ranks],
           "full_losses": [r["full_loss"] for r in ranks]}
    row["ok"] = (loss_rel <= 1e-3 and worst <= 1.0 and equal
                 and len(set(row["full_losses"])) == 1
                 and all(np.isfinite(row["full_losses"])))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("multi_gpu_torch: needs two or more GPUs", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from openpvsg_torch.kernels import build, fpn, fusion

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    n = torch.cuda.device_count()
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = fpn.KERNEL_WRAPPERS + fusion.KERNEL_WRAPPERS
    problems = []

    test = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q",
                           "-p", "no:cacheprovider",
                           "tests/test_torch_cuda.py::test_kernels_launch_on_their_tensors_device"],
                          cwd=HERE, capture_output=True, text=True, timeout=600)
    emit({"part": "kernels_on_cuda1", "rc": test.returncode,
          "summary": test.stdout.strip().splitlines()[-1:]})
    if test.returncode != 0:
        problems.append("the cross-device kernel test failed")

    for name, row in mesh_stage2(torch, np, cs, n, args.seed, wrappers).items():
        emit({"part": "mesh_stage2", "gpus": n, "dtype": name, **row})
        if not row["masks_txt_identical"]:
            problems.append(f"the {n}-GPU mesh's {name} masks.txt differs from serial")
        if any(v == 0 for rep in row["launches_per_replica"] for v in rep.values()):
            problems.append("a replica launched no B1 or B2")
        if len(set(row["replica_devices"])) != n:
            problems.append(f"replicas on {row['replica_devices']}")

    from openpvsg_torch.parallel.mesh import make_mesh

    tsr = cs.time_sharded_relation(torch, np, args.seed, make_mesh(n_data=n // 2, n_time=2))
    emit({"part": "time_sharded_relation", **tsr})
    if not tsr["ok"]:
        problems.append("the time-sharded relation head disagrees with one device")

    rdp = relation_dp(torch, np, n, args.seed)
    emit({"part": "relation_data_parallel", **rdp})
    if not rdp["ok"]:
        problems.append("the data-parallel relation trainer disagrees with one device")

    nccl = nccl_ranks(torch, np, cs, n, args.seed)
    emit({"part": "nccl_ranks", **nccl})
    if not nccl["ok"]:
        problems.append(f"{n} NCCL ranks disagree with one process")

    emit({"ok": not problems, "problems": problems})
    if problems:
        fail("; ".join(problems))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-main"]:
        rank_main(sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
