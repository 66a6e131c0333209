"""The PyTorch port's multi-process paths, run for real: two spawned
processes under a gloo process group on the CPU.

- One data-parallel train step of a small model, dense and point-sampled:
  each rank takes its block of a global batch of two clips (the second
  clip has a padded target, so the ranks' target counts differ and the
  normalizers must be global). Held against JAX's
  ``SegmenterTrainer(mesh=make_mesh(n_data=2))`` on the same global batch
  computing in float64 (logs, parameters and BN statistics after the
  step), and against the port's one-process step on the global batch (the
  global gradients, logs, parameters and statistics). In points mode both
  ranks replay JAX's draws for the global batch, each its slice
  (``rank_draw``). The same step in bfloat16 compute, against the
  one-process step by tests/test_torch_train_bf16.py's rule.
- ``prepare_query_tube_vps`` and ``end2end_inference --eval`` through the
  ``--dist-*`` flags (the setup of tests/test_multiprocess.py): three
  videos strided over two ranks into one shared directory must give the
  files of a one-process run, byte for byte, and rank 0's protocol
  metrics.

Tolerances (tests/test_torch_train.py's, float64 JAX): logs rel 1e-4;
parameters and statistics after the step and every gradient rel 1e-4 of
their tensor's scale plus 1e-6.

Run as ``python tests/test_torch_multiprocess.py --worker ...`` this file
is the train step's worker (it imports no JAX).
"""
import argparse
import functools
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from openpvsg_torch import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, T, B, N, P = 64, 64, 2, 2, 3, 64
JAX_OBJECTIVES = ("dense", "points")
OBJECTIVES = JAX_OBJECTIVES + ("dense_bf16",)


def _cfg(m, objective):
    """The small model of either package: R-26 with 'sync_bn', 8 queries,
    two decoder layers; dense or point-sampled loss; bfloat16 compute for
    'dense_bf16'."""
    kw = {"loss_sampling": "points", "num_points": P} if objective == "points" else {}
    dtype = "bfloat16" if objective == "dense_bf16" else "float32"
    return m.Mask2FormerConfig(
        num_things_classes=3, num_stuff_classes=2, num_queries=8,
        backbone=m.BackboneConfig(depth=26, norm="sync_bn", dtype=dtype),
        pixel_decoder=m.PixelDecoderConfig(encoder_layers=1, ffn_channels=32),
        decoder=m.TransformerDecoderConfig(num_layers=2, ffn_channels=32),
        assigner="hungarian", **kw)


class Replay:
    """A ``Draw`` handing out recorded draws in order, as float32."""

    def __init__(self, draws):
        self.queue = list(draws)

    def __call__(self, shape):
        a = self.queue.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(np.array(a, np.float32))


def _step(case, objective, process_group=None, rank=0, world=1):
    """One port train step on the case's global batch: (logs, the global
    gradients by parameter name, the state dict after the step)."""
    from openpvsg_torch.ops.sampling import rank_draw
    from openpvsg_torch.train.segmenter import SegmenterTrainer

    state = {k: torch.from_numpy(v) for k, v in case["state"].items()}
    trainer = SegmenterTrainer(_cfg(tcfg, objective), tcfg.TrainConfig(warmup_iters=1),
                               steps_per_epoch=10, device="cpu", state_dict=state,
                               process_group=process_group)
    if objective == "points":
        trainer.draw = rank_draw(Replay(case["draws"]), rank, world)
    _, logs = trainer.loss_and_grads(case["batch"])
    grads = {n: p.grad.detach().clone().numpy()
             for n, p in trainer.model.named_parameters()}
    trainer.apply_updates()
    return ({k: float(v.detach()) for k, v in logs.items()}, grads,
            {k: v.detach().clone().numpy() for k, v in trainer.model.state_dict().items()})


def _worker(argv):
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--port"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--case", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{args.port}",
                            world_size=args.world, rank=args.rank)
    try:
        with open(args.case, "rb") as f:
            cases = pickle.load(f)
        out = {obj: _step(cases[obj], obj, dist.group.WORLD, args.rank, args.world)
               for obj in OBJECTIVES}
        with open(args.out, "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait(procs, timeout=600):
    """Each process's (return code, output); kills the ones past the time
    limit."""
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


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """JAX's mesh step, the port's one-process step and the two ranks'
    steps, for each objective, from the same float32 weights and batch."""
    import jax
    import jax.numpy as jnp

    import openpvsg_tpu.train.segmenter as jseg
    from openpvsg_tpu import config as jcfg
    from openpvsg_tpu.models.mask2former import Mask2Former as JaxM2F
    from openpvsg_tpu.parallel.mesh import make_mesh
    from openpvsg_torch.weights import from_jax_params
    from test_torch_points import jax_draws
    from test_torch_train import _batch

    class JitInit(JaxM2F):
        def init(self, *args, **kwargs):
            return jax.jit(functools.partial(JaxM2F.init, self))(*args, **kwargs)

    batch = _batch()
    cases, jax_side = {}, {}
    for objective in JAX_OBJECTIVES:
        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
            mp.setattr(jseg, "Mask2Former", JitInit)
            jt = jseg.SegmenterTrainer(_cfg(jcfg, objective), jcfg.TrainConfig(warmup_iters=1),
                                       mesh=make_mesh(n_data=2), steps_per_epoch=10,
                                       example_shape=(T, H, W), compute_dtype=jnp.float64)
            params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                            jt.state.params)
            jt.state = jt.state.replace(params=params, opt_state=jt.tx.init(params))
            variables = jax.tree_util.tree_map(
                np.array, {"params": jt.state.params, "batch_stats": jt.state.batch_stats})
            logs = jt.step(batch, jax.random.PRNGKey(0))
            # the decoder's 2 layers plus the prediction before them
            draws = (jax_draws(jax.random.PRNGKey(0), 3, B, 8, P)
                     if objective == "points" else None)
        state = from_jax_params(variables, _cfg(tcfg, objective))
        cases[objective] = {"state": {k: v.numpy() for k, v in state.items()},
                            "batch": batch, "draws": draws}
        jax_side[objective] = {
            "logs": {k: float(v) for k, v in logs.items()},
            "state": jax.tree_util.tree_map(
                np.asarray, {"params": jt.state.params,
                             "batch_stats": jt.state.batch_stats})}

    # bfloat16 compute: the dense case's float32 weights and batch
    cases["dense_bf16"] = cases["dense"]
    tmp = tmp_path_factory.mktemp("ddp")
    with open(tmp / "case.pkl", "wb") as f:
        pickle.dump(cases, f)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", "--rank", str(r),
         "--world", "2", "--port", str(port), "--case", str(tmp / "case.pkl"),
         "--out", str(tmp / f"rank{r}.pkl")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    one = {obj: _step(cases[obj], obj) for obj in OBJECTIVES}
    for r, (rc, out) in enumerate(_wait(procs)):
        assert rc == 0, f"rank {r} failed:\n{out[-3000:]}"
    ranks = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"jax": jax_side, "one": one, "ranks": ranks}


def _close_to_scale(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max() + 1e-6, err_msg=msg)


@pytest.mark.parametrize("objective", JAX_OBJECTIVES)
def test_two_rank_step_matches_jax_mesh_step(steps, objective):
    from openpvsg_torch.weights import to_jax_params

    want = steps["jax"][objective]
    (logs0, _, state0), (logs1, _, state1) = (r[objective] for r in steps["ranks"])
    assert logs0 == logs1
    for k in state0:
        np.testing.assert_array_equal(state0[k], state1[k], err_msg=k)
    assert set(logs0) == set(want["logs"])
    for k, v in want["logs"].items():
        np.testing.assert_allclose(logs0[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    got = to_jax_params({k: torch.from_numpy(v) for k, v in state0.items()},
                        _cfg(tcfg, objective))
    for coll in ("params", "batch_stats"):
        flat_got = dict(_flat(got[coll]))
        flat_want = dict(_flat(want["state"][coll]))
        assert flat_got.keys() == flat_want.keys()
        for path, w in flat_want.items():
            _close_to_scale(flat_got[path], w, f"{coll}/{'/'.join(path)}")


@pytest.mark.parametrize("objective", JAX_OBJECTIVES)
def test_two_rank_step_matches_one_process_step(steps, objective):
    """The global gradients, logs and the state after the step against one
    process on the global batch."""
    logs, grads, state = steps["one"][objective]
    logs0, grads0, state0 = steps["ranks"][0][objective]
    for k, v in logs.items():
        np.testing.assert_allclose(logs0[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert grads0.keys() == grads.keys()
    for k, g in grads.items():
        _close_to_scale(grads0[k], g, k)
    for k, v in state.items():
        _close_to_scale(state0[k], v, k)


def test_two_rank_bf16_step_is_as_close_to_float32_as_one_process(steps):
    """bfloat16 compute: each rank's products round on its own block, and the
    tiny random model's near-ties amplify last bits, so the two ranks are
    held to the one-process float32 step by tests/test_torch_train_bf16.py's
    rule, the one-process bf16 step's own distance being the yardstick:
    each log within twice it plus 1e-2 of its value; each gradient within
    six times it plus 1e-2 of its scale, nine in ten within twice it. The
    two ranks end bitwise equal."""
    want_logs, want_grads, _ = steps["one"]["dense"]
    one_logs, one_grads, _ = steps["one"]["dense_bf16"]
    (logs0, grads0, state0), (_, _, state1) = (r["dense_bf16"] for r in steps["ranks"])
    for k in state0:
        np.testing.assert_array_equal(state0[k], state1[k], err_msg=k)
    for k, w in want_logs.items():
        assert abs(logs0[k] - w) <= 2 * abs(one_logs[k] - w) + 1e-2 * abs(w), k
    within2, n = 0, 0
    for k, w in want_grads.items():
        scale = np.abs(w).max()
        if scale < 1e-6:  # key-projection biases: an exact gradient of zero
            continue
        got = np.abs(grads0[k] - w).max() / scale
        ref = np.abs(one_grads[k] - w).max() / scale
        assert got <= 6 * ref + 1e-2, (k, got, ref)
        within2 += got <= 2 * ref + 1e-2
        n += 1
    assert within2 >= 0.9 * n, (within2, n)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

VIDEOS = ["1000_mpa", "1001_mpb", "1002_mpc"]


@pytest.fixture(scope="module")
def videos_root(tmp_path_factory):
    """Three 4-frame 48x48 videos of the same frames (so every video keeps
    segments and matches its GT) with test_torch_e2e's GT objects, the
    segmenter's weights and a relation bundle."""
    from PIL import Image

    from chip_smoke import reference_relation_bundle
    from openpvsg_torch.weights import random_state_dict
    from test_torch_e2e import E2E_SETS

    root = tmp_path_factory.mktemp("mp_root")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (48, 48, 3), dtype=np.uint8) for _ in range(4)]
    mask = np.zeros((48, 48), np.uint8)
    mask[8:20, 8:20] = 1
    mask[32:, :] = 2
    for vid in VIDEOS:
        for sub, imgs in (("frames", frames), ("masks", [mask] * 4)):
            d = root / "vidor" / sub / vid
            d.mkdir(parents=True)
            for t, img in enumerate(imgs):
                Image.fromarray(img).save(d / f"{t:04d}.png")
    anno = {"objects": {"thing": ["person", "dog", "cat"], "stuff": ["floor", "wall"]},
            "relations": ["on", "next-to", "holding"],
            "split": {"vidor": {"train": [], "val": VIDEOS},
                      "epic_kitchen": {"train": [], "val": []},
                      "ego4d": {"train": [], "val": []}},
            "data": [{"video_id": vid, "meta": {},
                      "objects": [{"object_id": 1, "category": "dog"},
                                  {"object_id": 2, "category": "floor"}],
                      "relations": [[1, 2, "on", [[0, 3]]]]} for vid in VIDEOS]}
    (root / "pvsg.json").write_text(json.dumps(anno))
    cfg = tcfg.apply_overrides(tcfg.get_config("mask2former_vps"),
                               tcfg.parse_set_args(E2E_SETS))
    state = random_state_dict(cfg.model, 4)
    stats_rng = np.random.default_rng(2)
    for k, v in state.items():
        if k.endswith("running_var"):
            state[k] = torch.from_numpy((1.0 + stats_rng.random(v.shape)).astype(np.float32))
        elif k.endswith("running_mean"):
            state[k] = torch.from_numpy(
                (0.1 * stats_rng.standard_normal(v.shape)).astype(np.float32))
    state["head.cls_embed.bias"][-1] -= 4.0
    torch.save({"model": state}, str(root / "seg.pt"))
    torch.save(reference_relation_bundle(torch, 2, "transformer", heads=2, ffn=64,
                                         temporal_heads=2, temporal_ffn=64,
                                         num_relations=3),
               str(root / "rel.pth"))
    return {"root": str(root), "anno": str(root / "pvsg.json"), "sets": E2E_SETS}


def _run_cli(module, args, ranks=1):
    """The CLI in ``ranks`` processes (through --dist-coordinator when more
    than one) on the CPU; returns their outputs."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = []
    for r in range(ranks):
        dist = ([] if ranks == 1 else
                ["--dist-coordinator", f"localhost:{port}", "--dist-num-processes",
                 str(ranks), "--dist-process-id", str(r)])
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"openpvsg_torch.tools.{module}", *args, *dist,
             "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = _wait(procs)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"{module} rank {r} failed:\n{out[-3000:]}"
    return [out for _, out in outs]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_two_process_prepare_query_tube_vps(videos_root, tmp_path):
    from openpvsg_torch.tools.common import parse_summary

    args = ["--config", "mask2former_vps", "--data-dir", videos_root["root"],
            "--anno-file", videos_root["anno"], "--split", "val",
            "--checkpoint", os.path.join(videos_root["root"], "seg.pt"),
            "--set", *videos_root["sets"]]
    one = tmp_path / "one"
    two = tmp_path / "two"
    _run_cli("prepare_query_tube_vps", args + ["--work-dir", str(one)])
    outs = _run_cli("prepare_query_tube_vps", args + ["--work-dir", str(two)], ranks=2)
    # the ranks strided the videos: 2 and 1
    assert sorted(parse_summary(o)["videos"] for o in outs) == [1, 2]
    for vid in VIDEOS:
        for f in ("quantitive/masks.txt", "query_feats.pickle"):
            a = _read(os.path.join(one, "val_save_qf", vid, f))
            assert _read(os.path.join(two, "val_save_qf", vid, f)) == a, (vid, f)


def test_two_process_end2end_eval(videos_root, tmp_path):
    args = ["--config", "mask2former_vps", "--ps-type", "vps", "--split", "val",
            "--data-dir", videos_root["root"], "--anno-file", videos_root["anno"],
            "--checkpoint", os.path.join(videos_root["root"], "seg.pt"),
            "--relation-checkpoint", os.path.join(videos_root["root"], "rel.pth"),
            "--eval", "--set", *videos_root["sets"]]
    one, two = tmp_path / "one", tmp_path / "two"
    _run_cli("end2end_inference", args + ["--out-dir", str(one)])
    _run_cli("end2end_inference", args + ["--out-dir", str(two)], ranks=2)
    for vid in VIDEOS:
        for f in ("quantitive/masks.txt", "query_feats.pickle", "relations.pickle"):
            assert _read(os.path.join(two, vid, f)) == _read(os.path.join(one, vid, f)), \
                (vid, f)
        with open(os.path.join(one, vid, "triplets.json")) as a, \
                open(os.path.join(two, vid, "triplets.json")) as b:
            want = json.load(a)
            assert json.load(b) == want and want
    with open(one / "protocol_metrics.json") as a, open(two / "protocol_metrics.json") as b:
        assert json.load(b) == json.load(a)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2:])
