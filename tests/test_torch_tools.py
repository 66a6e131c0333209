"""The port's study and data tools (``openpvsg_torch/tools/{unzip_and_extract,
generate_video,show_pred_results,assigner_parity,rel_capacity_study,
stress_reference_scale}.py``) against their JAX twins under ``tools/`` on
the CPU, on the same synthetic inputs:

- ``unzip_and_extract``: the same files, the same md5 refusal;
- ``generate_video`` (no ffmpeg: the GIF path): the same GIF bytes and frames;
- ``show_pred_results``: the same image bytes for every frame;
- ``assigner_parity``: the same fixed batches bit for bit, the same tiny
  model, and the JAX tool's report (its keys and its ``delta``) built from
  the port's fragments at 2 steps;
- ``rel_capacity_study``: the JAX tool, with the port's relation trainer
  and evaluator in place of JAX's, writes the port's artifact (every key,
  every value but the wall times) at 1 epoch of one cell;
- ``stress_reference_scale``: the relation and streaming sections at the
  JAX tool's CPU sizes (a (20, 128) cell; 64 frames of the stub): the JAX
  keys with the documented renames, the same buckets, results and stream
  bookkeeping.

``tests/test_torch_tools_runs.py`` holds the port's ``assigner_parity`` and
``rel_capacity_study`` runs against the JAX tools' own trainers.
"""
import dataclasses
import importlib
import json
import os
import shutil
import sys
import zipfile

import numpy as np
import pytest
import torch

from openpvsg_torch import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One torch thread for this module: its many small CPU ops only wait
    on a thread pool when the suite's workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_tool(name):
    return importlib.import_module(f"tools.{name}")


def _run_jax_main(monkeypatch, name, args):
    tool = _jax_tool(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + args)
    return tool.main()


# ---------------------------------------------------------------------------
# data tools
# ---------------------------------------------------------------------------

def test_unzip_and_extract_matches_jax(tmp_path):
    from openpvsg_torch.tools import unzip_and_extract as port

    jax_tool = _jax_tool("unzip_and_extract")
    archive = str(tmp_path / "a.zip")
    rng = np.random.default_rng(0)
    with zipfile.ZipFile(archive, "w") as z:
        z.writestr("pvsg.json", json.dumps({"data": [1, 2]}))
        z.writestr("frames/v/0000.png", rng.bytes(300))
        z.writestr("frames/v/0001.png", rng.bytes(200))
    md5 = jax_tool.md5sum(archive)
    assert port.md5sum(archive) == md5
    jax_tool.unzip(archive, str(tmp_path / "jax"), md5)
    port.main(["--zip", archive, "--md5", md5, "--out", str(tmp_path / "port")])
    for rel in ("pvsg.json", "frames/v/0000.png", "frames/v/0001.png"):
        with open(tmp_path / "jax" / rel, "rb") as a, open(tmp_path / "port" / rel, "rb") as b:
            assert a.read() == b.read(), rel
    for mod, out in ((jax_tool, "jax_bad"), (port, "port_bad")):
        with pytest.raises(ValueError, match="md5"):
            mod.unzip(archive, str(tmp_path / out), "0" * 32)
        assert not os.path.exists(tmp_path / out)
    if not shutil.which("ffmpeg"):
        for mod in (jax_tool, port):
            with pytest.raises(RuntimeError, match="ffmpeg"):
                mod.extract_frames(archive, str(tmp_path / "frames_out"))


def _frames_dir(root, n=4, hw=(24, 32), seed=1):
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (*hw, 3), dtype=np.uint8)).save(
            os.path.join(root, f"{i:04d}.png"))
    return root


def test_generate_video_gif_matches_jax(tmp_path, monkeypatch):
    """Without ffmpeg both tools write an animated GIF of the PNG frames:
    the same bytes, the same frames."""
    from PIL import Image, ImageSequence

    from openpvsg_torch.tools import generate_video as port

    jax_tool = _jax_tool("generate_video")
    monkeypatch.setattr(jax_tool.shutil, "which", lambda name: None)
    monkeypatch.setattr(port.shutil, "which", lambda name: None)
    frames = _frames_dir(str(tmp_path / "frames"))
    _run_jax_main(monkeypatch, "generate_video", [frames, str(tmp_path / "jax.mp4"), "--fps", "4"])
    port.main([frames, str(tmp_path / "port.mp4"), "--fps", "4"])
    paths = [str(tmp_path / f"{n}.mp4.gif") for n in ("jax", "port")]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    decoded = []
    for p in paths:
        with Image.open(p) as im:
            decoded.append([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)])
    assert len(decoded[0]) == len(decoded[1]) == 4
    for a, b in zip(*decoded):
        np.testing.assert_array_equal(a, b)


def test_show_pred_results_matches_jax(tmp_path, monkeypatch):
    """Overlays of every predicted tube of masks.txt with the labels of the
    top triplets of triplets.json: the same PNG bytes for every frame."""
    from openpvsg_torch.data import io as data_io
    from openpvsg_torch.data import rle as rle_codec
    from openpvsg_torch.data.pvsg import PVSGAnnotation, frame_paths
    from openpvsg_torch.tools import make_synthetic_data
    from openpvsg_torch.tools import show_pred_results as port

    data = str(tmp_path / "data")
    anno = make_synthetic_data.main(["--out", data, "--frames", "4", "--size", "40", "56",
                                     "--train-videos", "0", "--val-videos", "1"])
    vid = PVSGAnnotation(anno).video_ids("val")[0]
    n = len(frame_paths(data, vid, "frames"))
    work = tmp_path / "work"
    rng = np.random.default_rng(3)
    results = []
    for f in range(1, n + 1):
        rles, tids = [], []
        for tid in (1, 2, 5):
            m = np.zeros((40, 56), np.uint8)
            y, x = int(rng.integers(0, 30)), int(rng.integers(0, 40))
            m[y:y + 10, x:x + 16] = 1
            rle = rle_codec.encode(m)
            rle["class_id"] = tid + 1
            rles.append(rle)
            tids.append(tid)
        results.append((f, rles, tids))
    data_io.write_masks_txt(str(work / vid / "quantitive" / "masks.txt"), results)
    with open(work / vid / "triplets.json", "w") as f:
        json.dump([{"subject_tube": 1, "relation_name": "on", "object_tube": 2},
                   {"subject_tube": 5, "relation_name": "near", "object_tube": 1}], f)
    common = ["--work-dir", str(work), "--data-dir", data, "--video", vid, "--top", "2"]
    _run_jax_main(monkeypatch, "show_pred_results", common + ["--out-dir", str(tmp_path / "jax")])
    port.main(common + ["--out-dir", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == n
    for name in names:
        with open(tmp_path / "jax" / name, "rb") as a, open(tmp_path / "port" / name, "rb") as b:
            assert a.read() == b.read(), name


# ---------------------------------------------------------------------------
# study tools
# ---------------------------------------------------------------------------

def test_assigner_parity_matches_jax(tmp_path, monkeypatch):
    """The same tiny model and the same fixed batches (bitwise); the port's
    report at 2 steps on the CPU carries the JAX tool's keys, and the JAX
    tool's report, built from the port's fragments, has the port's
    ``delta``."""
    import subprocess

    from openpvsg_tpu import config as jcfg
    from openpvsg_torch.data.synthetic import make_dataset
    from openpvsg_torch.tools import assigner_parity as port

    jax_tool = _jax_tool("assigner_parity")
    root = str(tmp_path / "data")
    make_dataset(root, n_train=3, n_val=1, n_frames=10, h=96, w=96, seed=0)
    for a in port.ASSIGNERS:
        assert (dataclasses.asdict(port.tiny_cfg(a))
                == dataclasses.asdict(jax_tool.tiny_cfg(a)))
        assert isinstance(jax_tool.tiny_cfg(a), jcfg.Mask2FormerConfig)
    _, want = jax_tool.build_batches(root, 3, 2, seed=1)
    _, got = port.build_batches(root, 3, 2, seed=1)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)

    out = str(tmp_path / "port.json")
    port.main(["--steps", "2", "--batch", "2", "--out", out, "--data-root", root,
               "--device", "cpu"])
    with open(out) as f:
        report = json.load(f)
    jax_keys = {"loss_first10", "loss_last10", "loss_curve_every10", "PQ", "PQ_th", "PQ_st"}
    for a in port.ASSIGNERS:
        assert jax_keys <= set(report[a])
        assert all(np.isfinite(report[a]["loss_curve_every10"]))

    # the JAX tool's main, its per-assigner subprocesses replaced by the
    # port's fragments
    def fake_run(cmd, check, env):
        name = cmd[cmd.index("--only") + 1]
        with open(f"{cmd[cmd.index('--out') + 1]}.{name}", "w") as f:
            json.dump({k: report[name][k] for k in jax_keys}, f)

    monkeypatch.setattr(subprocess, "run", fake_run)
    jax_out = str(tmp_path / "jax.json")
    _run_jax_main(monkeypatch, "assigner_parity", ["--steps", "2", "--batch", "2",
                                                   "--out", jax_out, "--data-root", root])
    with open(jax_out) as f:
        jax_report = json.load(f)
    assert set(jax_report) <= set(report)
    assert jax_report["delta"] == report["delta"]


def test_rel_capacity_study_matches_jax(tmp_path, monkeypatch):
    """One cell (transformer, tiny) at 1 epoch on a rich synthetic set with
    oracle stage 2: the JAX tool, given the port's trainer and evaluator,
    writes the port tool's artifact, every key and every value but the
    wall times."""
    import openpvsg_tpu.eval.rel_eval as jax_rel_eval
    import openpvsg_tpu.train.relation as jax_relation
    from openpvsg_torch.eval.rel_eval import evaluate
    from openpvsg_torch.tools import make_synthetic_data, prepare_rel_set
    from openpvsg_torch.tools import rel_capacity_study as port
    from openpvsg_torch.train.relation import RelationTrainer

    data, work = str(tmp_path / "data"), str(tmp_path / "work")
    anno = make_synthetic_data.main([
        "--out", data, "--style", "rich", "--train-videos", "2", "--val-videos", "1",
        "--frames", "10", "--size", "48", "64", "--oracle-stage2", work, "--seed", "3"])
    common = ["--data-dir", data, "--anno-file", anno, "--work-dir", work]
    for split in ("train", "val"):
        prepare_rel_set.main(common + ["--split", split])
    jax_work = str(tmp_path / "jax_work")
    shutil.copytree(work, jax_work)
    args = ["--data-dir", data, "--anno-file", anno, "--variants", "transformer",
            "--capacities", "tiny", "--epochs", "1", "--accum", "2"]
    out = str(tmp_path / "port.json")
    port.main(args + ["--work-dir", work, "--out", out, "--device", "cpu"])

    class PortTrainer:
        def __init__(self, cfg, relation_count, rng_seed=0):
            tc = tcfg.RelationHeadConfig(**dataclasses.asdict(cfg))
            self._t = RelationTrainer(tc, relation_count, rng_seed=rng_seed, device="cpu")
            self.model = self._t.model
            self.params = [p.detach().numpy() for p in self._t.params]

        def step(self, feats, relations):
            return self._t.step(feats, relations)

        def flush(self):
            self._t.flush()

    monkeypatch.setattr(jax_relation, "RelationTrainer", PortTrainer)
    monkeypatch.setattr(jax_rel_eval, "evaluate",
                        lambda model, params, items, k, names: evaluate(model, items, k, names))
    jax_out = str(tmp_path / "jax.json")
    _run_jax_main(monkeypatch, "rel_capacity_study", args + ["--work-dir", jax_work,
                                                             "--out", jax_out])
    with open(out) as f:
        got = json.load(f)
    with open(jax_out) as f:
        want = json.load(f)
    assert got.keys() == want.keys() and len(got["cells"]) == 1
    for g, w in zip(got["cells"], want["cells"]):
        assert g.keys() == w.keys()
        g.pop("train_s"), w.pop("train_s")
        assert g == w
    got.pop("cells"), want.pop("cells")
    assert got == want


def test_stress_reference_scale_matches_jax():
    """The relation and streaming sections at the JAX tool's CPU sizes: the
    JAX report's keys (``compile_s`` -> ``first_call_s``, XLA's
    ``hbm_*_mb`` -> ``device_peak_mb``, plus the kernels' ``launches`` and
    the stream's segmenter and frame size), the same buckets and result
    counts, the same stream bookkeeping, and the step's counted GFLOP
    within 2% of XLA's."""
    from openpvsg_torch.tools import stress_reference_scale as port

    jax_tool = _jax_tool("stress_reference_scale")
    want, got = {}, {}
    jax_tool.stress_relation(want, False)
    jax_tool.stress_streaming(want, False, total_frames=64, max_history=64)
    dev = torch.device("cpu")
    port.stress_relation(got, dev)
    port.stress_streaming(got, dev, total_frames=64, max_history=64)
    renames = {"compile_s": "first_call_s", "hbm_args_mb": "device_peak_mb",
               "hbm_temp_mb": "device_peak_mb", "hbm_out_mb": "device_peak_mb"}
    assert got["relation"].keys() == want["relation"].keys() == {"N20_T128"}
    g, w = got["relation"]["N20_T128"], want["relation"]["N20_T128"]
    assert set(g) == {renames.get(k, k) for k in w}
    for k in ("tube_bucket", "frame_bucket", "pair_bucket", "eval_results"):
        assert g[k] == w[k], k
    assert abs(g["gflops"] - w["gflops"]) <= 0.02 * w["gflops"]
    gs, ws = got["streaming"], want["streaming"]
    assert set(gs) == set(ws) | {"segmenter", "frame_hw", "device_peak_mb", "launches"}
    for k in ("total_frames", "n_tubes", "max_history", "relation_interval",
              "device_history", "intervals_scored", "tube_state_frames_max",
              "tube_state_bound", "num_tubes_final"):
        assert gs[k] == ws[k], k
    assert gs["segmenter"] == "stub" and not any(gs["launches"].values())
