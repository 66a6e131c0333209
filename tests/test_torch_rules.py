"""Rules of the PyTorch port that hold whatever the numbers: it imports no
JAX, it runs on the GPU unless asked for the CPU, its kernel wrappers never
fall back, and its weight converter refuses trees that do not fit."""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "openpvsg_tpu")


# the root scripts of the JAX package, and the one root script of the port
# that reads JAX checkpoints: it imports openpvsg_tpu and orbax by design
JAX_ROOT_SCRIPTS = ("__graft_entry__.py", "bench.py")
JAX_EXPORT_SCRIPT = "export_jax_checkpoint.py"


def _port_files():
    """The port's sources: the root scripts (chip_smoke.py,
    multi_gpu_torch.py, profile_torch.py; every root script but the JAX
    package's and the export script) and openpvsg_torch/ with its tools and
    utils, without its git-ignored build/ directory (kernel libraries and
    build outputs)."""
    files = [os.path.join(REPO, n) for n in os.listdir(REPO)
             if n.endswith(".py") and n not in JAX_ROOT_SCRIPTS + (JAX_EXPORT_SCRIPT,)]
    for root, dirs, names in os.walk(os.path.join(REPO, "openpvsg_torch")):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _module_names():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)
        if rel.startswith("openpvsg_torch"):
            mod = rel[:-3].replace(os.sep, ".")
            mods.append(mod[:-len(".__init__")] if mod.endswith("__init__") else mod)
    return mods


def test_import_leaves_jax_out():
    """A fresh interpreter imports the port, every submodule, chip_smoke,
    multi_gpu_torch and profile_torch with no jax, flax or openpvsg_tpu
    module loaded."""
    code = (
        "import importlib, sys\n"
        "pre = {m.split('.')[0] for m in sys.modules}\n"
        f"assert not pre & set({FORBIDDEN!r}), pre & set({FORBIDDEN!r})\n"
        f"for m in {_module_names()!r} + ['chip_smoke', 'multi_gpu_torch', 'profile_torch']:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_port_files_cover_the_new_modules_and_leave_out_only_the_export():
    """The scans below cover every root script of the port, the port's
    tools and utils/quantize.py; the export script is the one file of the
    port outside them, and it is what reads orbax."""
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {"chip_smoke.py", "multi_gpu_torch.py", "profile_torch.py",
            "openpvsg_torch/utils/quantize.py"} <= rel
    for tool in ("unzip_and_extract", "generate_video", "show_pred_results",
                 "assigner_parity", "rel_capacity_study", "stress_reference_scale"):
        assert f"openpvsg_torch/tools/{tool}.py" in rel
    assert JAX_EXPORT_SCRIPT not in rel
    with open(os.path.join(REPO, JAX_EXPORT_SCRIPT)) as f:
        assert "orbax" in f.read()


def test_ast_scan_finds_no_jax_import():
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def _tiny_cfg():
    from openpvsg_torch.config import (BackboneConfig, Mask2FormerConfig,
                                       PixelDecoderConfig,
                                       TransformerDecoderConfig)

    return Mask2FormerConfig(
        num_things_classes=3, num_stuff_classes=2, num_queries=8,
        backbone=BackboneConfig(depth=26),
        pixel_decoder=PixelDecoderConfig(encoder_layers=1, ffn_channels=64),
        decoder=TransformerDecoderConfig(num_layers=3, ffn_channels=64))


def test_segmenter_defaults_to_the_gpu():
    """Without a GPU, a default SegmenterInference raises instead of running
    on the CPU; device='cpu' runs."""
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.weights import random_state_dict

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = _tiny_cfg()
    state = random_state_dict(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SegmenterInference(cfg, state)
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmenterInference(cfg, state, device="cuda")
    seg = SegmenterInference(cfg, state, device="cpu")
    cls, masks, query = seg.forward_frames(np.zeros((1, 64, 64, 3), np.uint8))
    assert cls.shape == (1, 8, 6) and masks.shape == (1, 8, 16, 16)
    assert query.shape == (1, 8, 256) and cls.device.type == "cpu"


def test_trainer_defaults_to_the_gpu():
    """A default SegmenterTrainer raises without a GPU instead of training
    on the CPU; device='cpu' builds."""
    from openpvsg_torch.config import TrainConfig
    from openpvsg_torch.train.segmenter import SegmenterTrainer

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SegmenterTrainer(_tiny_cfg(), TrainConfig())
    tr = SegmenterTrainer(_tiny_cfg(), TrainConfig(), device="cpu")
    assert {p.device.type for p in tr.model.parameters()} == {"cpu"}


def test_trainer_steps_in_ieee_float32():
    """The trainer's forward and backward run with TF32 off whatever the
    caller set, and the caller's settings come back after the step."""
    from openpvsg_torch.config import TrainConfig
    from openpvsg_torch.train.segmenter import SegmenterTrainer

    def flags():
        return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32

    tr = SegmenterTrainer(_tiny_cfg(), TrainConfig(), device="cpu")
    seen = []
    tr.model.register_forward_pre_hook(lambda *_: seen.append(flags()))
    tr.params[0].register_hook(lambda g: seen.append(flags()))
    masks = np.zeros((1, 2, 1, 16, 16), np.uint8)
    masks[0, 0, :, :8], masks[0, 1, :, 8:] = 1, 1
    batch = {"images": np.zeros((1, 1, 64, 64, 3), np.uint8),
             "gt_labels": np.array([[1, 3]], np.int32), "gt_masks": masks,
             "gt_valid": np.ones((1, 2), bool)}
    saved = flags()
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        tr.step(batch)
        assert seen == [(False, False)] * 2
        assert flags() == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc means a launch raises; nothing falls back to a plain version."""
    from openpvsg_torch.kernels import build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


def test_from_jax_params_raises_on_missing_and_extra_keys():
    from openpvsg_torch.weights import from_jax_params, random_state_dict

    cfg = _tiny_cfg()
    state = random_state_dict(cfg, 0)
    # the inverse layout map: rebuild a flax-shaped tree from the state dict
    params, stats = {}, {}
    for key, t in state.items():
        *scope, leaf = key.split(".")
        arr = t.numpy()
        coll = params
        if leaf in ("running_mean", "running_var"):
            coll, leaf = stats, leaf[len("running_"):]
        elif leaf == "weight" and arr.ndim == 4:
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif leaf == "weight" and arr.ndim == 2:
            leaf, arr = "kernel", arr.T
        elif leaf == "weight":
            leaf = "scale"
        d = coll
        for s in scope:
            d = d.setdefault(s, {})
        d[leaf] = arr
    tree = {"params": params, "batch_stats": stats}
    back = from_jax_params(tree, cfg)
    assert back.keys() == state.keys()
    for k in state:
        torch.testing.assert_close(back[k], state[k], rtol=0, atol=0)

    extra = {"params": {**params, "head": {**params["head"],
                                           "layer_3": params["head"]["layer_0"]}},
             "batch_stats": stats}
    with pytest.raises(ValueError, match=r"^from_jax_params: \d+ keys the "
                                         r"configured model does not use[^;]*$"):
        from_jax_params(extra, cfg)
    missing = {"params": {k: v for k, v in params.items() if k != "head"},
               "batch_stats": stats}
    with pytest.raises(ValueError, match=r"^from_jax_params: \d+ keys the "
                                         r"tree lacks[^;]*$"):
        from_jax_params(missing, cfg)


def _tiny_relation_cfg():
    from openpvsg_torch.config import RelationHeadConfig

    return RelationHeadConfig(d_model=32, encoder_heads=2, encoder_ffn=48,
                              temporal_heads=2, temporal_ffn=40, num_relations=5)


def test_relation_trainer_defaults_to_the_gpu():
    """A default RelationTrainer raises without a GPU instead of training
    on the CPU; device='cpu' builds."""
    from openpvsg_torch.train.relation import RelationTrainer

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RelationTrainer(_tiny_relation_cfg(), np.ones(5))
    tr = RelationTrainer(_tiny_relation_cfg(), np.ones(5), device="cpu")
    assert {p.device.type for p in tr.model.parameters()} == {"cpu"}


def test_relation_step_runs_in_ieee_float32():
    """The relation trainer's forward and backward run with TF32 off
    whatever the caller set; the caller's settings come back after."""
    from openpvsg_torch.train.relation import RelationTrainer

    def flags():
        return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32

    tr = RelationTrainer(_tiny_relation_cfg(), np.ones(5), device="cpu")
    seen = []
    tr.model.register_forward_pre_hook(lambda *_: seen.append(flags()))
    tr.params[0].register_hook(lambda g: seen.append(flags()))
    span = np.zeros(12)
    span[2:9] = 1
    rels = [{"subject_index": 0, "object_index": 2, "relation": 3,
             "relation_span": span}]
    saved = flags()
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        assert tr.step(np.ones((4, 12, 32), np.float32), rels) is not None
        assert seen == [(False, False)] * 2
        assert flags() == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_query_feats_loader_maps_simple_tube_and_refuses_other_jax_classes(tmp_path):
    """Pickles naming openpvsg_tpu's SimpleTube (VPS) and QueryFeatTube (IPS)
    load as the port's classes of the same names, in a fresh interpreter
    that never imports openpvsg_tpu; any other class of the JAX package is
    refused. The pickles are written by hand (protocol 0 GLOBAL opcodes), so
    this test imports no JAX either."""
    simple = tmp_path / "simple.pickle"
    simple.write_bytes(b"copenpvsg_tpu.tracker.tubes\nSimpleTube\n.")
    tube = tmp_path / "tube.pickle"
    tube.write_bytes(b"copenpvsg_tpu.tracker.tubes\nQueryFeatTube\n.")
    other = tmp_path / "other.pickle"
    other.write_bytes(b"copenpvsg_tpu.tracker.tracks\nSTrack\n.")
    code = (
        "import pickle, sys\n"
        "from openpvsg_torch.data.io import load_pickle\n"
        "from openpvsg_torch.tracker.tubes import QueryFeatTube, SimpleTube\n"
        f"assert load_pickle({str(simple)!r}) is SimpleTube\n"
        f"assert load_pickle({str(tube)!r}) is QueryFeatTube\n"
        "try:\n"
        f"    load_pickle({str(other)!r})\n"
        "except pickle.UnpicklingError as e:\n"
        "    assert 'STrack' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('STrack was not refused')\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'openpvsg_tpu']\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_port_clis_load_no_jax(tmp_path):
    """``python -m openpvsg_torch.tools.{make_synthetic_data,
    pack_train_cache,train,test}`` run on the CPU at a tiny size, each in a
    fresh interpreter; ``-X importtime`` lists every module each loaded, and
    none is jax, flax or openpvsg_tpu."""
    data, work = str(tmp_path / "data"), str(tmp_path / "work")
    tiny = ["--set", "model.backbone.depth=26", "model.num_queries=8",
            "model.num_things_classes=5", "model.num_stuff_classes=3",
            "model.decoder.num_layers=1", "model.decoder.ffn_channels=32",
            "model.pixel_decoder.encoder_layers=1",
            "model.pixel_decoder.ffn_channels=32", "data.train_scale=32,32",
            "data.crop_size=32,32", "train.samples_per_gpu=4"]
    common = ["--config", "mask2former_vps", "--data-dir", data,
              "--anno-file", os.path.join(data, "pvsg.json"), "--work-dir", work,
              "--device", "cpu"]
    runs = [("make_synthetic_data", ["--out", data, "--train-videos", "1",
                                     "--val-videos", "1", "--frames", "2",
                                     "--size", "32", "32"]),
            ("pack_train_cache", common + tiny),
            ("train", common + ["--epochs", "1"] + tiny),
            ("test", common + ["--eval", "PQ,VPQ"] + tiny)]
    for name, args in runs:
        out = subprocess.run(
            [sys.executable, "-X", "importtime", "-m", f"openpvsg_torch.tools.{name}",
             *args], cwd=REPO, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, (name, out.stderr[-2000:])
        loaded = {ln.split("|")[-1].strip() for ln in out.stderr.splitlines()
                  if ln.startswith("import time:")}
        assert ("openpvsg_torch.data.synthetic" if name == "make_synthetic_data"
                else "openpvsg_torch.tools.common") in loaded
        bad = sorted(m for m in loaded if m.split(".")[0] in FORBIDDEN)
        assert not bad, (name, bad)
    assert os.path.exists(os.path.join(work, "mask2former_vps", "epoch_1"))


def test_ast_scan_covers_the_tracker_and_mot_metrics():
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    for name in ("kalman", "tracks", "matching", "appearance", "zoo", "tracker",
                 "variants", "tubes"):
        assert os.path.join("openpvsg_torch", "tracker", f"{name}.py") in scanned
    assert os.path.join("openpvsg_torch", "eval", "mot_metrics.py") in scanned


def test_ast_scan_covers_the_sampling_ops():
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    assert os.path.join("openpvsg_torch", "ops", "sampling.py") in scanned


def test_ast_scan_covers_the_layers_metric_and_profiling():
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    for rel in (("models", "layers.py"), ("eval", "metric.py"),
                ("utils", "profiling.py")):
        assert os.path.join("openpvsg_torch", *rel) in scanned


def test_reference_model_clis_load_no_jax(tmp_path):
    """The train CLI for one epoch and the test CLI with the reference's
    model and objective (``encoder=msda``, ``loss_sampling=points``,
    ``split_thing_stuff``) through ``--set`` alone, on the CPU at a tiny
    size, each in a fresh interpreter that loads no jax, flax or
    openpvsg_tpu module and ends its log with a ``summary:`` line."""
    from openpvsg_torch.tools import make_synthetic_data
    from openpvsg_torch.tools.common import parse_summary

    data, work = str(tmp_path / "data"), str(tmp_path / "work")
    make_synthetic_data.main(["--out", data, "--train-videos", "1", "--val-videos",
                              "1", "--frames", "2", "--size", "32", "32"])
    tiny = ["--set", "model.backbone.depth=26", "model.num_queries=8",
            "model.num_things_classes=5", "model.num_stuff_classes=3",
            "model.decoder.num_layers=1", "model.decoder.ffn_channels=32",
            "model.pixel_decoder.encoder=msda", "model.pixel_decoder.encoder_layers=1",
            "model.pixel_decoder.ffn_channels=32", "model.loss_sampling=points",
            "model.num_points=64", "model.split_thing_stuff=true",
            "data.train_scale=32,32", "data.crop_size=32,32", "train.samples_per_gpu=4"]
    common = ["--config", "mask2former_vps", "--data-dir", data,
              "--anno-file", os.path.join(data, "pvsg.json"), "--work-dir", work,
              "--device", "cpu"]
    for name, args in (("train", common + ["--epochs", "1"] + tiny),
                       ("test", common + ["--eval", "PQ,VPQ"] + tiny)):
        out = subprocess.run(
            [sys.executable, "-X", "importtime", "-m", f"openpvsg_torch.tools.{name}",
             *args], cwd=REPO, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, (name, out.stderr[-2000:])
        loaded = {ln.split("|")[-1].strip() for ln in out.stderr.splitlines()
                  if ln.startswith("import time:")}
        assert {"openpvsg_torch.ops.sampling", "openpvsg_torch.tools.common"} <= loaded
        bad = sorted(m for m in loaded if m.split(".")[0] in FORBIDDEN)
        assert not bad, (name, bad)
        summary = parse_summary(out.stderr)
        assert summary, name
    with open(os.path.join(work, "mask2former_vps", "config.json")) as f:
        saved = json.load(f)
    assert saved["model"]["pixel_decoder"]["encoder"] == "msda"
    assert saved["model"]["loss_sampling"] == "points"
    assert saved["model"]["split_thing_stuff"] is True


def test_swin_and_training_option_clis_load_no_jax(tmp_path):
    """``--config mask2former_swin_vps`` with the trainer's options through
    ``--set`` (LAPJV, pooled matching, the target layout, bfloat16 mask
    logits, focal, the semantic head): the train CLI for one epoch, the
    test CLI and VPS stage 2 on its checkpoint, on the CPU at 32x32, each
    in a fresh interpreter that loads no jax, flax or openpvsg_tpu module
    and ends its log with a ``summary:`` line."""
    from openpvsg_torch.tools import make_synthetic_data
    from openpvsg_torch.tools.common import parse_summary

    data, work = str(tmp_path / "data"), str(tmp_path / "work")
    anno = make_synthetic_data.main(["--out", data, "--train-videos", "1",
                                     "--val-videos", "1", "--frames", "2",
                                     "--size", "32", "32"])
    sets = ["--set", "model.num_queries=8", "model.num_things_classes=5",
            "model.num_stuff_classes=3", "model.decoder.num_layers=1",
            "model.decoder.ffn_channels=32", "model.pixel_decoder.encoder_layers=1",
            "model.pixel_decoder.ffn_channels=32", "model.assigner=lapjv",
            "model.match_downsample=2", "model.loss_layout=target",
            "model.mask_logits_dtype=bfloat16", "model.focal_cls=true",
            "model.with_sem_seg=true", "data.train_scale=32,32",
            "data.crop_size=32,32", "train.samples_per_gpu=4"]
    common = ["--config", "mask2former_swin_vps", "--data-dir", data,
              "--anno-file", anno, "--work-dir", work, "--device", "cpu"]
    ckpt = os.path.join(work, "mask2former_swin_vps", "epoch_1")
    for name, args in (("train", common + ["--epochs", "1", "--max-instances", "8"]
                        + sets),
                       ("test", common + ["--eval", "PQ,VPQ", "--checkpoint", ckpt]
                        + sets),
                       ("prepare_query_tube_vps", common + ["--split", "val",
                                                            "--checkpoint", ckpt]
                        + sets)):
        out = subprocess.run(
            [sys.executable, "-X", "importtime", "-m", f"openpvsg_torch.tools.{name}",
             *args], cwd=REPO, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, (name, out.stderr[-2000:])
        loaded = {ln.split("|")[-1].strip() for ln in out.stderr.splitlines()
                  if ln.startswith("import time:")}
        assert {"openpvsg_torch.models.swin", "openpvsg_torch.tools.common"} <= loaded
        bad = sorted(m for m in loaded if m.split(".")[0] in FORBIDDEN)
        assert not bad, (name, bad)
        assert parse_summary(out.stderr), name
    with open(os.path.join(work, "mask2former_swin_vps", "config.json")) as f:
        saved = json.load(f)["model"]
    assert saved["backbone"]["kind"] == "swin"
    assert (saved["assigner"], saved["loss_layout"]) == ("lapjv", "target")
    assert os.path.exists(os.path.join(work, "val_save_qf", "1001_synth1",
                                       "query_feats.pickle"))


def test_stage2_clis_load_no_jax(tmp_path):
    """``python -m openpvsg_torch.tools.{prepare_query_tube_ips,
    prepare_query_tube_vps,eval_mots}`` on the CPU at a tiny size, each in a
    fresh interpreter that loads no jax, flax or openpvsg_tpu module."""
    from openpvsg_torch.tools import make_synthetic_data

    data, work = str(tmp_path / "data"), str(tmp_path / "work")
    anno = make_synthetic_data.main(["--out", data, "--train-videos", "0",
                                     "--val-videos", "1", "--frames", "2",
                                     "--size", "32", "32"])
    tiny = ["--set", "model.backbone.depth=26", "model.num_queries=8",
            "model.num_things_classes=5", "model.num_stuff_classes=3",
            "model.decoder.num_layers=1", "model.decoder.ffn_channels=32",
            "model.pixel_decoder.encoder_layers=1",
            "model.pixel_decoder.ffn_channels=32", "model.object_mask_thr=0.0",
            "tracker.appearance_depth=26"]
    common = ["--data-dir", data, "--anno-file", anno, "--work-dir", work,
              "--split", "val"]
    runs = [("prepare_query_tube_ips", common + ["--device", "cpu"] + tiny),
            ("prepare_query_tube_vps", common + ["--device", "cpu", "--config",
                                                 "mask2former_vps"] + tiny),
            ("eval_mots", common)]
    for name, args in runs:
        out = subprocess.run(
            [sys.executable, "-X", "importtime", "-m", f"openpvsg_torch.tools.{name}",
             *args], cwd=REPO, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, (name, out.stderr[-2000:])
        loaded = {ln.split("|")[-1].strip() for ln in out.stderr.splitlines()
                  if ln.startswith("import time:")}
        assert "openpvsg_torch.tools.common" in loaded
        bad = sorted(m for m in loaded if m.split(".")[0] in FORBIDDEN)
        assert not bad, (name, bad)
    out_dir = os.path.join(work, "val_save_qf", "1000_synth0")
    assert os.path.exists(os.path.join(out_dir, "query_feats.pickle"))


def test_tracker_defaults_to_the_gpu():
    """A default MaskAssociationTracker (and its embedding variant) raises
    without a GPU instead of running on the CPU; device='cpu' builds, with
    the appearance encoder on the CPU."""
    from openpvsg_torch.config import TrackerConfig
    from openpvsg_torch.tracker.tracker import MaskAssociationTracker
    from openpvsg_torch.tracker.variants import EmbedAssociationTracker
    from openpvsg_torch.weights import random_appearance_state_dict

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = TrackerConfig(appearance_depth=26)
    state = random_appearance_state_dict(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MaskAssociationTracker(cfg, state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EmbedAssociationTracker(cfg)
    tr = MaskAssociationTracker(cfg, state, device="cpu")
    assert {p.device.type for p in tr.appearance_model.parameters()} == {"cpu"}


def test_tracker_device_work_runs_in_ieee_float32(monkeypatch):
    """The appearance encoder and the reconsdot cost run with TF32 off
    whatever the caller set; the caller's settings come back after."""
    from openpvsg_torch.config import TrackerConfig
    from openpvsg_torch.tracker import matching
    from openpvsg_torch.tracker.tracker import MaskAssociationTracker
    from openpvsg_torch.weights import random_appearance_state_dict

    def flags():
        return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32

    cfg = TrackerConfig(appearance_depth=26)
    tr = MaskAssociationTracker(cfg, random_appearance_state_dict(cfg, 0), device="cpu")
    seen = []
    tr.appearance_model.register_forward_pre_hook(lambda *_: seen.append(flags()))
    reconsdot = matching._reconsdot
    monkeypatch.setattr(matching, "_reconsdot",
                        lambda *a, **k: seen.append(flags()) or reconsdot(*a, **k))
    masks = np.zeros((2, 32, 32), np.uint8)
    masks[0, :16], masks[1, 16:] = 1, 1
    qf = [{"query_feat": np.zeros(4, np.float32), "cls_id": 0}] * 2
    saved = flags()
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        frame = np.zeros((32, 32, 3), np.uint8)
        tr.update(frame, masks, qf)
        tr.update(frame, masks, qf)  # tracks and detections: the cost runs
        assert seen == [(False, False)] * 3
        assert flags() == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


NEW_SERVING_TOOLS = ("prepare_rel_set", "rel_train", "rel_test", "rel_test_full",
                     "end2end_inference")


def test_relation_and_end2end_clis_load_no_jax():
    """A fresh interpreter imports the streaming engine and runs each stage
    3-5 and end-to-end CLI's ``--help`` with no jax, flax or openpvsg_tpu
    module loaded; the AST scan covers their files."""
    code = (
        "import importlib, sys\n"
        "import openpvsg_torch.infer.streaming\n"
        f"for name in {NEW_SERVING_TOOLS!r}:\n"
        "    tool = importlib.import_module('openpvsg_torch.tools.' + name)\n"
        "    try:\n"
        "        tool.main(['--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (name, e.code)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("usage:") == len(NEW_SERVING_TOOLS)
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    for name in NEW_SERVING_TOOLS:
        assert os.path.join("openpvsg_torch", "tools", f"{name}.py") in scanned
    assert os.path.join("openpvsg_torch", "infer", "streaming.py") in scanned


def test_streaming_and_end2end_default_to_the_gpu(tmp_path):
    """Without a GPU, the streaming engine (whose device is its
    segmenter's) and end2end_inference without --device raise instead of
    running on the CPU; with the CPU asked for, the engine's ring and
    relation model live there."""
    from openpvsg_torch.config import RelationHeadConfig
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.infer.streaming import StreamingPVSG
    from openpvsg_torch.models.relation.heads import RelationModel
    from openpvsg_torch.tools import end2end_inference
    from openpvsg_torch.weights import random_state_dict

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = _tiny_cfg()
    state = random_state_dict(cfg, 0)
    rel = RelationModel.from_config(RelationHeadConfig(encoder_heads=2, encoder_ffn=64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingPVSG(SegmenterInference(cfg, state), rel)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        end2end_inference.main(["--out-dir", str(tmp_path)])
    engine = StreamingPVSG(SegmenterInference(cfg, state, device="cpu"), rel)
    assert engine._ring.hist.device.type == "cpu"
    assert {p.device.type for p in rel.parameters()} == {"cpu"}


def test_parallel_loads_no_jax():
    """``openpvsg_torch.parallel`` (mesh, sp, tp) imports in a fresh
    interpreter, builds a mesh of CPU replicas and a time-sharded relation
    executor, and loads no jax, flax or openpvsg_tpu module; the AST scan
    covers its files."""
    code = (
        "import sys\n"
        "from openpvsg_torch.models.relation.heads import RelationModel\n"
        "from openpvsg_torch.parallel import make_mesh, mesh, sp, tp\n"
        "m = make_mesh(n_data=2, n_time=2, devices=['cpu'] * 4)\n"
        "tp.TimeShardedRelation(m, RelationModel(feature_dim=32, encoder_heads=2))\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    for name in ("__init__", "mesh", "sp", "tp"):
        assert os.path.join("openpvsg_torch", "parallel", f"{name}.py") in scanned


def test_mesh_and_distributed_runs_default_to_the_gpu():
    """Without a GPU a mesh of the default devices, a process group without
    ``device='cpu'`` and a segmenter over a CUDA mesh raise instead of
    running on the CPU."""
    from openpvsg_torch.parallel.mesh import Mesh, init_distributed, make_mesh

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(n_data=2, devices=["cuda:0", "cuda:1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed("tcp://localhost:1", world_size=1, rank=0)
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.weights import random_state_dict

    cfg = _tiny_cfg()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SegmenterInference(cfg, random_state_dict(cfg, 0),
                           mesh=Mesh([[torch.device("cuda", 0)]]))
