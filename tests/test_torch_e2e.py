"""The port's stage 3-5 CLIs and its end-to-end CLI against the JAX
package's on the CPU, and the reference's relation bundle converter:

- ``convert_relation_bundle`` against ``relation_from_jax_params`` of the
  JAX package's converter, key for key and bitwise, on synthetic bundles of
  torch modules in the reference's layout (``tests/test_convert.py:70``), for
  the transformer and the conv heads; a key absent or left over raises;
- ``prepare_rel_set``: the ``relations.pickle`` of every video equal in
  content to the JAX tool's, on a ``make_synthetic_data --style rich
  --oracle-stage2`` root (2 train and 2 val videos of 12 48x64 frames);
- ``rel_test`` and ``rel_test_full`` on one reference-format ``.pth``
  bundle (d 256, 2 heads, FFN 64, 8 relations through ``--set
  relation.*``): the printed metric lines and the CSV row equal to the JAX
  tools';
- ``rel_train`` for 1 epoch: exit 0, checkpoint and ``result.csv``, the
  epoch's data order equal to the JAX tool's permutation, and ``rel_test``
  of the checkpoint it wrote;
- ``end2end_inference --eval`` (VPS) against the JAX tool on the micro
  dataset of ``tests/test_tools_cli.py:19``, on the same segmenter weights
  (a JAX ``save_checkpoint`` and the port's ``{"model": from_jax_params}``
  file) and one shared relation bundle: ``masks.txt`` byte-identical,
  ``query_feats.pickle`` within 1e-5 of scale, ``triplets.json`` equal
  wherever adjacent scores are more than 1e-4 apart (the scores are the
  port's relation head's on the port's tubes), ``protocol_metrics.json``
  equal; the port's IPS run on its own writes its files.

The JAX tools run in this process (``sys.argv`` patched), on their
single-device path: their ``maybe_mesh`` is patched to return None, since
the test process shows JAX 8 virtual CPU devices, while the port's CLIs on
the CPU (``--device cpu``) see one device and build no mesh; the mesh
paths are held to JAX in tests/test_torch_parallel.py and
tests/test_torch_multiprocess.py.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import reference_relation_bundle  # noqa: E402

RANK_TOL = 1e-4
FEAT_TOL = 1e-5
# the relation head of the CLI tests: the stage-2 features' 256 channels,
# 2 heads, FFN 64
REL_SETS = ["relation.encoder_heads=2", "relation.encoder_ffn=64",
            "relation.temporal_heads=2", "relation.temporal_ffn=64"]


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One torch thread for this module: its many small CPU ops only wait
    on a thread pool when the suite's workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def reference_bundle(model_name, seed=0, **widths):
    """The reference's relation ``.pth`` bundle, built by the one builder
    chip_smoke.py also writes its bundle with."""
    return reference_relation_bundle(torch, seed, model_name, **widths)


# ---------------------------------------------------------------------------
# the relation bundle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_name", ["transformer", "conv"])
def test_convert_relation_bundle_matches_jax(model_name):
    from openpvsg_tpu.train.checkpoint import (
        convert_relation_bundle as jax_convert, torch_state_dict_to_numpy)
    from openpvsg_torch.train.checkpoint import convert_relation_bundle
    from openpvsg_torch.weights import relation_from_jax_params

    bundle = reference_bundle(model_name)
    got = convert_relation_bundle(bundle, model_name)
    want = relation_from_jax_params(
        jax_convert({k: torch_state_dict_to_numpy(v) for k, v in bundle.items()},
                    model_name)["params"],
        tcfg.RelationHeadConfig(model_name=model_name))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


def test_convert_relation_bundle_raises_on_absent_and_extra_keys():
    from openpvsg_torch.train.checkpoint import convert_relation_bundle

    bundle = reference_bundle("transformer")
    del bundle["relation_model"]["span_head.bias"]
    with pytest.raises(ValueError, match=r"keys absent \['relation_model/span_head.bias'\]"):
        convert_relation_bundle(bundle, "transformer")
    bundle = reference_bundle("transformer")
    bundle["pair_proposal_model"]["pair_ffn.4.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match=r"does not use \['pair_proposal_model/pair_ffn.4.weight'\]"):
        convert_relation_bundle(bundle, "transformer")
    # the conv head's keys are left over when read as a transformer bundle
    with pytest.raises(ValueError, match="conv_layers.0.weight"):
        convert_relation_bundle(reference_bundle("conv"), "transformer")


# ---------------------------------------------------------------------------
# stages 3-5 through the CLIs
# ---------------------------------------------------------------------------

def _run_jax_tool(monkeypatch, name, args):
    """Run ``tools/<name>.py``'s main in this process on its single-device
    path."""
    import importlib

    tool = importlib.import_module(f"tools.{name}")
    if hasattr(tool, "maybe_mesh"):
        monkeypatch.setattr(tool, "maybe_mesh", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + args)
    tool.main()


def _same(a, b, path="payload"):
    """Equal content: same types, keys and values, arrays equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.fixture(scope="module")
def rel_root(tmp_path_factory):
    """A rich synthetic root with oracle stage-2 outputs, stage 3 run by
    the port's CLI (train: in its own process with --jobs 2; val: in this
    one) and by the JAX tool, each in its own work dir, and a reference
    bundle for 8 relations."""
    from openpvsg_torch.tools import make_synthetic_data, prepare_rel_set

    root = tmp_path_factory.mktemp("e2e_rel")
    data, port, jax_work = str(root / "data"), str(root / "port"), str(root / "jax")
    anno = make_synthetic_data.main([
        "--out", data, "--style", "rich", "--train-videos", "2", "--val-videos", "2",
        "--frames", "12", "--size", "48", "64", "--oracle-stage2", port, "--seed", "5"])
    shutil.copytree(port, jax_work)
    common = ["--data-dir", data, "--anno-file", anno]
    out = subprocess.run(
        [sys.executable, "-m", "openpvsg_torch.tools.prepare_rel_set", *common,
         "--work-dir", port, "--split", "train", "--jobs", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    val = prepare_rel_set.main(common + ["--work-dir", port, "--split", "val"])
    with pytest.MonkeyPatch.context() as mp:
        for split in ("train", "val"):
            _run_jax_tool(mp, "prepare_rel_set",
                          common + ["--work-dir", jax_work, "--split", split])
    bundle = str(root / "rel.pth")
    torch.save(reference_bundle("transformer", heads=2, ffn=64, temporal_heads=2,
                                temporal_ffn=64, num_relations=8, seed=1), bundle)
    return {"data": data, "anno": anno, "port": port, "jax": jax_work,
            "bundle": bundle, "common": common, "val_summary": val,
            "train_log": out.stderr}


def test_prepare_rel_set_matches_jax(rel_root):
    from openpvsg_torch.data import io as tio
    from openpvsg_torch.tools.common import parse_summary

    train = parse_summary(rel_root["train_log"])
    assert train["written"] == 2 and train["jobs"] == 2 and not train["failed"]
    assert rel_root["val_summary"]["written"] == 2
    assert not any(train["launches"].values())
    kept = 0
    for split in ("train", "val"):
        d = os.path.join(rel_root["jax"], f"{split}_save_qf")
        for vid in sorted(v for v in os.listdir(d) if os.path.isdir(os.path.join(d, v))):
            want = tio.load_pickle(os.path.join(d, vid, "relations.pickle"))
            got = tio.load_pickle(os.path.join(rel_root["port"], f"{split}_save_qf", vid,
                                               "relations.pickle"))
            _same(got, want)
            kept += len(want["relations"])
    assert kept > 0


@pytest.mark.parametrize("name", ["rel_test", "rel_test_full"])
def test_rel_test_clis_match_jax(rel_root, name, monkeypatch, capsys):
    """The printed lines (and rel_test_full's CSV row) of the JAX tool and
    the port's on the same reference bundle."""
    import importlib

    port_tool = importlib.import_module(f"openpvsg_torch.tools.{name}")
    args = rel_root["common"] + ["--checkpoint", rel_root["bundle"], "--split", "val",
                                 "--set", "relation.num_relations=8", *REL_SETS]
    printed = {}
    for pkg, work in (("jax", rel_root["jax"]), ("port", rel_root["port"])):
        if pkg == "jax":
            _run_jax_tool(monkeypatch, name, args + ["--work-dir", work])
        else:
            summary = port_tool.main(args + ["--work-dir", work, "--device", "cpu"])
        printed[pkg] = [ln for ln in capsys.readouterr().out.splitlines()
                        if "Recall" in ln]
    assert printed["port"] == printed["jax"]
    assert len(printed["port"]) == (13 if name == "rel_test" else 24)
    assert summary["videos"] == 2 and not any(summary["launches"].values())
    if name == "rel_test_full":
        rows = {}
        for pkg in ("jax", "port"):
            with open(os.path.join(rel_root[pkg], "relation", "main_results.csv")) as f:
                rows[pkg] = f.read()
        assert rows["port"] == rows["jax"] and rows["port"].count("\n") == 2


def test_rel_train_cli_one_epoch(rel_root, capsys):
    from openpvsg_torch.tools import rel_test, rel_train

    args = rel_root["common"] + ["--work-dir", rel_root["port"], "--device", "cpu",
                                 "--set", "relation.num_relations=8", *REL_SETS]
    out = rel_train.main(args + ["--epochs", "1", "--ps-type", "vps"])
    save = os.path.join(rel_root["port"], "relation", "rel_vps_transformer_lr0.0001")
    # the JAX tool's data order: numpy's default_rng(seed) permutes the videos
    assert out["order"] == [np.random.default_rng(0).permutation(2).tolist()]
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"])) and not any(out["launches"].values())
    assert out["checkpoints"] == [os.path.join(save, "epoch_1")]
    with open(os.path.join(save, "result.csv")) as f:
        rows = f.read().splitlines()
    assert len(rows) == 2 and rows[1].startswith("transformer_epoch1,")
    result = rel_test.main(args + ["--checkpoint", os.path.join(save, "epoch_1"),
                                   "--split", "val"])
    assert result["videos"] == 2
    assert "Recall@20" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# end2end_inference
# ---------------------------------------------------------------------------

E2E_SETS = ["model.backbone.depth=26", "model.num_queries=8",
            "model.num_things_classes=3", "model.num_stuff_classes=2",
            "model.pixel_decoder.encoder_layers=1", "model.decoder.num_layers=3",
            "model.object_mask_thr=0.01", "model.iou_thr=0.1",
            "relation.num_relations=3", "tracker.appearance_depth=26", *REL_SETS]
VID, T_FRAMES = "1000_cli0", 4


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """tests/test_tools_cli.py:19's micro dataset (one 4-frame 48x48 video
    in both splits), the segmenter's weights written by both packages (the
    port's random weights, with random BN statistics and the void logit
    pushed down, as flax variables: seed 4 is the first of 0-5 whose
    weights keep more than one segment on these frames, so that relations
    are ranked) and a reference bundle for 3 relations."""
    from openpvsg_tpu.train.checkpoint import save_checkpoint
    from openpvsg_torch.weights import from_jax_params, random_state_dict, to_jax_params

    root = tmp_path_factory.mktemp("e2e_micro")
    fdir, mdir = root / "vidor" / "frames" / VID, root / "vidor" / "masks" / VID
    fdir.mkdir(parents=True)
    mdir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for t in range(T_FRAMES):
        mask = np.zeros((48, 48), np.uint8)
        mask[8:20, 8:20] = 1
        mask[32:, :] = 2
        Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(
            fdir / f"{t:04d}.png")
        Image.fromarray(mask).save(mdir / f"{t:04d}.png")
    anno = {"objects": {"thing": ["person", "dog", "cat"], "stuff": ["floor", "wall"]},
            "relations": ["on", "next-to", "holding"],
            "split": {"vidor": {"train": [VID], "val": [VID]},
                      "epic_kitchen": {"train": [], "val": []},
                      "ego4d": {"train": [], "val": []}},
            "data": [{"video_id": VID, "meta": {},
                      "objects": [{"object_id": 1, "category": "dog"},
                                  {"object_id": 2, "category": "floor"}],
                      "relations": [[1, 2, "on", [[0, T_FRAMES - 1]]]]}]}
    (root / "pvsg.json").write_text(json.dumps(anno))

    tc = tcfg.apply_overrides(tcfg.get_config("mask2former_vps"),
                              tcfg.parse_set_args(E2E_SETS))
    state = random_state_dict(tc.model, 4)
    stats_rng = np.random.default_rng(2)
    for k, v in state.items():
        if k.endswith("running_var"):
            state[k] = torch.from_numpy((1.0 + stats_rng.random(v.shape)).astype(np.float32))
        elif k.endswith("running_mean"):
            state[k] = torch.from_numpy(
                (0.1 * stats_rng.standard_normal(v.shape)).astype(np.float32))
    state["head.cls_embed.bias"][-1] -= 4.0
    variables = to_jax_params(state, tc.model)
    save_checkpoint(str(root / "jax_seg"), variables)
    torch.save({"model": from_jax_params(variables, tc.model)}, str(root / "port_seg"))
    torch.save(reference_bundle("transformer", heads=2, ffn=64, temporal_heads=2,
                                temporal_ffn=64, num_relations=3, seed=2),
               str(root / "rel.pth"))
    return {"root": str(root), "anno": str(root / "pvsg.json"), "cfg": tc}


def _e2e_args(micro, out_dir, seg):
    return ["--config", "mask2former_vps", "--data-dir", micro["root"],
            "--anno-file", micro["anno"], "--out-dir", out_dir, "--split", "val",
            "--checkpoint", os.path.join(micro["root"], seg),
            "--relation-checkpoint", os.path.join(micro["root"], "rel.pth"),
            "--eval", "--set", *E2E_SETS]


def _port_scores(micro, vid_dir):
    """The probabilities of every ranked (pair, relation) of the port's
    relation head on the port's tubes, in ranked order."""
    from openpvsg_torch.data import io as tio
    from openpvsg_torch.models.relation.utils import pick_top_pairs_eval
    from openpvsg_torch.tools.common import load_relation_params

    model = load_relation_params(os.path.join(micro["root"], "rel.pth"), "transformer",
                                 "cpu", micro["cfg"].relation)
    tubes = tio.load_pickle(os.path.join(vid_dir, "query_feats.pickle"))
    feats = np.stack([t.as_array(T_FRAMES)[0] for t in tubes])
    with torch.no_grad():
        out = model(torch.from_numpy(feats))
        pairs = pick_top_pairs_eval(out["pred_matrix"].numpy(), 100)
        idx = torch.tensor(pairs)
        _, prob = model.predict(torch.cat([out["sub_feats"][idx[:, 0]],
                                           out["obj_feats"][idx[:, 1]]], -1))
    return -np.sort(-prob.numpy().ravel())


def test_end2end_vps_matches_jax(micro, tmp_path, monkeypatch):
    from openpvsg_torch.data import io as tio
    from openpvsg_torch.infer.streaming import triplets_agree
    from openpvsg_torch.tools import end2end_inference

    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    _run_jax_tool(monkeypatch, "end2end_inference",
                  _e2e_args(micro, jax_out, "jax_seg") + ["--ps-type", "vps"])
    summary = end2end_inference.main(_e2e_args(micro, port_out, "port_seg")
                                     + ["--ps-type", "vps", "--device", "cpu"])
    (row,) = summary["per_video"]
    assert row["frames"] == T_FRAMES and row["tubes"] > 1 and row["triplets"] > 0
    assert summary["dtype"] == "float32" and not any(summary["launches"].values())
    jv, pv = os.path.join(jax_out, VID), os.path.join(port_out, VID)
    with open(os.path.join(jv, "quantitive", "masks.txt"), "rb") as a, \
            open(os.path.join(pv, "quantitive", "masks.txt"), "rb") as b:
        assert b.read() == a.read()
    want = tio.load_pickle(os.path.join(jv, "query_feats.pickle"))
    got = tio.load_pickle(os.path.join(pv, "query_feats.pickle"))
    assert [t.track_id for t in got] == [t.track_id for t in want]
    for g, w in zip(got, want):
        a, b = g.as_array(T_FRAMES), w.as_array(T_FRAMES)
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_allclose(a[0], b[0], rtol=0,
                                   atol=FEAT_TOL * max(1.0, float(np.abs(b[0]).max())))
    with open(os.path.join(jv, "triplets.json")) as f:
        want_t = json.load(f)
    with open(os.path.join(pv, "triplets.json")) as f:
        got_t = json.load(f)
    assert len(got_t) == row["triplets"]
    assert triplets_agree(got_t, want_t, _port_scores(micro, pv), RANK_TOL)
    with open(os.path.join(jax_out, "protocol_metrics.json")) as f:
        want_m = json.load(f)
    with open(os.path.join(port_out, "protocol_metrics.json")) as f:
        assert json.load(f) == want_m == summary["protocol"]


def test_end2end_ips_writes_its_files(micro, tmp_path):
    from openpvsg_torch.tools import end2end_inference

    out = str(tmp_path / "ips")
    summary = end2end_inference.main(_e2e_args(micro, out, "port_seg")
                                     + ["--ps-type", "ips", "--device", "cpu"])
    (row,) = summary["per_video"]
    assert row["frames"] == T_FRAMES and row["tubes"] > 0
    vid = os.path.join(out, VID)
    for f in ("quantitive/masks.txt", "query_feats.pickle", "triplets.json"):
        assert os.path.exists(os.path.join(vid, f)), f
    if os.path.exists(os.path.join(vid, "relations.pickle")):
        with open(os.path.join(out, "protocol_metrics.json")) as f:
            assert set(json.load(f)) == {"standard", "soft"}
