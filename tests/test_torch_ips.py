"""The port's IPS stage 2 (``run_query_tube_ips``) and its three stage-2
CLIs (``python -m openpvsg_torch.tools.{prepare_query_tube_ips,
prepare_query_tube_vps,eval_mots}``) against the JAX package on the CPU, at
the tests' small size (R-26, 8 queries, 3 decoder layers, the depth-26
appearance encoder, 64x64 frames) on a synthetic PVSG tree written by the
port's generator (1 train and 1 val video of 6 frames; 5 thing and 3 stuff
classes).

Weights: the port's random segmenter weights from a seed (random BN
statistics, the void logit pushed down and the thing logits up, the query
features scaled so that 3-5 segments are kept per frame), carried
to the JAX package by ``to_jax_params``; random appearance weights written
as a torchvision ``.pth``, read by the port's converter and by the JAX
package's ``convert_torchvision_resnet``.

Tolerances: ``masks.txt`` byte-identical; ``query_feats.pickle`` track
ids, start frames, gaps and class ids equal, features 1e-4 absolute (the
bound tests/test_torch_stage2.py holds the VPS pickle to); the MOTS metric
dicts equal.
"""
import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

FEAT_TOL = 1e-4
N_FRAMES = 6
MODEL_SETS = ["model.backbone.depth=26", "model.num_queries=8",
              "model.num_things_classes=5", "model.num_stuff_classes=3",
              "model.decoder.num_layers=3", "model.decoder.ffn_channels=64",
              "model.pixel_decoder.encoder_layers=1",
              "model.pixel_decoder.ffn_channels=64",
              "model.object_mask_thr=0.01", "model.iou_thr=0.1",
              "tracker.appearance_depth=26"]


def _cfg(m, preset):
    return m.apply_overrides(m.get_config(preset), m.parse_set_args(MODEL_SETS))


def _to_torchvision(state):
    """The port's ResNet names -> torchvision's (the inverse of
    ``weights.convert_torchvision_resnet``)."""
    out = {}
    for key, t in state.items():
        parts = key.replace(".bn.", ".").split(".")
        if parts[0].startswith("layer"):
            stage, block = parts[0].split("_")
            rest = parts[1:]
            if rest[0] in ("downsample_conv", "downsample_bn"):
                rest = ["downsample", "0" if rest[0] == "downsample_conv" else "1"] + rest[1:]
            parts = [stage, block] + rest
        out[".".join(parts)] = t
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from openpvsg_tpu.train.checkpoint import convert_torchvision_resnet
    from openpvsg_torch.data.pvsg import PVSGAnnotation, frame_paths
    from openpvsg_torch.tools import make_synthetic_data
    from openpvsg_torch.weights import random_appearance_state_dict, random_state_dict

    root = str(tmp_path_factory.mktemp("ips_data"))
    anno = make_synthetic_data.main(["--out", root, "--frames", str(N_FRAMES),
                                     "--size", "64", "64", "--train-videos", "1",
                                     "--val-videos", "1", "--seed", "6"])
    vid = PVSGAnnotation(anno).video_ids("val")[0]
    files = tmp_path_factory.mktemp("ips_weights")
    rng = np.random.default_rng(2)
    out = {"root": root, "anno": anno, "vid": vid,
           "frames": frame_paths(root, vid, "frames")}
    for preset in ("mask2former_ips", "mask2former_vps"):
        state = random_state_dict(_cfg(tcfg, preset).model, 4)
        for k, v in state.items():
            if k.endswith("running_var"):
                state[k] = torch.from_numpy((1.0 + rng.random(v.shape)).astype(np.float32))
            elif k.endswith("running_mean"):
                state[k] = torch.from_numpy(
                    (0.1 * rng.standard_normal(v.shape)).astype(np.float32))
        # several thing segments per frame for the tracker: thing classes
        # favoured over void and stuff, and query features large enough
        # that each query's mask differs
        state["head.cls_embed.bias"][-1] -= 4.0
        state["head.cls_embed.bias"][:5] += 6.0
        state["head.query_feat"] *= 10.0
        out[preset] = state
        torch.save({"model": state}, str(files / preset))
    app = random_appearance_state_dict(_cfg(tcfg, "mask2former_ips").tracker, 5)
    torchvision = _to_torchvision(app)
    torch.save(torchvision, str(files / "appearance.pth"))
    out["appearance"] = app
    out["jax_appearance"] = convert_torchvision_resnet(
        {k: v.numpy() for k, v in torchvision.items()})
    out["files"] = str(files)
    return out


def _segmenters(setup, preset):
    from openpvsg_tpu.infer.segmenter import SegmenterInference as JaxSeg
    from openpvsg_torch.infer.segmenter import SegmenterInference
    from openpvsg_torch.weights import to_jax_params

    tc, jc = _cfg(tcfg, preset).model, _cfg(jcfg, preset).model
    state = setup[preset]
    return JaxSeg(jc, to_jax_params(state, tc)), SegmenterInference(tc, state, device="cpu")


def _jax_ips(setup, save_root, batch_size):
    from openpvsg_tpu.infer.stages import run_query_tube_ips
    from openpvsg_tpu.tracker.tracker import MaskAssociationTracker

    jseg, _ = _segmenters(setup, "mask2former_ips")
    tracker = MaskAssociationTracker(_cfg(jcfg, "mask2former_ips").tracker,
                                     appearance_variables=setup["jax_appearance"])
    return run_query_tube_ips(jseg, tracker, setup["frames"], save_root,
                              batch_size=batch_size)


def _port_ips(setup, save_root, batch_size, pipeline_depth=2):
    from openpvsg_torch.infer.stages import run_query_tube_ips
    from openpvsg_torch.tracker.tracker import MaskAssociationTracker

    _, seg = _segmenters(setup, "mask2former_ips")
    tracker = MaskAssociationTracker(_cfg(tcfg, "mask2former_ips").tracker,
                                     setup["appearance"], device="cpu")
    return run_query_tube_ips(seg, tracker, setup["frames"], save_root,
                              batch_size=batch_size, pipeline_depth=pipeline_depth)


def _outputs(save_root):
    with open(os.path.join(save_root, "quantitive", "masks.txt"), "rb") as f:
        txt = f.read()
    with open(os.path.join(save_root, "query_feats.pickle"), "rb") as f:
        return txt, pickle.load(f)


def _same_stage2(got_root, want_root, module):
    """masks.txt byte-identical; the pickled tubes equal in content."""
    got_txt, got = _outputs(got_root)
    want_txt, want = _outputs(want_root)
    assert len(want_txt.splitlines()) >= N_FRAMES, "too few kept segments"
    assert got_txt == want_txt
    assert got and type(got[0]).__module__ == module
    assert [(t.track_id, getattr(t, "start_frame_id", None), len(t.qf_tube)) for t in got] \
        == [(t.track_id, getattr(t, "start_frame_id", None), len(t.qf_tube)) for t in want]
    for gt, wt in zip(got, want):
        for g, w in zip(gt.qf_tube, wt.qf_tube):
            assert (g is None) == (w is None)
            if g is not None:
                assert g["cls_id"] == w["cls_id"]
                np.testing.assert_allclose(g["query_feat"], w["query_feat"],
                                           rtol=0, atol=FEAT_TOL)
    return got


@pytest.fixture(scope="module")
def jax_ips_run(setup, tmp_path_factory):
    """JAX's run_query_tube_ips over the val video in batches of 4 (the
    second one ragged): (tube count, output directory)."""
    root = str(tmp_path_factory.mktemp("jax_ips"))
    return _jax_ips(setup, root, batch_size=4), root


def test_run_query_tube_ips_matches_jax(setup, jax_ips_run, tmp_path):
    n_jax, jax_root = jax_ips_run
    n = _port_ips(setup, str(tmp_path / "port"), batch_size=4)
    assert n == n_jax > 1
    tubes = _same_stage2(str(tmp_path / "port"), jax_root,
                         "openpvsg_torch.tracker.tubes")
    assert all(len(t.qf_tube) == N_FRAMES for t in tubes)


def test_ips_pipeline_depth_does_not_change_the_outputs(setup, tmp_path):
    outs = {}
    for depth in (1, 3):
        root = str(tmp_path / f"d{depth}")
        outs[depth] = (_port_ips(setup, root, batch_size=2, pipeline_depth=depth),
                       *_outputs(root))
    assert outs[1][0] == outs[3][0] and outs[1][1] == outs[3][1]
    for a, b in zip(outs[1][2], outs[3][2]):
        assert (a.track_id, a.start_frame_id) == (b.track_id, b.start_frame_id)
        for x, y in zip(a.qf_tube, b.qf_tube):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x["query_feat"], y["query_feat"])


def _cli_args(setup, work, preset):
    return ["--config", preset, "--data-dir", setup["root"], "--anno-file", setup["anno"],
            "--work-dir", work, "--device", "cpu", "--split", "val",
            "--checkpoint", os.path.join(setup["files"], preset), "--set", *MODEL_SETS]


@pytest.fixture(scope="module")
def ips_cli_run(setup, tmp_path_factory):
    """The port's IPS CLI over the val split."""
    from openpvsg_torch.tools import prepare_query_tube_ips

    work = str(tmp_path_factory.mktemp("ips_cli"))
    summary = prepare_query_tube_ips.main(
        _cli_args(setup, work, "mask2former_ips")
        + ["--appearance-checkpoint", os.path.join(setup["files"], "appearance.pth"),
           "--batch-size", "4"])
    return work, summary


@pytest.mark.parametrize("stage", ["ips", "vps"])
def test_stage2_cli_files_match_jax(setup, ips_cli_run, jax_ips_run, tmp_path, stage):
    """The stage-2 CLIs' files against JAX's run_query_tube_ips /
    run_query_tube_vps on the same weights and frames."""
    from openpvsg_tpu.infer.stages import run_query_tube_vps
    from openpvsg_torch.tools import prepare_query_tube_vps

    if stage == "ips":
        work, summary = ips_cli_run
        jax_root = jax_ips_run[1]
    else:
        work, jax_root = str(tmp_path / "work"), str(tmp_path / "jax")
        summary = prepare_query_tube_vps.main(_cli_args(setup, work, "mask2former_vps"))
        jseg, _ = _segmenters(setup, "mask2former_vps")
        run_query_tube_vps(jseg, setup["frames"], jax_root, window=2)
    assert summary["videos"] == 1 and summary["frames"] == N_FRAMES
    assert summary["dtype"] == "float32" and summary["peak_gib"] is None
    assert not any(summary["launches"].values())  # plain versions on the CPU
    tubes = _same_stage2(os.path.join(work, "val_save_qf", setup["vid"]), jax_root,
                         "openpvsg_torch.tracker.tubes")
    assert summary["tubes"] == len(tubes)


@pytest.mark.parametrize("source", ["ips_cli", "oracle"])
def test_eval_mots_cli_matches_jax_tool(setup, ips_cli_run, tmp_path, source,
                                        monkeypatch, capsys):
    """The port's eval_mots CLI and the JAX package's tools/eval_mots.py on
    the same stage-2 outputs (the IPS CLI's, and GT-derived oracle tubes):
    equal metric dicts, in the --out JSON and on stdout."""
    from openpvsg_torch.data.synthetic import write_oracle_stage2
    from openpvsg_torch.tools import eval_mots

    if source == "ips_cli":
        work = ips_cli_run[0]
    else:
        work = str(tmp_path / "oracle")
        write_oracle_stage2(setup["root"], setup["anno"], work, "val", seed=0)
    args = ["--work-dir", work, "--data-dir", setup["root"], "--anno-file", setup["anno"],
            "--split", "val"]
    got = eval_mots.main(args + ["--out", str(tmp_path / "port.json")])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["eval_mots.py"] + args
                        + ["--out", str(tmp_path / "jax.json")])
    from tools import eval_mots as jax_tool

    jax_tool.main()
    want_printed = capsys.readouterr().out.strip().splitlines()[-1]
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == want == got
    assert printed == want_printed
    if source == "oracle":
        assert got["MOTA"] == got["IDF1"] == got["HOTA"] == 1.0


def test_stage2_clis_refuse_multi_process_flags(setup, tmp_path, monkeypatch):
    """The three stage-2 CLIs as the JAX tools: ``--dist-init`` outside
    torchrun raises naming the missing variables (no hang), and ``--n-time
    2`` raises as JAX's ``reject_unused_n_time`` (none scores relations)."""
    from openpvsg_torch.tools import (eval_mots, prepare_query_tube_ips,
                                      prepare_query_tube_vps)

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    for main in (prepare_query_tube_ips.main, prepare_query_tube_vps.main,
                 eval_mots.main):
        for flag, match in ((["--dist-init"], "MASTER_ADDR, MASTER_PORT, WORLD_SIZE, "
                                              "RANK not set"),
                            (["--n-time", "2"], "only meaningful for tools with a "
                                                "relation scoring stage")):
            with pytest.raises(SystemExit, match=match):
                main(["--work-dir", str(tmp_path), "--data-dir", setup["root"],
                      "--anno-file", setup["anno"], "--device", "cpu"] + flag)


def test_save_tracking_overlay_matches_jax(tmp_path):
    """The qualitative overlay PNG, byte for byte: the palette, the blend
    and the track-id labels."""
    from openpvsg_tpu.infer.stages import save_tracking_overlay as jax_overlay
    from openpvsg_torch.infer.stages import save_tracking_overlay

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    masks = [np.zeros((40, 56), np.uint8) for _ in range(3)]
    masks[0][2:20, 3:30] = 1
    masks[1][15:40, 25:56] = 1  # overlaps the first
    for fn, root in ((jax_overlay, "jax"), (save_tracking_overlay, "port")):
        fn(str(tmp_path / root), 7, img, masks, [3, 11, 250])
    with open(tmp_path / "jax" / "qualititive" / "000007.png", "rb") as f:
        want = f.read()
    with open(tmp_path / "port" / "qualititive" / "000007.png", "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("stage", ["ips", "vps"])
def test_stage2_runners_write_one_overlay_per_frame(setup, tmp_path, stage):
    from openpvsg_torch.infer.stages import run_query_tube_ips, run_query_tube_vps
    from openpvsg_torch.tracker.tracker import MaskAssociationTracker

    root = str(tmp_path / stage)
    if stage == "ips":
        _, seg = _segmenters(setup, "mask2former_ips")
        tracker = MaskAssociationTracker(_cfg(tcfg, "mask2former_ips").tracker,
                                         setup["appearance"], device="cpu")
        run_query_tube_ips(seg, tracker, setup["frames"], root, batch_size=4,
                           save_images=True)
    else:
        _, seg = _segmenters(setup, "mask2former_vps")
        run_query_tube_vps(seg, setup["frames"], root, save_images=True)
    assert sorted(os.listdir(os.path.join(root, "qualititive"))) == \
        [f"{t:06d}.png" for t in range(1, N_FRAMES + 1)]
