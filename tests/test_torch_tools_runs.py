"""The port's ``assigner_parity`` and ``rel_capacity_study`` runs against the
JAX tools' own runs on the CPU (``tests/test_torch_tools.py`` holds their
batches, configurations, report keys and ``delta`` formula):

- ``assigner_parity.run`` with the Hungarian at 2 steps, from the JAX
  trainer's initial weights, against ``tools/assigner_parity.py:run``: every
  step's loss within 1e-3 of JAX's (relative; one Adam update at the
  warm-up lr lies between them), the fragment's ``loss_first10`` and
  ``loss_last10`` within that plus the fragment's rounding of 1e-4, and PQ,
  PQ_th and PQ_st within 1e-4;
- ``rel_capacity_study`` for one cell (transformer, tiny) at 1 epoch, the
  port's head started from the JAX trainer's initial parameters, against
  the JAX tool run whole: ``params`` equal, ``loss_first`` and
  ``loss_last`` within 2e-3 (their rounding of 1e-3 plus 1e-3), and every
  recall within 1e-2 (one step of their rounding to 2 decimals).

Each test runs JAX's trainer and inference once (their compiles take most
of the file's time).
"""
import dataclasses
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from openpvsg_torch import config as tcfg


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_tool(name):
    return importlib.import_module(f"tools.{name}")


def test_assigner_parity_run_matches_jax(tmp_path, monkeypatch):
    import jax

    import openpvsg_torch.train.segmenter as port_segmenter
    import openpvsg_tpu.train.segmenter as jax_segmenter
    from openpvsg_torch.data.synthetic import make_dataset
    from openpvsg_torch.tools import assigner_parity as port
    from openpvsg_torch.weights import from_jax_params

    jax_tool = _jax_tool("assigner_parity")
    root = str(tmp_path / "data")
    make_dataset(root, n_train=3, n_val=1, n_frames=10, h=96, w=96, seed=0)
    _, batches = jax_tool.build_batches(root, 2, 2, seed=1)

    initial = []

    class RecordingJaxTrainer(jax_segmenter.SegmenterTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            initial.append(jax.tree_util.tree_map(
                np.asarray, {"params": self.state.params,
                             "batch_stats": self.state.batch_stats}))

    monkeypatch.setattr(jax_segmenter, "SegmenterTrainer", RecordingJaxTrainer)
    want_losses, want_metrics = jax_tool.run("hungarian", batches, root)
    assert len(initial) == 1

    port_trainer = port_segmenter.SegmenterTrainer

    def from_jax_init(cfg, train_cfg, **k):
        return port_trainer(cfg, train_cfg,
                            state_dict=from_jax_params(initial[0], cfg), **k)

    monkeypatch.setattr(port_segmenter, "SegmenterTrainer", from_jax_init)
    got_losses, got_metrics, _ = port.run("hungarian", batches, root, torch.device("cpu"))

    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-3)
    got = port.fragment(got_losses, got_metrics, [0.0])
    want = port.fragment(want_losses, want_metrics, [0.0])
    for k in ("loss_first10", "loss_last10"):
        assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]) + 1e-4, k
    for k in ("PQ", "PQ_th", "PQ_st"):
        assert abs(got[k] - want[k]) <= 1e-4, k


def test_rel_capacity_study_run_matches_jax(tmp_path, monkeypatch):
    import jax

    import openpvsg_torch.train.relation as port_relation
    import openpvsg_tpu.train.relation as jax_relation
    from openpvsg_torch.tools import make_synthetic_data, prepare_rel_set
    from openpvsg_torch.tools import rel_capacity_study as port
    from openpvsg_torch.weights import relation_from_jax_params

    data, work = str(tmp_path / "data"), str(tmp_path / "work")
    anno = make_synthetic_data.main([
        "--out", data, "--style", "rich", "--train-videos", "2", "--val-videos", "1",
        "--frames", "10", "--size", "48", "64", "--oracle-stage2", work, "--seed", "3"])
    common = ["--data-dir", data, "--anno-file", anno, "--work-dir", work]
    for split in ("train", "val"):
        prepare_rel_set.main(common + ["--split", split])
    args = common + ["--variants", "transformer", "--capacities", "tiny",
                     "--epochs", "1", "--accum", "2"]

    initial = []

    class RecordingJaxTrainer(jax_relation.RelationTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            initial.append(jax.tree_util.tree_map(np.asarray, self.params))

    monkeypatch.setattr(jax_relation, "RelationTrainer", RecordingJaxTrainer)
    jax_out = str(tmp_path / "jax.json")
    monkeypatch.setattr(sys, "argv", ["rel_capacity_study.py"] + args + ["--out", jax_out])
    _jax_tool("rel_capacity_study").main()
    assert len(initial) == 1

    port_trainer = port_relation.RelationTrainer

    def from_jax_init(cfg, relation_count, rng_seed=0, device=None):
        return port_trainer(cfg, relation_count, rng_seed=rng_seed, device=device,
                            state_dict=relation_from_jax_params(initial[0], cfg))

    monkeypatch.setattr(port_relation, "RelationTrainer", from_jax_init)
    out = str(tmp_path / "port.json")
    port.main(args + ["--out", out, "--device", "cpu"])
    with open(out) as f:
        got = json.load(f)
    with open(jax_out) as f:
        want = json.load(f)
    (g,), (w,) = got.pop("cells"), want.pop("cells")
    assert got == want
    assert g.keys() == w.keys()
    assert g["params"] == w["params"] and g["run_spec"] == w["run_spec"]
    for k in ("loss_first", "loss_last"):
        assert abs(g[k] - w[k]) <= 2e-3, (k, g[k], w[k])
    recalls = [k for k in w if "R@" in k or k == "pair_recall_20"]
    assert len(recalls) == 10
    for k in recalls:
        assert abs(g[k] - w[k]) <= 1e-2, (k, g[k], w[k])
