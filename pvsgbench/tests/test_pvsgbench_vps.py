"""The VPS cells on the CPU at a small size: the plain reference against the
port, the comparison's faults and its control, the rate's response to a
stall, the FLOP count."""
from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pvsgbench import core, counts, gen
from pvsgbench.reference import model as ref_model
from pvsgbench.tests.util import drive, tiny_cell

CELLS = ("vps_offline.r50_axial", "vps_batched.r50_msda")


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_forward_equals_the_port(cell):
    from openpvsg_torch.infer.segmenter import SegmenterInference

    from pvsgbench.drivers.vps import port_config

    run = tiny_cell(cell)
    m = run.config["model"]
    state = gen.segmenter_weights(m, 5, "cpu")
    seg = SegmenterInference(port_config(run.config), state, dtype=torch.float32, device="cpu")
    frames = gen.video(5, 0, 2, (72, 88), "cpu", 3)
    got = seg.forward_frames(frames.numpy())
    want = ref_model.forward_frames(ref_model.build(m, state, "cpu"), frames)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    run = drive(tiny_cell(cell))
    assert run.correct, run.checks
    assert run.failed == 0 and run.attempted >= 3
    assert run.counters["judged_segments"] > 0


def _break_answers(monkeypatch):
    """A segment's class altered where the segmenter packages it."""
    from openpvsg_torch.infer import segmenter

    orig = segmenter.SegmenterInference._package

    def altered(self, fusion, query):
        out = orig(self, fusion, query)
        for frame in out:
            pan = frame["pan_results"]
            ids = [i for i in np.unique(pan) if i != 126]
            if ids:
                frame["pan_results"] = np.where(pan == ids[0], ids[0] + 1, pan)
                frame["query_feats"][ids[0] + 1] = frame["query_feats"].pop(ids[0])
        return out

    monkeypatch.setattr(segmenter.SegmenterInference, "_package", altered)


def _swap_features(monkeypatch):
    """Two segments of a frame each given the other's query feature where
    the segmenter packages them."""
    from openpvsg_torch.infer import segmenter

    orig = segmenter.SegmenterInference._package

    def swapped(self, fusion, query):
        out = orig(self, fusion, query)
        for frame in out:
            qf = frame["query_feats"]
            if len(qf) >= 2:
                a, b = list(qf)[:2]
                qf[a], qf[b] = qf[b], qf[a]
        return out

    monkeypatch.setattr(segmenter.SegmenterInference, "_package", swapped)


def _break_batch(monkeypatch):
    """Half of each batch left out: the first half's forward stands in for
    the whole batch."""
    from openpvsg_torch.infer import segmenter

    orig = segmenter.SegmenterInference._forward_shards

    def half(self, frames):
        n = len(frames)
        k = max(1, n // 2)
        reps = np.concatenate([frames[:k]] * (-(-n // k)))[:n]
        return orig(self, reps)

    monkeypatch.setattr(segmenter.SegmenterInference, "_forward_shards", half)


@pytest.mark.parametrize("fault", [_break_answers, _swap_features, _break_batch],
                         ids=["answer_altered", "features_swapped", "half_batch"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    run = drive(tiny_cell("vps_offline.r50_axial"))
    assert not run.correct, run.checks


@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_is_not_correct(cell):
    """The reference in the program's place, its products in float8 e4m3,
    judged through the same checks: not correct."""
    run = tiny_cell(cell)
    run.control = True
    drive(run)
    assert run.correct, run.checks
    assert not run.control_run.correct, run.control_run.checks


def test_a_run_that_judges_no_segment_is_not_correct():
    from pvsgbench.drivers import vps

    run = tiny_cell(CELLS[0])
    vps.hold(run, {"mask_gap": 0.0, "feat_gap": 0.0}, 0, 0)
    assert not run.correct, run.checks


def test_a_stall_lowers_the_window_rate(monkeypatch):
    """The rate is every frame over all the window's time: a stall inside
    the timed path shows in it."""
    from pvsgbench.drivers import vps

    rates = []
    for stall in (0.0, 0.05):
        orig = vps.run_video

        def slow(run, seg, frames, root, _orig=orig, _stall=stall):
            time.sleep(_stall * len(frames))
            return _orig(run, seg, frames, root)

        monkeypatch.setattr(vps, "run_video", slow)
        rates.append(drive(tiny_cell("vps_offline.r50_axial", seconds=1.0)).values["frames_per_s"])
        monkeypatch.setattr(vps, "run_video", orig)
    assert rates[1] < 0.6 * rates[0], rates


@pytest.mark.parametrize("cell", CELLS)
def test_flop_count_matches_the_flop_counter(cell):
    m = tiny_cell(cell).config["model"]
    model = ref_model.build(m, gen.segmenter_weights(m, 3, "cpu"), "cpu")
    frames = gen.video(3, 0, 1, (72, 88), "cpu", 2)
    with FlopCounterMode(display=False) as fc:
        ref_model.forward_frames(model, frames)
    assert counts.segmenter_flops_per_frame(m, (72, 88)) == pytest.approx(
        fc.get_total_flops(), rel=1e-9)


def test_traced_run_reports_the_per_layer_metrics_it_can():
    run = drive(tiny_cell("vps_offline.r50_axial", trace=1))
    line = core.result_line(run)
    json.dumps(line)
    # the CPU has no device operations: the device readers return nothing
    assert "device_idle_share.vps" not in line["metrics"]
    assert line["metrics"]["segmenter_ms_per_frame.vps"]["unit"] == "ms/frame"
    assert line["device"]["window_s"] > 0


def test_weights_repeat_from_the_seed():
    m = tiny_cell(CELLS[0]).config["model"]
    a, b = gen.segmenter_weights(m, 11, "cpu"), gen.segmenter_weights(m, 11, "cpu")
    c = gen.segmenter_weights(m, 12, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
