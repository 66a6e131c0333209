"""The Swin configuration on the CPU at a small size: the port's Swin and its
whole segmenter against ``reference/swin.py`` on seeded random weights, a
sound run and the fp8 control through ``drivers/vps_swin.py``, the FLOP
counts against ``torch.utils.flop_counter``, and the backbone readers.

The small Swin keeps Swin-L's shape rules: window 12, head size 32, four
stages of two blocks (an unshifted and a shifted one each), a frame whose
stride-4 grid pads in every stage, and a last stage smaller than one
window. Its variant ``mini`` is added to the port's and the reference's
tables for each test.

Tolerances: 1e-5 of the output's scale for the backbone (the same float32
products in the same order on both sides; the slack covers another BLAS
blocking), and 1e-4 of the scale for the segmenter's cls, masks and queries
(``test_pvsgbench_vps.py``'s: sums of up to a few thousand products through
the decoder's nine attention layers). bfloat16 operands move the outputs by
about 1e-2 of their scale, so a reference rounded to bfloat16 fails both.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pvsgbench import core, counts_swin
from pvsgbench.drivers import vps, vps_swin
from pvsgbench.reference import model as ref_model
from pvsgbench.reference import swin as ref_swin
from pvsgbench.tests.util import drive, tiny_cell

CELL = "vps_batched.swinl_msda"
MINI = (32, (2, 2, 2, 2), (1, 2, 4, 8))    # embed dim, blocks, heads: head size 32
WINDOW = 12
HW = (72, 88)           # padded to 96x96: stride-4 grid 24x24, stages 24/12/6/3


@pytest.fixture(autouse=True)
def mini(monkeypatch):
    """The small variant in the port's and the reference's tables, and two
    threads."""
    from openpvsg_torch.models import swin

    monkeypatch.setitem(swin.SWIN_CONFIGS, "mini", MINI)
    monkeypatch.setitem(swin.SWIN_WINDOWS, "mini", WINDOW)
    monkeypatch.setitem(ref_swin.VARIANTS, "mini", (*MINI, WINDOW))
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tiny_swin_cell(**kw):
    """``tiny_cell`` of the Swin cell with the ``mini`` backbone and
    pixel-decoder inputs of its widths."""
    run = tiny_cell(CELL, **kw)
    m = run.config["model"]
    m["backbone"]["swin_variant"] = "mini"
    m["pixel_decoder"]["in_channels"] = [MINI[0] * 2 ** s for s in range(4)]
    return run


def _bf16(monkeypatch):
    """Every product of the reference with its operands rounded to
    bfloat16."""
    monkeypatch.setattr(ref_model.Rounding, "q",
                        classmethod(lambda cls, t: t.to(torch.bfloat16).float()))
    monkeypatch.setattr(ref_model.Rounding, "mode", "bf16")


def _close(got, want, rel):
    scale = max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) <= rel * scale


def _backbones(seed=4):
    from openpvsg_torch.models.swin import SwinTransformer

    ref = ref_swin.Swin("mini").eval()
    g = torch.Generator().manual_seed(seed)
    state = {}
    for k, v in ref.state_dict().items():
        if k.endswith("rel_index"):
            continue
        t = torch.randn(v.shape, generator=g)
        state[k] = t / v.shape[-1] ** 0.5 if v.dim() >= 2 else 1.0 + 0.1 * t
    ref.load_state_dict(state, strict=False)
    port = SwinTransformer("mini").eval()
    port.load_state_dict(state, strict=True)
    return port, ref


@pytest.mark.parametrize("hw", [(96, 136), (44, 60)], ids=["pads", "one_window"])
@pytest.mark.parametrize("rounded", [False, True], ids=["float32", "bf16_control"])
def test_port_swin_equals_the_reference_stage_by_stage(hw, rounded, monkeypatch):
    """Grids of 24x34 (stages 24x34, 12x17, 6x9, 3x5: every stage pads,
    patch merging pads odd sizes) and 11x15 (every stage one window
    high): each stage's output within 1e-5 of the scale; the reference
    rounded to bfloat16 is not."""
    port, ref = _backbones()
    assert port.window == WINDOW
    assert port.stage0_block0.attn.rel_bias_table.shape == ((2 * WINDOW - 1) ** 2, 1)
    if rounded:
        _bf16(monkeypatch)
    x = torch.randn(2, *hw, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = port(x), ref(x)
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    agree = [_close(a, b, 1e-5) for a, b in zip(got, want)]
    assert all(agree) != rounded, agree


@pytest.mark.parametrize("rounded", [False, True], ids=["float32", "bf16_control"])
def test_segmenter_forward_equals_the_reference(rounded, monkeypatch):
    """The port's float32 ``SegmenterInference`` of the cell's model (Swin
    ``mini``, reduced widths) on the driver's weights against the
    reference's forward: cls, mask logits and queries within 1e-4 of their
    scale; the reference rounded to bfloat16 is not."""
    from openpvsg_torch.infer.segmenter import SegmenterInference

    run = tiny_swin_cell()
    m = run.config["model"]
    state = vps_swin.segmenter_weights(m, 5, "cpu", HW)
    seg = SegmenterInference(vps.port_config(run.config), state, dtype=torch.float32,
                             device="cpu")
    assert seg.model.backbone.window == WINDOW and m["num_queries"] == 30
    frames = vps_swin.gen.video(5, 0, 2, HW, "cpu", 3)
    got = seg.forward_frames(frames.numpy())
    if rounded:
        _bf16(monkeypatch)
    want = ref_model.forward_frames(ref_swin.build(m, state, "cpu"), frames)
    for a, b in zip(got, want):
        assert a.shape == b.shape
    agree = [_close(a, b, 1e-4) for a, b in zip(got, want)]
    assert all(agree) != rounded, agree


def test_a_sound_run_is_correct_and_the_fp8_control_is_not():
    run = tiny_swin_cell(seconds=2.0)   # three videos or more on a busy host
    run.control = True
    drive(run)
    assert run.correct, run.checks
    assert run.failed == 0 and run.attempted >= 3
    assert run.counters["judged_segments"] > 0
    assert not run.control_run.correct, run.control_run.checks


def test_a_program_without_the_variant_fails_before_set_up(monkeypatch):
    from openpvsg_torch.models import swin

    monkeypatch.delitem(swin.SWIN_CONFIGS, "mini")
    run = tiny_swin_cell()
    with pytest.raises(ValueError, match="swin variant 'mini'"):
        vps_swin.run(run)
    assert "setup_s" not in run.values


def test_flop_counts_match_the_flop_counter():
    """``counts_swin``: the small Swin alone on a frame whose grids pad, and
    the whole reduced segmenter on the cell's padded frame."""
    _, ref = _backbones()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref(torch.zeros(1, 96, 136, 3))
    assert counts_swin.swin_flops("mini", 96, 136) == pytest.approx(fc.get_total_flops(),
                                                                    rel=1e-9)
    m = tiny_swin_cell().config["model"]
    model = ref_swin.build(m, vps_swin.segmenter_weights(m, 3, "cpu"), "cpu")
    with FlopCounterMode(display=False) as fc:
        ref_model.forward_frames(model, vps_swin.gen.video(3, 0, 1, HW, "cpu", 2))
    assert counts_swin.segmenter_flops_per_frame(m, HW) == pytest.approx(
        fc.get_total_flops(), rel=1e-9)


def test_swin_l_counts_at_the_cell_size():
    """Swin-L on a 360x640 frame padded to 384x640, its grids to multiples
    of 12: 405.3 GFLOP, 83% of the forward's 489.1."""
    m = core.load_json("configs", "m2f_swinl_msda")["model"]
    backbone = counts_swin.backbone_flops_per_frame(m, (360, 640))
    whole = counts_swin.segmenter_flops_per_frame(m, (360, 640))
    assert backbone == pytest.approx(405.336e9, rel=1e-5)
    assert whole == pytest.approx(489.052e9, rel=1e-5)


def _reader(name):
    return core.load_module("metrics", name)


@pytest.mark.parametrize("cell", [CELL, "vps_offline.r50_msda"])
def test_backbone_readers(cell, monkeypatch):
    """The two backbone readers from the program's counters: the device
    time per frame, and the FLOPs from shapes over it and the bfloat16
    peak; nothing where the program keeps no such counter or the run was
    not traced."""
    from openpvsg_torch.utils.profiling import RECORDER

    w = core.load_json("workloads", cell)
    run = core.Run(type("A", (), {"seed": 1, "seconds": 1.0, "trace": 1})(), w,
                   core.load_json("configs", w["config"]))
    ms, roof = _reader("backbone_ms_per_frame.vps"), _reader("backbone_roofline.vps")
    assert ms.read(run) is None                     # not traced
    run.trace = object()
    monkeypatch.setattr(RECORDER, "counters", {})
    assert ms.read(run) is None and roof.read(run) is None
    monkeypatch.setattr(RECORDER, "counters", {"segmenter.backbone_device_us": 16000,
                                               "segmenter.backbone_frames": 8})
    assert ms.read(run) == pytest.approx(2.0)
    flops = counts_swin.backbone_flops_per_frame(run.config["model"], w["traffic"]["frame_hw"])
    assert roof.read(run) == pytest.approx(100 * flops / 2e-3 / 989e12)


def test_traced_run_reports_what_the_cpu_can():
    """On the CPU the backbone counters stay empty (no card, no events):
    the line leaves the two backbone readings out and keeps the MFU."""
    run = drive(tiny_swin_cell(trace=1))
    line = core.result_line(run)
    json.dumps(line)
    assert "backbone_ms_per_frame.vps" not in line["metrics"]
    assert "backbone_roofline.vps" not in line["metrics"]
    assert line["metrics"]["mfu_swin.vps"]["unit"] == "%"
    assert line["metrics"]["segmenter_ms_per_frame.vps"]["value"] > 0


def test_weights_repeat_from_the_seed_and_centre_the_mask_features():
    m = tiny_swin_cell().config["model"]
    a = vps_swin.segmenter_weights(m, 11, "cpu", HW)
    b = vps_swin.segmenter_weights(m, 11, "cpu", HW)
    c = vps_swin.segmenter_weights(m, 12, "cpu", HW)
    assert a.keys() == ref_swin.state_shapes(m).keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    frame = vps_swin.gen.video(11, 10 ** 6, 1, HW, "cpu", 4)
    mf = ref_model.mask_features(ref_swin.build(m, a, "cpu"), frame)
    assert np.abs(mf.mean((0, 1, 2)).numpy()).max() < 1e-4
