"""The port's IPS tracker (``openpvsg_torch.tracker``) and MOTS metrics
against the JAX package on the CPU, at the tests' small size: the depth-26
appearance encoder of tests/test_end2end.py:157 (cut after layer3, stride
8), 64x64 frames.

Tolerances (measured gaps in brackets):
- Kalman filter, tracks, box IoU, linear assignment, MOTS metric dicts,
  the weight converters: bitwise (the same numpy code, the same C++ LAP);
- ``reconsdot_distance``: 1e-5 absolute on costs in [0, 2] (<= 3.3e-6:
  float32 products of 1024-long pixel features, scaled by 100 inside the
  softmaxes);
- ``extract_object_embeddings``: 1e-5 absolute on unit-norm features
  (<= 1.4e-7), validity equal;
- the trackers fed identical frames, masks and query features: track ids,
  boxes, masks, classes and tube contents equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpvsg_tpu import config as jcfg
from openpvsg_torch import config as tcfg

RECONS_TOL = 1e-5
FEAT_TOL = 1e-5
H = W = 64


@pytest.fixture(scope="module")
def appearance():
    """(JAX variables, port state dict) of the depth-26 appearance encoder,
    from a flax init with random BN statistics."""
    from openpvsg_tpu.tracker.appearance import make_appearance_model
    from openpvsg_torch.weights import appearance_from_jax_params

    variables = make_appearance_model(depth=26).init(
        jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(4)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, v: ((1.0 + rng.random(v.shape)) if path[-1].key == "var"
                         else 0.1 * rng.standard_normal(v.shape)).astype(np.float32),
        variables["batch_stats"])
    return variables, appearance_from_jax_params(
        variables, tcfg.TrackerConfig(appearance_depth=26))


def test_kalman_and_tracks_are_bitwise_copies():
    from openpvsg_tpu.tracker import kalman as jk, tracks as jt
    from openpvsg_torch.tracker import kalman as tk, tracks as tt

    out = {}
    for name, k, t in (("jax", jk, jt), ("torch", tk, tt)):
        rng = np.random.default_rng(0)
        kf, ids = k.KalmanFilter(), t.IdCounter()
        boxes = rng.uniform(5, 40, (5, 4))
        stracks = [t.STrack(k.tlbr_to_tlwh(np.r_[b[:2], b[:2] + b[2:]]), 0.9, None)
                   for b in boxes]
        for s in stracks:
            s.activate(kf, 1, ids)
        rec = []
        for step in range(2, 6):
            t.STrack.multi_predict(stracks)
            meas = np.stack([s.to_xyah() for s in stracks]) + rng.normal(0, 1, (5, 4))
            rec.append(kf.gating_distance(stracks[0].mean, stracks[0].covariance, meas))
            rec.append(kf.gating_distance(stracks[1].mean, stracks[1].covariance, meas,
                                          only_position=True, metric="gaussian"))
            for s, m in zip(stracks[:3], meas[:3]):
                det = t.STrack(k.tlbr_to_tlwh(np.r_[m[:2], m[:2] + [m[2] * m[3], m[3]]]),
                               0.8, None)
                s.update(det, step)
            stracks[3].mark_lost()
            stracks[3].re_activate(stracks[0], step)
            rec += [s.mean for s in stracks] + [s.covariance for s in stracks]
            rec += [s.tlbr for s in stracks]
        a, b = stracks[:3], stracks[2:]
        kept = t.remove_duplicate_stracks(a, b, ioudist=0.5)
        rec.append([[s.track_id for s in part] for part in kept])
        rec.append([s.track_id for s in t.joint_stracks(a, b)])
        rec.append([s.track_id for s in t.sub_stracks(b, a)])
        rec.append(k.tlwh_to_xyah(np.array([1.0, 2.0, 3.0, 0.0])))
        out[name] = rec
    assert len(out["jax"]) == len(out["torch"])
    for a, b in zip(out["jax"], out["torch"]):
        if isinstance(a, list):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)


def test_zero_height_box_starts_a_track_where_jax_raises():
    """A one-row mask has a tlwh height of 0: the JAX package's Kalman
    covariance for a track born from it is singular, and the next frame's
    gating raises. The port gives it a one-pixel box's noise and tracks on;
    both agree on the frame before."""
    from openpvsg_tpu.tracker.variants import EmbedAssociationTracker as JEmbed
    from openpvsg_torch.tracker.variants import EmbedAssociationTracker

    def masks(thin):
        m = np.zeros((2, 32, 32), np.uint8)
        m[0, 2:10, 2:10] = 1
        m[1, 20:21 if thin else 26, 5:25] = 1
        return m

    qf = [{"query_feat": np.ones(4, np.float32), "cls_id": 0},
          {"query_feat": -np.ones(4, np.float32), "cls_id": 0}]
    frame = np.zeros((32, 32, 3), np.float32)
    jt = JEmbed(jcfg.TrackerConfig())
    tt = EmbedAssociationTracker(tcfg.TrackerConfig(), device="cpu")
    want, _ = jt.update(frame, masks(True), qf)
    got, _ = tt.update(frame, masks(True), qf)
    assert [t.track_id for t in got] == [t.track_id for t in want] == [1, 2]
    with pytest.raises(np.linalg.LinAlgError):
        jt.update(frame, masks(False), qf)
    for _ in range(2):
        got, _ = tt.update(frame, masks(False), qf)
        assert sorted(t.track_id for t in got) == [1, 2]


def test_box_ious_and_linear_assignment_match_jax():
    from openpvsg_tpu.tracker import matching as jm
    from openpvsg_torch.tracker import matching as tm

    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 50, (9, 2))
    boxes = np.c_[xy, xy + rng.uniform(1, 30, (9, 2))]
    np.testing.assert_array_equal(tm.box_ious(boxes[:4], boxes),
                                  jm.box_ious(boxes[:4], boxes))
    assert tm.box_ious(np.zeros((0, 4)), boxes).shape == (0, 9)
    for shape, thresh in (((5, 7), 0.9), ((7, 4), 0.5), ((6, 6), 0.3), ((0, 3), 0.9)):
        cost = rng.random(shape)
        cost[rng.random(shape) < 0.2] = np.inf
        got, want = tm.linear_assignment(cost, thresh), jm.linear_assignment(cost, thresh)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


@pytest.mark.parametrize("case", ["padded_sets", "more_tracks", "one_track",
                                  "no_tracks", "no_detections"])
def test_reconsdot_distance_matches_jax(case):
    """Sets narrower than the 512-pixel budget (padding), wider (cut),
    with zero columns (the extractor's padding), T != N, and empty sides."""
    from openpvsg_tpu.tracker import matching as jm
    from openpvsg_torch.tracker import matching as tm

    rng = np.random.default_rng(len(case))
    widths = {"padded_sets": ((256, 100, 512), (256, 256, 40, 700)),
              "more_tracks": ((256,) * 6, (256, 300)),
              "one_track": ((256,), (600, 256, 3)),
              "no_tracks": ((), (256, 256)),
              "no_detections": ((256, 256), ())}[case]

    def sets(ws):
        out = []
        for w in ws:
            f = rng.standard_normal((1024, w)).astype(np.float32)
            f[:, w // 2:] *= rng.random(w - w // 2) < 0.5  # some zero columns
            out.append(f)
        return out

    tracks, dets = sets(widths[0]), sets(widths[1])
    want = jm.reconsdot_distance(tracks, dets)
    got = tm.reconsdot_distance(tracks, dets, device="cpu")
    assert got.shape == want.shape == (len(tracks), len(dets))
    if got.size:
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=RECONS_TOL)
        assert np.ptp(want) > 0.01  # the costs differ between pairs


def test_reconsdot_chunks_agree_with_one_pass(monkeypatch):
    """Chunking along the axis each softmax does not reduce is exact up to
    the products' summation order."""
    from openpvsg_torch.tracker import matching as tm

    rng = np.random.default_rng(7)
    tracks = [rng.standard_normal((64, 256)).astype(np.float32) for _ in range(5)]
    dets = [rng.standard_normal((64, 256)).astype(np.float32) for _ in range(3)]
    whole = tm.reconsdot_distance(tracks, dets, device="cpu")
    monkeypatch.setattr(tm, "CHUNK_BYTES", 1)  # one set per chunk
    chunked = tm.reconsdot_distance(tracks, dets, device="cpu")
    np.testing.assert_allclose(chunked, whole, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw,max_mask_area,max_pixels", [
    ((64, 64), 300, 256), ((70, 90), 300, 256), ((96, 128), 40, 32)])
def test_extract_object_embeddings_matches_jax(appearance, hw, max_mask_area,
                                               max_pixels):
    """Frames whose feature grid does not divide them (the nearest resize
    rounds) and objects larger than the pick budget (the strided pick)."""
    from openpvsg_tpu.tracker.appearance import extract_object_embeddings as jext
    from openpvsg_torch.tracker.appearance import (extract_object_embeddings,
                                                   make_appearance_model)

    variables, state = appearance
    model = make_appearance_model(depth=26)
    model.load_state_dict(state)
    model.eval()
    h, w = hw
    rng = np.random.default_rng(h)
    frame = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    masks = np.zeros((5, h, w), np.uint8)
    masks[0, 5:h - 9, 3:w - 7] = 1
    masks[1, h // 2:, 20:31] = 1
    masks[2, 0:3, 0:3] = 1            # below one feature cell: may vanish
    masks[3] = rng.random((h, w)) < 0.5
    want_f, want_v = jext(variables, frame, masks, max_pixels=max_pixels,
                          max_mask_area=max_mask_area, depth=26)
    got_f, got_v = extract_object_embeddings(model, frame, masks, max_pixels=max_pixels,
                                             max_mask_area=max_mask_area)
    assert got_f.shape == (5, max_pixels, 1024)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0, atol=FEAT_TOL)
    assert not got_v[4].any() and got_v[0].any()
    if max_mask_area < 300:  # object 0 covers more cells than the budget
        assert got_v[0].sum() == max_pixels


ZOO_DEPTH = {"imagenet18": 18, "crw": 18, "uvc": 18, "random18": 18,
             "imagenet34": 34, "imagenet101": 101}


def _flax_shapes(tree):
    """{port state-dict key: shape} of a flax variables tree of shapes."""
    out = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree.get(coll, {}))[0]:
            *scope, name = [p.key for p in path]
            shape = tuple(leaf.shape)
            if name == "kernel":
                name, shape = "weight", (shape[3], shape[2], shape[0], shape[1])
            name = {"scale": "weight", "mean": "running_mean",
                    "var": "running_var"}.get(name, name)
            out[".".join([*scope, name])] = shape
    return out


def test_make_encoder_matches_jax_for_every_zoo_entry():
    """Every ResNet entry: the port's parameter names and shapes are the
    JAX encoder's, and so are the down factor and the output shape (stride
    and channels); 'random' has no weights and JAX's down factor and output
    shape; hrnet raises, an unknown name too."""
    from openpvsg_tpu.tracker import zoo as jzoo
    from openpvsg_torch.tracker import zoo
    from openpvsg_torch.weights import appearance_expected_shapes

    entries = (jzoo._R18 + jzoo._R34 + jzoo._R50 + jzoo._R101)
    assert set(entries) == set(zoo._R18 + zoo._R34 + zoo._R50 + zoo._R101)
    x = jnp.zeros((1, 40, 72, 3))
    seen = {}
    for model_type in entries:
        for remove in ((("layer4",), ("layer3", "layer4"), ())
                       if model_type in ("imagenet18", "imagenet50") else (("layer4",),)):
            with torch.device("meta"):
                model, down = zoo.make_encoder(model_type, remove)
                out = model(torch.empty(1, 40, 72, 3))
            assert len(out) == 1
            cfg = tcfg.TrackerConfig(model_type=model_type, remove_layers=remove)
            shapes = appearance_expected_shapes(cfg)
            assert shapes == {k: tuple(v.shape) for k, v in model.state_dict().items()}
            key = (ZOO_DEPTH.get(model_type, 50), remove)
            if key not in seen:
                jmodel, jdown = jzoo.make_encoder(model_type, remove)
                jout, jvars = jax.eval_shape(
                    lambda: jmodel.init_with_output(jax.random.PRNGKey(0), x))
                seen[key] = (jdown, tuple(jout[0].shape), _flax_shapes(jvars))
            jdown, jshape, jshapes = seen[key]
            assert (down, tuple(out[0].shape), shapes) == (jdown, jshape, jshapes), \
                (model_type, remove)
    assert len(seen) == 8
    # 'random' (ported since A11b): no weights, JAX's down factor and output
    # shape (its features are held to JAX's in tests/test_torch_remainder.py)
    model, down = zoo.make_encoder("random")
    jmodel, jdown = jzoo.make_encoder("random")
    jout = jax.eval_shape(lambda: jmodel.apply({}, x))
    out = model(torch.zeros(1, 40, 72, 3))
    assert (down, tuple(out[0].shape)) == (jdown, tuple(jout[0].shape))
    assert not model.state_dict()
    assert appearance_expected_shapes(tcfg.TrackerConfig(model_type="random")) == {}
    with pytest.raises(NotImplementedError, match="hrnet"):
        zoo.make_encoder("hrnet_w18")
    with pytest.raises(ValueError, match="resnext9000"):
        zoo.make_encoder("resnext9000")


def _torchvision_sd(depth, seed):
    """A torchvision-named state dict (all four stages, with ``fc`` and the
    BN ``num_batches_tracked`` counters) of random weights."""
    from openpvsg_torch.models.resnet import ResNet

    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, t in ResNet(depth=depth).state_dict().items():
        parts = key.replace(".bn.", ".").split(".")
        if parts[0].startswith("layer"):
            stage, block = parts[0].split("_")
            rest = parts[1:]
            if rest[0] in ("downsample_conv", "downsample_bn"):
                rest = ["downsample", "0" if rest[0] == "downsample_conv" else "1"] + rest[1:]
            parts = [stage, block] + rest
        sd[".".join(parts)] = torch.randn(t.shape, generator=gen).abs() + 0.5
        if parts[-1] == "running_var":
            sd[".".join(parts[:-1] + ["num_batches_tracked"])] = torch.tensor(7)
    sd["fc.weight"] = torch.randn(10, 8, generator=gen)
    sd["fc.bias"] = torch.zeros(10)
    return sd


# (model_type, appearance depth, the prefix the UniTrack checkpoint adds)
CONVERTER_CASES = [("imagenet50", 26, ""), ("crw", 18, "encoder.model."),
                   ("uvc", 18, "module.gray_encoder."),
                   ("timecycle", 50, "module.encoderVideo."),
                   ("mocov2", 50, "module.encoder_q."),
                   ("byol", 50, "feature_extractor.module.model.")]


@pytest.mark.parametrize("model_type,depth,prefix", CONVERTER_CASES)
def test_checkpoint_converters_match_jax(model_type, depth, prefix):
    """torchvision and UniTrack checkpoints -> the port's encoder state:
    bitwise the JAX converter's tree carried over by
    ``appearance_from_jax_params`` (the removed layer4 and the heads
    dropped)."""
    from openpvsg_tpu.train.checkpoint import (convert_torchvision_resnet as jtv,
                                               convert_unitrack_checkpoint as jut)
    from openpvsg_torch.weights import (appearance_from_jax_params, appearance_state,
                                        convert_torchvision_resnet,
                                        convert_unitrack_checkpoint)

    sd = _torchvision_sd(depth, seed=depth)
    cfg = tcfg.TrackerConfig(model_type=model_type, appearance_depth=depth)
    if prefix:
        raw = {prefix + k: v for k, v in sd.items()}
        raw["head.proj.weight"] = torch.zeros(3, 3)
        got = appearance_state(convert_unitrack_checkpoint(raw, model_type), cfg)
        want = jut({k: v.numpy() for k, v in raw.items()}, model_type)
    else:
        got = appearance_state(convert_torchvision_resnet(sd), cfg)
        want = jtv({k: v.numpy() for k, v in sd.items()})
    want = appearance_from_jax_params(want, cfg)
    assert got.keys() == want.keys()
    assert not any(k.startswith("layer4") for k in got)
    for k in want:
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_appearance_state_raises_on_missing_and_extra_keys():
    from openpvsg_torch.weights import (appearance_state, convert_torchvision_resnet,
                                        random_appearance_state_dict)

    cfg = tcfg.TrackerConfig(appearance_depth=26)
    state = random_appearance_state_dict(cfg, 0)
    assert appearance_state(state, cfg).keys() == state.keys()
    with pytest.raises(ValueError, match="tree lacks|state dict lacks"):
        appearance_state({k: v for k, v in state.items() if "layer3" not in k}, cfg)
    with pytest.raises(ValueError, match="does not use"):
        appearance_state({**state, "layer3_0.extra.weight": torch.zeros(1)}, cfg)
    full = convert_torchvision_resnet(_torchvision_sd(26, 0))
    assert any(k.startswith("layer4") for k in full)  # dropped: removed stage
    assert appearance_state(full, cfg).keys() == state.keys()


def _sequence(n_frames=12):
    """A 12-frame 64x64 scene: 4 coloured objects of classes 1, 2, 2 and
    1003 moving across noise; object 2 leaves at frame 5 and comes back at
    frame 8 (lost -> re-activated), object 4 enters at frame 4, frame 9 has
    no detection, frame 6 repeats object 1's mask (a duplicate box). Each
    object's query feature is fixed plus noise."""
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((4, 256)).astype(np.float32)
    colors = [(250, 30, 30), (30, 250, 30), (30, 30, 250), (250, 250, 30)]
    classes = [1, 2, 2, 1003]
    seq = []
    for t in range(n_frames):
        frame = rng.integers(0, 60, (H, W, 3)).astype(np.float32)
        masks, qfs = [], []
        for o, (y, x, dy, dx) in enumerate(((4, 2, 1, 3), (30, 40, 1, -2),
                                            (44, 6, -1, 2), (10, 44, 2, -1))):
            if (o == 1 and 5 <= t < 8) or (o == 3 and t < 4) or t == 9:
                continue
            m = np.zeros((H, W), np.uint8)
            yt, xt = y + dy * t, x + dx * t
            m[max(yt, 0):yt + 14, max(xt, 0):xt + 16] = 1
            frame[m == 1] = colors[o]
            masks.append(m)
            qfs.append({"query_feat": feats[o] + 0.05 * rng.standard_normal(256).astype(np.float32),
                        "cls_id": classes[o]})
            if o == 0 and t == 6:
                masks.append(m.copy())
                qfs.append(dict(qfs[-1]))
        seq.append((frame, np.stack(masks) if masks else np.zeros((0, H, W), np.uint8),
                    qfs))
    return seq


@pytest.mark.parametrize("kind", ["mask", "embed"])
def test_tracker_sequence_matches_jax(appearance, kind):
    from openpvsg_tpu.tracker.tracker import MaskAssociationTracker as JMask
    from openpvsg_tpu.tracker.variants import EmbedAssociationTracker as JEmbed
    from openpvsg_torch.tracker.tracker import MaskAssociationTracker
    from openpvsg_torch.tracker.variants import EmbedAssociationTracker

    variables, state = appearance
    jc = jcfg.TrackerConfig(appearance_depth=26, track_buffer=30)
    tc = tcfg.TrackerConfig(appearance_depth=26, track_buffer=30)
    if kind == "mask":
        jt, tt = JMask(jc, variables), MaskAssociationTracker(tc, state, device="cpu")
    else:
        jt, tt = JEmbed(jc), EmbedAssociationTracker(tc, device="cpu")
    ids = []
    for frame, masks, qfs in _sequence():
        want, n_want = jt.update(frame, masks, [dict(q) for q in qfs])
        got, n_got = tt.update(frame, masks, [dict(q) for q in qfs])
        assert n_got == n_want
        assert [t.track_id for t in got] == [t.track_id for t in want]
        assert [t.cls_id for t in got] == [t.cls_id for t in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.tlbr, w.tlbr)
            np.testing.assert_array_equal(g.mask, w.mask)
        assert ([t.track_id for t in tt.lost_stracks]
                == [t.track_id for t in jt.lost_stracks])
        ids.append([t.track_id for t in want])
    # the scene exercises re-activation, a new track and an empty frame
    assert sorted(ids[4]) == sorted(ids[8]) == [1, 2, 3, 4] and [] in ids
    got, want = tt.finalize(12), jt.finalize(12)
    assert type(got[0]).__module__ == "openpvsg_torch.tracker.tubes"
    assert [(t.track_id, t.start_frame_id, len(t)) for t in got] == \
        [(t.track_id, t.start_frame_id, len(t)) for t in want]
    for gt, wt in zip(got, want):
        for g, w in zip(gt.qf_tube, wt.qf_tube):
            assert (g is None) == (w is None)
            if g is not None:
                assert g["cls_id"] == w["cls_id"]
                np.testing.assert_array_equal(g["query_feat"], w["query_feat"])


def test_mot_metrics_match_jax():
    """evaluate_mots / evaluate_hota / evaluate_jf on tubes with misses,
    false positives, an id switch and a relabelled track: equal dicts."""
    from openpvsg_tpu.eval import mot_metrics as jmm
    from openpvsg_torch.eval import mot_metrics as tmm

    rng = np.random.default_rng(5)
    gt, pred = [], []
    for t in range(10):
        g, p = {}, {}
        for oid in (1, 2, 3):
            if oid == 3 and t < 3:
                continue
            m = np.zeros((32, 40), np.uint8)
            y, x = 2 + 8 * (oid - 1), 2 + 2 * t
            m[y:y + 7, x:x + 9] = 1
            g[oid] = m
            if rng.random() < 0.85:
                q = np.roll(m, int(rng.integers(-2, 3)), axis=1)
                p[(oid if not (oid == 2 and t >= 6) else 7) + 10] = q
        if t % 4 == 1:
            fp = np.zeros((32, 40), np.uint8)
            fp[26:30, 30:38] = 1
            p[99] = fp
        gt.append(g)
        pred.append(p)
    for fn in ("evaluate_mots", "evaluate_hota", "evaluate_jf"):
        got, want = getattr(tmm, fn)(gt, pred), getattr(jmm, fn)(gt, pred)
        assert got == want, fn
    assert tmm.evaluate_mots(gt, pred)["id_switches"] >= 1
    assert tmm.evaluate_hota([{}], [{}]) == jmm.evaluate_hota([{}], [{}])


def test_tracker_config_matches_jax():
    want = dataclasses.asdict(jcfg.TrackerConfig())
    assert dataclasses.asdict(tcfg.TrackerConfig()) == want
    assert [f.name for f in dataclasses.fields(tcfg.PVSGConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.PVSGConfig)]
