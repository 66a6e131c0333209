"""Segmenter inference: batched per-frame forward, panoptic fusion, and
for VPS the MinVIS query stitching, the port of
``openpvsg_tpu/infer/segmenter.py:31,62-363``: the IPS half
(``infer_frames_ips`` and its async/package halves, the test CLI's PQ path)
and the VPS half (stage 2 and the test CLI's VPQ path, and the serial
``infer_window_vps`` of the streaming engine).

Frames enter raw (uint8 RGB, unpadded); normalization and padding run inside
the forward on the device, so only uint8 crosses to the card. The forward
runs all frames of a batch at once; for VPS only the MinVIS stitch, which
needs the query embeddings, runs on the host between the forward and the
fusion. Fusion takes the stride-4 logits of the padded frame: kernel B2
upsamples them 4x, crops to the frame's own size and assigns the owners
(the JAX package upsamples to the padded size and crops before fusing).

With a mesh (``openpvsg_torch.parallel``), as in
``openpvsg_tpu/infer/segmenter.py:80,112,135-138,174-185``, the weights are
copied once to one replica per device of the mesh's 'data' axis, and a
batch's frames are padded to a multiple of the axis (the last frame
repeated) and split into contiguous blocks: each replica runs the forward
and the fusion of its block on its own device (kernels B1 and B2 launch
there), and only the MinVIS stitch and the window means of the class logits
meet on the host and the first device. The one-device path is the mesh of
one replica.

On the card each replica replays its forward (the normalization and zero
pad, then ``Mask2Former``, kernels B1 and, with a Swin backbone, B3
included) as two CUDA graphs per
batch shape, the backbone's and the rest's, which replay back to back:
the first call with a shape runs eagerly (which also warms cuBLAS, cuDNN
and B1's one-time setup), the second captures the pair and replays it,
later calls replay. Only a shape that repeats is captured. The backbone's
graph reads a static uint8 input that the upload copies the frames into,
the rest's graph reads the backbone's static features, and the rest's
outputs are copied out after each replay, since batches stay in flight
while the next replay overwrites them. A replica's graphs share one memory
pool: all replay on one stream, and each one's outputs are copied out
before the next. CPU tensors, and a replica with int8 weights (whose point
is that only the int8 tensors stay resident between calls, where a graph's
pool would keep the dequantized ones), always run eagerly. The graphs hold
the model as it was when each was captured: the model is not changed after
the first forward. Each replica (``_Replica``) keeps its own model,
constants, int8 weights, graphs, pool and streams.

While a profiler runs, the recorder's counters ``segmenter.backbone_device_us``
and ``segmenter.backbone_frames`` add up the backbone's device time (the
frames' normalization and zero pad, then the backbone) and the frames it
ran, from a CUDA event pair on the forward's stream around it: around the
eager backbone, or between the two graphs' replays. Without a profiler no
event is made; the same pair of graphs replays either way. The elapsed
times are read once the host has waited for the batch's first copies
(``finish_windows_vps``, ``package_ips``), from the pairs whose end the
device has reached.

On the card no copy blocks the host behind later work, so that with two
batches in flight the host packages batch b while the card runs batch b+1.
The frames go up from page-locked memory without blocking. Each host-bound
copy is enqueued with its producer, without blocking, into page-locked
memory, with one CUDA event behind each group (``_HostCopies``): the
embeddings for the stitch on the forward's stream right behind the batch's
outputs, and after the stitch the fused maps, the aligned query and, when
asked for, the last aligned embeddings. The host then waits on each group's
event inside the ``segmenter.fetch`` span. The work after the stitch (the
alignment's gathers and window sums, kernel B2, its copies) runs on one
high-priority side stream per card, which first waits for the batch's own
event, so that it runs beside the next batch's replay and not behind it;
IPS enqueues its fusion there at dispatch. The forward's outputs that the
side stream reads are marked with ``record_stream``, so that the caching
allocator hands their blocks to no later forward before the side stream has
passed its reads. The arrays handed to the caller are views of the
page-locked tensors, which they keep alive; PyTorch's host allocator hands
a freed block out again only once the copies recorded on it have ended.
While a profiler runs, ``segmenter.overlapped_batches`` counts the batches
whose results were on the host while a forward stream still had later work
queued. The CPU keeps the synchronous path: each copy is made when the host
waits for it.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from openpvsg_torch import native
from openpvsg_torch.config import Mask2FormerConfig
from openpvsg_torch.data.pipeline import pad_to_divisor
from openpvsg_torch.kernels import fpn, window_attention
from openpvsg_torch.models.fusion import panoptic_fusion, query_feats_by_segment
from openpvsg_torch.models.mask2former import Mask2Former
from openpvsg_torch.models.resnet import fold_frozen_bn
from openpvsg_torch.parallel.mesh import replicate, split_blocks
from openpvsg_torch.parallel.sp import gather, pad_frames_for_mesh
from openpvsg_torch.utils.profiling import RECORDER, count, span
from openpvsg_torch.utils.quantize import dequantize, quantize_state_int8


# the wrappers of the kernels inside the captured forward, whose launch
# counters a replay advances: B1 and B3 (B2 runs after the stitch, eagerly)
GRAPHED_WRAPPERS = fpn.KERNEL_WRAPPERS + window_attention.KERNEL_WRAPPERS


def resolve_device(device=None) -> torch.device:
    """None means the GPU. Without one, only an explicit CPU request runs:
    an entry point never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: openpvsg_torch runs on the GPU unless the "
                "caller passes device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def _fetch(t: torch.Tensor, dtype: Optional[torch.dtype] = None) -> np.ndarray:
    """A blocking copy of ``t`` (cast to ``dtype`` on its device first)
    to a host array."""
    with span("segmenter.fetch"):
        RECORDER.copy(t.device, t.numel() * (dtype or t.dtype).itemsize)
        return (t if dtype is None else t.to(dtype)).cpu().numpy()


class _HostCopies:
    """Device tensors (each cast to its dtype, None: kept) on their way to
    host arrays. On the card the copies are enqueued when the group is
    made, on the current stream of the tensors' device, without blocking,
    into page-locked memory, with one event behind them; on the CPU each
    copy is made in ``wait``, as a blocking fetch."""

    def __init__(self, tensors, dtypes):
        dev = tensors[0].device
        self.stream = self.event = None
        if dev.type != "cuda":
            self.pending = list(zip(tensors, dtypes))
            return
        self.stream = torch.cuda.current_stream(dev)
        self.pending = []
        for t, dtype in zip(tensors, dtypes):
            RECORDER.copy(dev, t.numel() * (dtype or t.dtype).itemsize)
            t = t if dtype is None else t.to(dtype)
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.pending.append(host.copy_(t, non_blocking=True))
        self.event = torch.cuda.Event()
        self.event.record(self.stream)

    def wait(self) -> List[np.ndarray]:
        """The host arrays, once the copies have landed."""
        if self.event is None:
            return [_fetch(t, dtype) for t, dtype in self.pending]
        with span("segmenter.fetch"):
            self.event.synchronize()
        return [t.numpy() for t in self.pending]


def _upload(a: np.ndarray, dev: torch.device, dtype: Optional[torch.dtype] = None,
            into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The host array ``a`` (cast to ``dtype``) on ``dev``: copied into
    ``into`` when given, else into a new tensor. To a card the copy goes
    from page-locked memory, on the current stream, without blocking the
    host."""
    t = torch.as_tensor(a, dtype=dtype)
    if dev.type == "cuda":
        t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    if into is None:
        into = torch.empty(t.shape, dtype=t.dtype, device=dev)
    return into.copy_(t, non_blocking=True)


def _count_overlap(streams) -> None:
    """While a profiler runs, counts ``segmenter.overlapped_batches`` when a
    batch's results are on the host while one of its forward ``streams``
    still has later work queued."""
    if RECORDER.active and any(not s.query() for s in streams):
        count("segmenter.overlapped_batches")


def minvis_stitch(embds: np.ndarray,
                  prev: Optional[np.ndarray] = None) -> np.ndarray:
    """Frame-to-frame query alignment (reference: match_from_embds,
    mask2former_min_vis.py:244-258). embds: (T, Q, C) decoder query
    embeddings. Returns perms (T, Q): perms[t] maps aligned slot -> raw
    query index at frame t. prev=None resets the alignment (perms[0] =
    identity); passing the previous window's last aligned embeddings chains
    it. Uses the same C++ LAP as the JAX package, so ties break alike."""
    T, Q, _ = embds.shape
    perms = np.zeros((T, Q), dtype=np.int32)
    start = 0
    if prev is None:
        perms[0] = np.arange(Q)
        prev = embds[0]
        start = 1
    for t in range(start, T):
        cur = embds[t]
        a = prev / np.maximum(np.linalg.norm(prev, axis=1, keepdims=True), 1e-12)
        b = cur / np.maximum(np.linalg.norm(cur, axis=1, keepdims=True), 1e-12)
        cost = 1.0 - b @ a.T            # (cur, tgt)
        _, ci = native.linear_sum_assignment(cost.T)  # target x current
        perms[t] = ci
        prev = cur[ci]
    return perms


@dataclasses.dataclass(frozen=True)
class _Graph:
    """One captured forward: its static input, the backbone's graph and the
    rest's, the rest's static outputs, and the launches of each of
    ``GRAPHED_WRAPPERS`` inside the pair."""
    x: torch.Tensor
    features: "torch.cuda.CUDAGraph"
    heads: "torch.cuda.CUDAGraph"
    out: Tuple[torch.Tensor, ...]
    launches: Tuple[int, ...]


def _captured(graph: "torch.cuda.CUDAGraph", pool, fn):
    """``fn()`` captured into ``graph`` in ``pool`` on the current stream;
    returns its outputs, the graph's static outputs."""
    graph.capture_begin(pool=pool)
    try:
        return fn()
    finally:
        graph.capture_end()


class _BackboneClock:
    """CUDA event pairs around the backbone of each forward on the card
    while a profiler runs, counted into the recorder once the device has
    passed their end."""

    def __init__(self):
        self.pending: collections.deque = collections.deque()

    @staticmethod
    def start(device: torch.device) -> Optional["torch.cuda.Event"]:
        """An event recorded now on ``device``'s stream, or None (no
        profiler, or not a card): then nothing is recorded."""
        if device.type != "cuda" or not RECORDER.active:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def stop(self, start: Optional["torch.cuda.Event"], device: torch.device,
             frames: int) -> None:
        """The end of ``start``'s pair, on the same stream, and the frames
        between them."""
        if start is None:
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(device))
        self.pending.append((start, end, frames))

    def read(self) -> None:
        """Counts the pairs, oldest first, whose end the device has reached;
        waits for none."""
        while self.pending and self.pending[0][1].query():
            start, end, frames = self.pending.popleft()
            count("segmenter.backbone_device_us", round(1000 * start.elapsed_time(end)))
            count("segmenter.backbone_frames", frames)


class _Replica:
    """The model on one device of the mesh and what its forward keeps
    there: the normalization constants, the int8 weights and their scales,
    the captured forwards by batch shape and the shapes seen, the graphs'
    memory pool and capture stream (made at the first capture), and
    ``side``, the side stream of its card (None on the CPU), which the
    replicas on one card share."""

    MEAN = (123.675, 116.28, 103.53)
    STD = (58.395, 57.12, 57.375)

    def __init__(self, model: Mask2Former, device: torch.device, side, quantized,
                 dtype: torch.dtype, pad_divisor: int, clock: _BackboneClock):
        self.model, self.device, self.side = model, device, side
        self.dtype, self.pad_divisor, self.clock = dtype, pad_divisor, clock
        self.mean = torch.tensor(self.MEAN, dtype=torch.float32, device=device)
        self.std = torch.tensor(self.STD, dtype=torch.float32, device=device)
        self.q8 = {k: (q.to(device), s.to(device)) for k, (q, s) in quantized.items()}
        self.graphs: Dict[tuple, _Graph] = {}
        self.seen: set = set()
        self.pool = self.stream = None

    @torch.no_grad()
    def forward(self, frames: np.ndarray):
        """The forward of (B, H, W, 3) uint8 frames on this device: eager,
        or on the card from the second call with a shape on, a replay of
        the shape's pair of graphs (captured first if there is none) whose
        outputs are returned as copies. A replay advances B1's and B3's
        launch counters by the launches its capture recorded."""
        dev = self.device
        graphed = dev.type == "cuda" and not self.q8 and frames.shape in self.seen
        self.seen.add(frames.shape)
        g = self.graphs.get(frames.shape)
        with torch.cuda.device(dev) if graphed else contextlib.nullcontext():
            with span("segmenter.upload"):
                RECORDER.copy(dev, frames.nbytes)
                x = _upload(frames, dev, into=None if g is None else g.x)
            with span("segmenter.forward"):
                if graphed and g is None:
                    g = self.graphs[frames.shape] = self._capture(x)
                start = self.clock.start(dev)
                if g is None:
                    count("segmenter.eager_forwards")
                    feats = self.features(x)
                    self.clock.stop(start, dev, len(frames))
                    return self.heads(feats)
                g.features.replay()
                self.clock.stop(start, dev, len(frames))
                g.heads.replay()
                for fn, n in zip(GRAPHED_WRAPPERS, g.launches):
                    fn.launches += n
                count("segmenter.graph_replays")
                return tuple(t.clone() for t in g.out)

    def features(self, x: torch.Tensor):
        """The normalization and zero pad of the uint8 frames ``x``, then
        the backbone."""
        x = (x.float() - self.mean) / self.std
        h, w = x.shape[1:3]
        ph, pw = pad_to_divisor(h, w, self.pad_divisor)
        x = torch.nn.functional.pad(x, (0, 0, 0, pw - w, 0, ph - h)).to(self.dtype)
        return self.call("backbone", x)

    def heads(self, feats):
        """The pixel decoder and head on the backbone's features."""
        return self.model.decode(self.call("pixel_decoder", feats), len(feats[0]), 1)

    def call(self, name: str, *args):
        """The submodule ``name`` on ``args``. With int8 weights its
        weights are dequantized inside the call, as JAX does inside its
        jit: only the int8 tensors stay resident between calls."""
        module = getattr(self.model, name)
        if not self.q8:
            return module(*args)
        prefix = name + "."
        weights = {k[len(prefix):]: dequantize(q, s, self.dtype)
                   for k, (q, s) in self.q8.items() if k.startswith(prefix)}
        return torch.func.functional_call(module, weights, args)

    def _capture(self, x: torch.Tensor) -> _Graph:
        """Captures the forward of the static input ``x`` as the pair of
        graphs in this replica's pool, on its capture stream: the
        backbone's, whose static features the rest's reads, then the
        rest's. The wrappers' launch counters are left as they were: the
        captures launched nothing."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        before = [fn.launches for fn in GRAPHED_WRAPPERS]
        features, heads = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        # once for the pair, as ``torch.cuda.graph`` does for each capture:
        # the queued work ends and the cache is emptied before capturing
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        with torch.cuda.stream(self.stream):
            feats = _captured(features, self.pool, lambda: self.features(x))
            out = _captured(heads, self.pool, lambda: self.heads(feats))
        launches = [fn.launches - n for fn, n in zip(GRAPHED_WRAPPERS, before)]
        for fn, n in zip(GRAPHED_WRAPPERS, before):
            fn.launches = n
        count("segmenter.graph_captures")
        return _Graph(x, features, heads, out, tuple(launches))


class SegmenterInference:
    """Owns the model on one device, or its replicas over a mesh, and runs
    forward + stitch + fusion.

    ``state_dict`` is the port's float32 state dict (``weights.py``). With
    ``fold_bn`` (default) and a BatchNorm ResNet the BN affines are folded
    into the convs first (a Swin backbone has no BN: nothing to fold). ``dtype`` is the compute dtype (float32 or
    bfloat16). ``device=None`` means the GPU and raises when there is none;
    pass ``device="cpu"`` to run on the CPU. With ``mesh`` the frames are
    split over its 'data' axis and the device is the mesh's first.

    ``int8_weights`` (None: ``cfg.int8_weights``) quantizes the backbone and
    pixel-decoder kernels after the fold (``utils/quantize.py``): the model
    drops those weights, each device holds their int8 tensors and scales,
    and every forward dequantizes them to ``dtype`` and runs the model on
    them (``torch.func.functional_call``); kernel B1 takes the dequantized
    stride-4 weights.
    """

    def __init__(self, cfg: Mask2FormerConfig, state_dict: Dict[str, torch.Tensor],
                 dtype: torch.dtype = torch.float32, device=None,
                 pad_divisor: int = 32, fold_bn: bool = True, mesh=None,
                 int8_weights: Optional[bool] = None):
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.first:
                raise ValueError(f"device {device} is not the mesh's first, {mesh.first}")
            device = mesh.first
        self.device = resolve_device(device)
        if (fold_bn and cfg.backbone.kind == "resnet"
                and cfg.backbone.norm in ("frozen_bn", "sync_bn")
                and any(k.endswith(".running_var") for k in state_dict)):
            state_dict = fold_frozen_bn(state_dict)
            cfg = dataclasses.replace(
                cfg, backbone=dataclasses.replace(cfg.backbone, norm="folded"))
        self.cfg = cfg
        self.dtype = dtype
        self.pad_divisor = pad_divisor
        self.mesh = mesh
        # weights-only int8 (utils/quantize.py), after the fold: the folded
        # kernels are the ones quantized (openpvsg_tpu/infer/segmenter.py:121)
        self.int8_weights = (cfg.int8_weights if int8_weights is None
                             else int8_weights)
        quantized = {}
        if self.int8_weights:
            state_dict, quantized = quantize_state_int8(
                state_dict, scopes=("backbone", "pixel_decoder"))
        model = Mask2Former(cfg)
        for key in quantized:  # the model keeps no copy of a quantized weight
            owner, name = key.rsplit(".", 1)
            del model.get_submodule(owner)._parameters[name]
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(device=self.device, dtype=dtype).eval()
        models = [self.model] if mesh is None else replicate(self.model, mesh)
        devices = [next(m.parameters()).device for m in models]
        # one high-priority side stream per card, for the work after the
        # stitch (module docstring)
        side = {dev: torch.cuda.Stream(dev, priority=-1)
                for dev in devices if dev.type == "cuda"}
        self._clock = _BackboneClock()
        self.replicas = [_Replica(m, dev, side.get(dev), quantized, dtype, pad_divisor,
                                  self._clock) for m, dev in zip(models, devices)]
        if quantized:
            n_elems = sum(q.numel() for q, _ in quantized.values())
            logging.getLogger(__name__).info(
                "int8 weights: %d kernels quantized, %.1f MB of device memory "
                "saved (from %s)", len(quantized),
                n_elems * (dtype.itemsize - 1) / 1e6, dtype)

    def _padded_hw(self, frames) -> Tuple[int, int]:
        return pad_to_divisor(*frames.shape[1:3], self.pad_divisor)

    def _split(self, frames: np.ndarray):
        """(frame count, [(replica, its block, its real frames)]): the frames
        padded to a multiple of the replicas and split into contiguous
        blocks, as JAX's ``P('data')``; blocks of padding only are dropped."""
        frames = np.asarray(frames)
        if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[3] != 3:
            raise ValueError("forward_frames takes (N, H, W, 3) uint8 frames, "
                             f"got {frames.dtype} {frames.shape}")
        padded, n = pad_frames_for_mesh(frames, len(self.replicas))
        blocks = split_blocks(padded, len(self.replicas))
        b = len(blocks[0])
        return n, [(i, block, min(b, n - i * b))
                   for i, block in enumerate(blocks) if n > i * b]

    def weight_bytes(self) -> int:
        """Bytes of the weights resident on the first device: the model's
        parameters and buffers, and the int8 tensors and their scales."""
        tensors = [*self.model.parameters(), *self.model.buffers(),
                   *(t for pair in self.replicas[0].q8.values() for t in pair)]
        return sum(t.numel() * t.element_size() for t in tensors)

    def _fuse(self, i: int, cls_logits, mask_logits, padded_hw, ori_hw):
        """Replica i's panoptic fusion (kernel B2) on its device."""
        return panoptic_fusion(
            cls_logits, mask_logits, self.cfg.num_things_classes,
            self.cfg.num_stuff_classes, self.cfg.object_mask_thr,
            self.cfg.iou_thr, padded_hw, ori_hw)

    @contextlib.contextmanager
    def _on_side(self, handed):
        """A block in which each card's side stream is its current stream.
        ``handed`` is [(replica, ready, tensors)]: the replica's side stream
        first waits for the event ``ready``, recorded on the forward's
        stream behind the making of ``tensors``, and marks each tensor as
        read there. On the CPU (``ready`` None) nothing changes."""
        sides = []
        with contextlib.ExitStack() as stack:
            for i, ready, tensors in handed:
                if ready is not None:
                    side = self.replicas[i].side
                    side.wait_event(ready)
                    for t in tensors:
                        t.record_stream(side)
                    sides.append(side)
            for side in dict.fromkeys(sides):
                stack.enter_context(torch.cuda.stream(side))
            yield

    def _forward_shards(self, frames: np.ndarray):
        """[(replica, cls, masks, query)] of each block's real frames."""
        _, blocks = self._split(frames)
        out = []
        for i, block, real in blocks:
            cls_logits, mask_logits, query = self.replicas[i].forward(block)
            out.append((i, cls_logits[:real], mask_logits[:real], query[:real]))
        return out

    @torch.no_grad()
    def forward_frames(self, frames: np.ndarray):
        """frames: (N, H, W, 3) uint8 RGB, normalized and zero-padded to the
        divisor here, on the device. Each frame runs with T=1. Returns
        device tensors (cls (N, Q, K+1), masks (N, Q, Hp/4, Wp/4) in the
        model's ``mask_logits_dtype``, query (N, Q, C)), gathered on the
        first device. Fusion reads the
        masks as float32: bfloat16 logits are widened exactly, and kernel
        B2 upsamples them in float32 (the JAX package upsamples and takes
        the sigmoid in bfloat16)."""
        shards = [s[1:] for s in self._forward_shards(frames)]
        return shards[0] if len(shards) == 1 else gather(shards, self.device)

    # ------------------------------------------------------------------
    def infer_frames_ips(self, frames: np.ndarray,
                         ori_hw: Optional[Tuple[int, int]] = None) -> List[Dict]:
        """IPS path: per-frame panoptic results and per-segment query
        features (the simple_test_with_query surface) of (N, H, W, 3) uint8
        frames. Returns one {'pan_results': (H, W) mmdet-format int32,
        'query_feats': {segment_id: (C,) float32}} per frame."""
        return self.package_ips(self.infer_frames_ips_async(frames, ori_hw))

    @torch.no_grad()
    def infer_frames_ips_async(self, frames: np.ndarray,
                               ori_hw: Optional[Tuple[int, int]] = None):
        """Enqueue forward and fusion of a frame batch without waiting for
        them; ``package_ips`` fetches the results. CUDA launches are
        asynchronous, so with two handles in flight the next batch's upload
        and forward run while the host packages this one. On the card the
        fusion and its copies run on the side stream, behind this batch's
        forward only."""
        ori_hw = ori_hw or tuple(frames.shape[1:3])
        padded_hw = self._padded_hw(frames)
        handle = []
        for i, cls_logits, mask_logits, query in self._forward_shards(frames):
            forward = (torch.cuda.current_stream(query.device)
                       if query.device.type == "cuda" else None)
            ready = None if forward is None else forward.record_event()
            with self._on_side([(i, ready, (cls_logits, mask_logits, query))]):
                fusion = self._fuse(i, cls_logits, mask_logits, padded_hw, ori_hw)
                handle.append((self._to_host(fusion, query), forward))
        return handle

    def package_ips(self, handle) -> List[Dict]:
        """Blocking half of ``infer_frames_ips``: fetch a handle's results
        to host per-frame dicts."""
        host = [copies.wait() for copies, _ in handle]
        _count_overlap([s for _, s in handle if s is not None])
        outputs = [out for arrays in host for out in self._package(arrays[:3], arrays[3])]
        self._clock.read()
        return outputs

    def infer_window_vps(self, frames: np.ndarray,
                         ori_hw: Optional[Tuple[int, int]] = None,
                         prev_embds: Optional[np.ndarray] = None,
                         return_embds: bool = False):
        """One MinVIS window, served serially (the streaming engine's call):
        the forward, the stitch (chained from ``prev_embds`` (Q, C), the
        previous window's last aligned embeddings, when given), the aligned
        clip-mean class logits and the fusion of every frame. Returns
        per-frame outputs (and the last frame's aligned embeddings with
        return_embds)."""
        return self.infer_windows_vps(frames, len(frames), prev_embds=prev_embds,
                                      chain_windows=prev_embds is not None,
                                      ori_hw=ori_hw, return_embds=return_embds)

    def infer_windows_vps(self, frames: np.ndarray, window: int,
                          prev_embds: Optional[np.ndarray] = None,
                          chain_windows: bool = False,
                          ori_hw: Optional[Tuple[int, int]] = None,
                          return_embds: bool = False):
        """Windows of ``window`` frames (the last may be ragged) run as one
        forward; the MinVIS stitch runs per window on the host. Returns
        per-frame outputs (and the last aligned embeddings with
        return_embds)."""
        return self.finish_windows_vps(
            self.infer_windows_vps_async(frames, ori_hw), window,
            prev_embds=prev_embds, chain_windows=chain_windows,
            return_embds=return_embds)

    def infer_windows_vps_async(self, frames: np.ndarray,
                                ori_hw: Optional[Tuple[int, int]] = None):
        """Enqueue the forward of a window batch without waiting for it:
        CUDA launches are asynchronous, so the next batch's upload and
        forward queue up while the host stitches and packages this one. On
        the card the embeddings' copies for the stitch are enqueued right
        behind the forward, on its stream."""
        ori_hw = ori_hw or tuple(frames.shape[1:3])
        shards = self._forward_shards(frames)
        embds = [_HostCopies([query], [torch.float32]) for *_, query in shards]
        return shards, self._padded_hw(frames), ori_hw, embds

    @torch.no_grad()
    def finish_windows_vps(self, handle, window: int,
                           prev_embds: Optional[np.ndarray] = None,
                           chain_windows: bool = False,
                           return_embds: bool = False):
        """Fetch the query embeddings, run the MinVIS stitch, then
        align + fuse + package."""
        shards, padded_hw, ori_hw, embds_copies = handle
        embds = np.concatenate([copies.wait()[0] for copies in embds_copies])
        self._clock.read()
        with span("segmenter.stitch"):
            n, Q = embds.shape[:2]
            perms = np.zeros((n, Q), np.int32)
            prev = prev_embds if chain_windows else None
            for lo in range(0, n, window):
                seg = embds[lo:lo + window]
                p = minvis_stitch(seg, prev=prev)
                perms[lo:lo + window] = p
                if chain_windows:
                    prev = seg[-1][p[-1]]
        with span("segmenter.align_fuse"):
            win_id = np.arange(n) // window
            with self._on_side([(shard[0], copies.event, shard[1:])
                                for copies, shard in zip(embds_copies, shards)]):
                fused = self._align_fuse_impl(shards, perms, win_id, int(win_id[-1]) + 1,
                                              padded_hw, ori_hw)
                host = [self._to_host(fusion, query_a) for fusion, query_a in fused]
                last = (_HostCopies([fused[-1][1][-1]], [torch.float32])
                        if return_embds else None)
        host = [copies.wait() for copies in host]
        _count_overlap([c.stream for c in embds_copies if c.stream is not None])
        outputs = [out for arrays in host for out in self._package(arrays[:3], arrays[3])]
        if return_embds:
            return outputs, last.wait()[0]
        return outputs

    def _align_fuse_impl(self, shards, perms, win_id, n_win, padded_hw, ori_hw):
        """Align each block by the host-computed perms on its device, average
        the class logits over each window (the blocks' sums meet on the
        first device: a window within one block keeps that block's sum
        bit for bit), then fuse each block on its device. Returns
        [(fusion, aligned query)] per block."""
        aligned, sums, cnt, lo = [], None, None, 0
        for i, cls_logits, mask_logits, query in shards:
            dev, r = cls_logits.device, len(cls_logits)
            idx = _upload(perms[lo:lo + r], dev, torch.long)
            cls_a = cls_logits.gather(
                1, idx[:, :, None].expand(-1, -1, cls_logits.shape[2]))
            masks_a = mask_logits.gather(
                1, idx[:, :, None, None].expand(-1, -1, *mask_logits.shape[2:]))
            query_a = query.gather(1, idx[:, :, None].expand(-1, -1, query.shape[2]))
            wid = _upload(win_id[lo:lo + r], dev, torch.long)
            s = torch.zeros((n_win, *cls_a.shape[1:]), dtype=cls_a.dtype,
                            device=dev).index_add_(0, wid, cls_a)
            c = torch.zeros((n_win,), dtype=cls_a.dtype, device=dev).index_add_(
                0, wid, torch.ones_like(wid, dtype=cls_a.dtype))
            sums = s.to(self.device) if sums is None else sums + s.to(self.device)
            cnt = c.to(self.device) if cnt is None else cnt + c.to(self.device)
            aligned.append((i, cls_a, masks_a, query_a, wid))
            lo += r
        out = []
        for i, cls_a, masks_a, query_a, wid in aligned:
            s, c = sums.to(cls_a.device), cnt.to(cls_a.device)
            cls_mean = s[wid] / c[wid][:, None, None]
            out.append((self._fuse(i, cls_mean, masks_a, padded_hw, ori_hw), query_a))
        return out

    @staticmethod
    def _to_host(fusion, query) -> _HostCopies:
        """The copies of a block's fusion outputs and its float32 query
        features."""
        return _HostCopies([fusion["pan_seg"], fusion["query_keep"], fusion["segment_id"],
                            query], [None, None, None, torch.float32])

    def _package(self, fusion, query) -> List[Dict]:
        """A block's host arrays, ``fusion`` its (pan_seg, query_keep,
        segment_id) and ``query`` its query features, -> host per-frame dicts
        {'pan_results', 'query_feats': {segment_id: mean query feature}}."""
        pan, keep, seg_ids = fusion
        with span("segmenter.feats"):
            return [{"pan_results": pan[t],
                     "query_feats": query_feats_by_segment(
                         {"query_keep": keep[t], "segment_id": seg_ids[t]}, query[t])}
                    for t in range(pan.shape[0])]
