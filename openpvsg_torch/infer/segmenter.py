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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from openpvsg_torch import native
from openpvsg_torch.config import Mask2FormerConfig
from openpvsg_torch.data.pipeline import pad_to_divisor
from openpvsg_torch.models.fusion import panoptic_fusion, query_feats_by_segment
from openpvsg_torch.models.mask2former import Mask2Former
from openpvsg_torch.models.resnet import fold_frozen_bn
from openpvsg_torch.parallel.mesh import replicate, split_blocks
from openpvsg_torch.parallel.sp import gather, pad_frames_for_mesh


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


class SegmenterInference:
    """Owns the model on one device, or its replicas over a mesh, and runs
    forward + stitch + fusion.

    ``state_dict`` is the port's float32 state dict (``weights.py``). With
    ``fold_bn`` (default) and a BatchNorm ResNet the BN affines are folded
    into the convs first (a Swin backbone has no BN: nothing to fold). ``dtype`` is the compute dtype (float32 or
    bfloat16). ``device=None`` means the GPU and raises when there is none;
    pass ``device="cpu"`` to run on the CPU. With ``mesh`` the frames are
    split over its 'data' axis and the device is the mesh's first.
    """

    MEAN = (123.675, 116.28, 103.53)
    STD = (58.395, 57.12, 57.375)

    def __init__(self, cfg: Mask2FormerConfig, state_dict: Dict[str, torch.Tensor],
                 dtype: torch.dtype = torch.float32, device=None,
                 pad_divisor: int = 32, fold_bn: bool = True, mesh=None):
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
        model = Mask2Former(cfg)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.replicas = [self.model] if mesh is None else replicate(self.model, mesh)
        self._norm = [(torch.tensor(self.MEAN, dtype=torch.float32, device=dev),
                       torch.tensor(self.STD, dtype=torch.float32, device=dev))
                      for dev in (next(m.parameters()).device for m in self.replicas)]

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

    @torch.no_grad()
    def _forward(self, i: int, frames: np.ndarray):
        """Replica i's forward of (B, H, W, 3) uint8 frames on its device."""
        mean, std = self._norm[i]
        x = torch.from_numpy(frames).to(mean.device)
        x = (x.float() - mean) / std
        h, w = x.shape[1:3]
        ph, pw = self._padded_hw(frames)
        x = torch.nn.functional.pad(x, (0, 0, 0, pw - w, 0, ph - h))
        return self.replicas[i](x.to(self.dtype))

    def _fuse(self, i: int, cls_logits, mask_logits, padded_hw, ori_hw):
        """Replica i's panoptic fusion (kernel B2) on its device."""
        return panoptic_fusion(
            cls_logits, mask_logits, self.cfg.num_things_classes,
            self.cfg.num_stuff_classes, self.cfg.object_mask_thr,
            self.cfg.iou_thr, padded_hw, ori_hw)

    def _forward_shards(self, frames: np.ndarray):
        """[(replica, cls, masks, query)] of each block's real frames."""
        _, blocks = self._split(frames)
        out = []
        for i, block, real in blocks:
            cls_logits, mask_logits, query = self._forward(i, block)
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
        and forward run while the host packages this one."""
        ori_hw = ori_hw or tuple(frames.shape[1:3])
        padded_hw = self._padded_hw(frames)
        return [(self._fuse(i, cls_logits, mask_logits, padded_hw, ori_hw), query)
                for i, cls_logits, mask_logits, query in self._forward_shards(frames)]

    def package_ips(self, handle) -> List[Dict]:
        """Blocking half of ``infer_frames_ips``: fetch a handle's results
        to host per-frame dicts."""
        return [out for fusion, query in handle for out in self._package(fusion, query)]

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
        forward queue up while the host stitches and packages this one."""
        ori_hw = ori_hw or tuple(frames.shape[1:3])
        return self._forward_shards(frames), self._padded_hw(frames), ori_hw

    @torch.no_grad()
    def finish_windows_vps(self, handle, window: int,
                           prev_embds: Optional[np.ndarray] = None,
                           chain_windows: bool = False,
                           return_embds: bool = False):
        """Fetch the query embeddings, run the MinVIS stitch, then
        align + fuse + package."""
        shards, padded_hw, ori_hw = handle
        embds = np.concatenate([q.float().cpu().numpy() for *_, q in shards])
        n, Q = embds.shape[:2]
        perms = np.zeros((n, Q), np.int32)
        prev = prev_embds if chain_windows else None
        for lo in range(0, n, window):
            seg = embds[lo:lo + window]
            p = minvis_stitch(seg, prev=prev)
            perms[lo:lo + window] = p
            if chain_windows:
                prev = seg[-1][p[-1]]
        win_id = np.arange(n) // window
        fused = self._align_fuse_impl(shards, perms, win_id, int(win_id[-1]) + 1,
                                      padded_hw, ori_hw)
        outputs = [out for fusion, query_a in fused
                   for out in self._package(fusion, query_a)]
        if return_embds:
            return outputs, fused[-1][1][-1].float().cpu().numpy()
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
            idx = torch.as_tensor(perms[lo:lo + r], dtype=torch.long, device=dev)
            cls_a = cls_logits.gather(
                1, idx[:, :, None].expand(-1, -1, cls_logits.shape[2]))
            masks_a = mask_logits.gather(
                1, idx[:, :, None, None].expand(-1, -1, *mask_logits.shape[2:]))
            query_a = query.gather(1, idx[:, :, None].expand(-1, -1, query.shape[2]))
            wid = torch.as_tensor(win_id[lo:lo + r], dtype=torch.long, device=dev)
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

    def _package(self, fusion, query) -> List[Dict]:
        """Device fusion outputs -> host per-frame dicts {'pan_results',
        'query_feats': {segment_id: mean query feature}}."""
        pan = fusion["pan_seg"].cpu().numpy()
        keep = fusion["query_keep"].cpu().numpy()
        seg_ids = fusion["segment_id"].cpu().numpy()
        q = query.float().cpu().numpy()
        return [{"pan_results": pan[t],
                 "query_feats": query_feats_by_segment(
                     {"query_keep": keep[t], "segment_id": seg_ids[t]}, q[t])}
                for t in range(pan.shape[0])]
