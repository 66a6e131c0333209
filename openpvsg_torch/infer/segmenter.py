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
    """Owns the model on one device and runs forward + stitch + fusion.

    ``state_dict`` is the port's float32 state dict (``weights.py``). With
    ``fold_bn`` (default) and a BatchNorm ResNet the BN affines are folded
    into the convs first (a Swin backbone has no BN: nothing to fold). ``dtype`` is the compute dtype (float32 or
    bfloat16). ``device=None`` means the GPU and raises when there is none;
    pass ``device="cpu"`` to run on the CPU.
    """

    MEAN = (123.675, 116.28, 103.53)
    STD = (58.395, 57.12, 57.375)

    def __init__(self, cfg: Mask2FormerConfig, state_dict: Dict[str, torch.Tensor],
                 dtype: torch.dtype = torch.float32, device=None,
                 pad_divisor: int = 32, fold_bn: bool = True):
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
        model = Mask2Former(cfg)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self._mean = torch.tensor(self.MEAN, dtype=torch.float32,
                                  device=self.device)
        self._std = torch.tensor(self.STD, dtype=torch.float32,
                                 device=self.device)

    def _padded_hw(self, frames) -> Tuple[int, int]:
        return pad_to_divisor(*frames.shape[1:3], self.pad_divisor)

    @torch.no_grad()
    def forward_frames(self, frames: np.ndarray):
        """frames: (N, H, W, 3) uint8 RGB, normalized and zero-padded to the
        divisor here, on the device. Each frame runs with T=1. Returns
        device tensors (cls (N, Q, K+1), masks (N, Q, Hp/4, Wp/4) in the
        model's ``mask_logits_dtype``, query (N, Q, C)). Fusion reads the
        masks as float32: bfloat16 logits are widened exactly, and kernel
        B2 upsamples them in float32 (the JAX package upsamples and takes
        the sigmoid in bfloat16)."""
        frames = np.asarray(frames)
        if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[3] != 3:
            raise ValueError("forward_frames takes (N, H, W, 3) uint8 frames, "
                             f"got {frames.dtype} {frames.shape}")
        x = torch.from_numpy(frames).to(self.device)
        x = (x.float() - self._mean) / self._std
        h, w = x.shape[1:3]
        ph, pw = self._padded_hw(frames)
        x = torch.nn.functional.pad(x, (0, 0, 0, pw - w, 0, ph - h))
        return self.model(x.to(self.dtype))

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
        cls_logits, mask_logits, query = self.forward_frames(frames)
        fusion = panoptic_fusion(
            cls_logits, mask_logits, self.cfg.num_things_classes,
            self.cfg.num_stuff_classes, self.cfg.object_mask_thr,
            self.cfg.iou_thr, self._padded_hw(frames), ori_hw)
        return fusion, query

    def package_ips(self, handle) -> List[Dict]:
        """Blocking half of ``infer_frames_ips``: fetch a handle's results
        to host per-frame dicts."""
        fusion, query = handle
        return self._package(fusion, query)

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
        cls_logits, mask_logits, query = self.forward_frames(frames)
        return cls_logits, mask_logits, query, self._padded_hw(frames), ori_hw

    @torch.no_grad()
    def finish_windows_vps(self, handle, window: int,
                           prev_embds: Optional[np.ndarray] = None,
                           chain_windows: bool = False,
                           return_embds: bool = False):
        """Fetch the query embeddings, run the MinVIS stitch, then
        align + fuse + package."""
        cls_logits, mask_logits, query, padded_hw, ori_hw = handle
        n = cls_logits.shape[0]
        embds = query.float().cpu().numpy()
        Q = embds.shape[1]
        perms = np.zeros((n, Q), np.int32)
        prev = prev_embds if chain_windows else None
        for lo in range(0, n, window):
            seg = embds[lo:lo + window]
            p = minvis_stitch(seg, prev=prev)
            perms[lo:lo + window] = p
            if chain_windows:
                prev = seg[-1][p[-1]]
        win_id = np.arange(n) // window
        fusion, query_a = self._align_fuse_impl(
            cls_logits, mask_logits, query, perms, win_id,
            int(win_id[-1]) + 1, padded_hw, ori_hw)
        outputs = self._package(fusion, query_a)
        if return_embds:
            return outputs, query_a[-1].float().cpu().numpy()
        return outputs

    def _align_fuse_impl(self, cls_logits, mask_logits, query, perms, win_id,
                         n_win, padded_hw, ori_hw):
        """Align by the host-computed perms, average the class logits over
        each window, then fuse every frame of the batch in one pass."""
        idx = torch.as_tensor(perms, dtype=torch.long, device=self.device)
        cls_a = cls_logits.gather(
            1, idx[:, :, None].expand(-1, -1, cls_logits.shape[2]))
        masks_a = mask_logits.gather(
            1, idx[:, :, None, None].expand(-1, -1, *mask_logits.shape[2:]))
        query_a = query.gather(1, idx[:, :, None].expand(-1, -1, query.shape[2]))
        wid = torch.as_tensor(win_id, dtype=torch.long, device=self.device)
        sums = torch.zeros((n_win, *cls_a.shape[1:]), dtype=cls_a.dtype,
                           device=self.device).index_add_(0, wid, cls_a)
        cnt = torch.zeros((n_win,), dtype=cls_a.dtype,
                          device=self.device).index_add_(
            0, wid, torch.ones_like(wid, dtype=cls_a.dtype))
        cls_mean = sums[wid] / cnt[wid][:, None, None]
        fusion = panoptic_fusion(
            cls_mean, masks_a, self.cfg.num_things_classes,
            self.cfg.num_stuff_classes, self.cfg.object_mask_thr,
            self.cfg.iou_thr, padded_hw, ori_hw)
        return fusion, query_a

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
