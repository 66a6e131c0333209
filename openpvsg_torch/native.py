"""ctypes binding of the in-repo C++ host library (``native/pvsg_native.cpp``):
the RLE codec of ``masks.txt`` (encode, decode, area, IoU, string <-> run
counts), the rectangular Hungarian solver behind the MinVIS stitch, LAPJV
with a cost limit (the tracker's association), and the one-pass (gt, pred)
IoU matrix of stage 3's tube matching and the MOTS metrics.

The library is compiled with g++ into the port's own build directory
(``openpvsg_torch/build/native/``) at first use. Sharing the C++ source with
``openpvsg_tpu`` keeps LAP tie-breaking, and so the MinVIS query order,
identical in both packages. Without a C++ toolchain the RLE encoder falls
back to numpy (bit-identical) and the solver to scipy, as in
``openpvsg_tpu.native``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "pvsg_native.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "build", "native")
_SO_PATH = os.path.join(_BUILD_DIR, "libpvsg_native.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> bool:
    """Compile into a temporary file and rename it into place, so processes
    building at the same time never load a half-written library."""
    if not os.path.exists(_SRC):
        return False
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=300)
        os.replace(tmp, _SO_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """The loaded library, built if missing or older than its source; None
    when it cannot be built."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        stale = (not os.path.exists(_SO_PATH)
                 or (os.path.exists(_SRC)
                     and os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC)))
        if stale and not _build():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            _build_failed = True
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.rle_encode_to_string.restype = ctypes.c_int64
        lib.rle_encode_to_string.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p]
        lib.rle_decode_from_string.restype = None
        lib.rle_decode_from_string.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, u8p]
        lib.rle_area_from_string.restype = ctypes.c_int64
        lib.rle_area_from_string.argtypes = [ctypes.c_char_p]
        lib.rle_iou_from_strings.restype = ctypes.c_double
        lib.rle_iou_from_strings.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.rle_string_to_counts.restype = ctypes.c_int64
        lib.rle_string_to_counts.argtypes = [ctypes.c_char_p, u32p]
        lib.pairwise_mask_iou.restype = None
        lib.pairwise_mask_iou.argtypes = [
            i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double)]
        lib.lapjv.restype = ctypes.c_double
        lib.lapjv.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ctypes.c_double, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.hungarian.restype = ctypes.c_int
        lib.hungarian.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


def lapjv(cost: np.ndarray, cost_limit: float = np.inf):
    """lap.lapjv-compatible assignment with a cost limit: (total_cost, x, y)
    with x[i] the column matched to row i (or -1) and y[j] the row matched
    to column j (or -1). Matches costing more than ``cost_limit`` are left
    unassigned (reference: models/unitrack/core/association/matching.py:29-40
    with extend_cost=True)."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    nr, nc = cost.shape
    if nr == 0 or nc == 0:
        return 0.0, -np.ones(nr, dtype=np.int32), -np.ones(nc, dtype=np.int32)
    lib = get_lib()
    if lib is not None:
        x = np.empty(nr, dtype=np.int32)
        y = np.empty(nc, dtype=np.int32)
        total = lib.lapjv(
            nr, nc, cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            float(cost_limit),
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return float(total), x, y
    # scipy on the same padded square matrix
    from scipy.optimize import linear_sum_assignment as lsa

    n = nr + nc
    pad = cost_limit / 2.0 if np.isfinite(cost_limit) else cost.max() + 1.0
    big = np.full((n, n), pad, dtype=np.float64)
    big[:nr, :nc] = cost
    big[nr:, nc:] = 0.0
    x = -np.ones(nr, dtype=np.int32)
    y = -np.ones(nc, dtype=np.int32)
    for i, j in zip(*lsa(big)):
        if i < nr and j < nc:
            x[i], y[j] = j, i
    return float(sum(cost[i, x[i]] for i in range(nr) if x[i] >= 0)), x, y


def linear_sum_assignment(cost: np.ndarray):
    """scipy-compatible rectangular min-cost assignment (row_ind, col_ind)."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    nr, nc = cost.shape
    if nr == 0 or nc == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    lib = get_lib()
    if lib is not None and np.isfinite(cost).all():
        k = min(nr, nc)
        ri = np.empty(k, dtype=np.int32)
        ci = np.empty(k, dtype=np.int32)
        got = lib.hungarian(
            nr, nc,
            cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ri.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return ri[:got].astype(np.int64), ci[:got].astype(np.int64)
    import scipy.optimize

    return scipy.optimize.linear_sum_assignment(cost)


def pairwise_mask_iou(gt: np.ndarray, pred: np.ndarray, n_gt: int,
                      n_pred: int) -> np.ndarray:
    """(n_gt, n_pred) float64 IoU of every (gt label, pred label) pair of
    two dense-id label maps of one size (-1 = background): one pass over
    the pixels in C++, or a joint histogram in numpy that gives the same
    bits (int64 counts, one float64 division)."""
    gt = np.ascontiguousarray(gt, dtype=np.int32).ravel()
    pred = np.ascontiguousarray(pred, dtype=np.int32).ravel()
    if gt.size != pred.size:
        raise ValueError(f"label maps of {gt.size} and {pred.size} pixels")
    out = np.zeros((n_gt, n_pred), dtype=np.float64)
    if n_gt == 0 or n_pred == 0:
        return out
    lib = get_lib()
    if lib is not None:
        lib.pairwise_mask_iou(
            gt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            pred.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            gt.size, n_gt, n_pred,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out
    valid = (gt >= 0) & (pred >= 0)
    joint = gt[valid].astype(np.int64) * n_pred + pred[valid]
    inter = np.bincount(joint, minlength=n_gt * n_pred).reshape(n_gt, n_pred)
    ga = np.bincount(gt[gt >= 0], minlength=n_gt)[:, None]
    pa = np.bincount(pred[pred >= 0], minlength=n_pred)[None, :]
    union = ga + pa - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)
