"""COCO-compatible RLE mask codec for ``masks.txt``, the port of
``openpvsg_tpu/data/rle.py``.

Bit-identical to pycocotools' rleToString / rleFrString: masks are scanned
in Fortran (column-major) order and runs alternate 0s/1s starting with a
zero-run. Fast path = the in-repo C++ library (``openpvsg_torch.native``);
fallback = numpy and Python.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Union

import numpy as np

from openpvsg_torch import native

RLE = Dict[str, Union[str, tuple]]


def mask_to_counts(mask: np.ndarray) -> np.ndarray:
    """Binary HxW mask -> raw run counts (uint32), column-major scan."""
    flat = np.asfortranarray(mask.astype(np.uint8) > 0).ravel(order="F")
    if flat.size == 0:
        return np.zeros(1, dtype=np.uint32)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).astype(np.uint32)
    if flat[0]:  # runs must start with a zero-run
        counts = np.concatenate([[0], counts]).astype(np.uint32)
    return counts


def counts_to_mask(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Raw run counts -> binary HxW uint8 mask."""
    counts = np.asarray(counts, dtype=np.int64)
    n = int(counts.sum())
    vals = np.zeros(len(counts), dtype=np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if n < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - n, dtype=np.uint8)])
    return flat[: h * w].reshape(h, w, order="F")


def string_to_counts(s: str) -> np.ndarray:
    """pycocotools' rleFrString: the inverse of ``counts_to_string``."""
    counts = []
    p = 0
    n = len(s)
    while p < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, dtype=np.uint32)


def counts_to_string(counts: np.ndarray) -> str:
    """pycocotools' rleToString: delta + 5-bit varint, ascii offset 48."""
    out = []
    counts = np.asarray(counts, dtype=np.int64)
    for i in range(len(counts)):
        x = int(counts[i])
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def encode(mask: np.ndarray) -> RLE:
    """Encode a binary HxW mask into {'size': (h, w), 'counts': str}."""
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = mask.shape
    lib = native.get_lib()
    if lib is not None:
        fmask = np.asfortranarray(mask).ravel(order="F")
        buf = ctypes.create_string_buffer(8 * (h * w + 2) + 16)
        n = lib.rle_encode_to_string(
            fmask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, buf)
        return {"size": (h, w), "counts": buf.raw[:n].decode("ascii")}
    return {"size": (h, w), "counts": counts_to_string(mask_to_counts(mask))}


def decode(rle: RLE) -> np.ndarray:
    """Decode {'size': (h, w), 'counts': str} into a binary HxW uint8 mask."""
    h, w = int(rle["size"][0]), int(rle["size"][1])
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    lib = native.get_lib()
    if lib is not None and isinstance(counts, str):
        out = np.zeros(h * w, dtype=np.uint8)
        lib.rle_decode_from_string(
            counts.encode("ascii"), h, w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out.reshape(h, w, order="F")
    if isinstance(counts, str):
        counts = string_to_counts(counts)
    return counts_to_mask(np.asarray(counts), h, w)


def area(rle: RLE) -> int:
    """Foreground pixel count straight from the counts."""
    counts = rle["counts"]
    if isinstance(counts, str):
        lib = native.get_lib()
        if lib is not None:
            return int(lib.rle_area_from_string(counts.encode("ascii")))
        counts = string_to_counts(counts)
    return int(np.asarray(counts, dtype=np.int64)[1::2].sum())


def iou(rle_a: RLE, rle_b: RLE) -> float:
    """IoU of two RLEs: a run merge in C++ without densifying, else on the
    decoded masks."""
    ca, cb = rle_a["counts"], rle_b["counts"]
    if isinstance(ca, str) and isinstance(cb, str):
        lib = native.get_lib()
        if lib is not None:
            return float(lib.rle_iou_from_strings(ca.encode("ascii"),
                                                  cb.encode("ascii")))
    a = decode(rle_a).astype(bool)
    b = decode(rle_b).astype(bool)
    union = np.logical_or(a, b).sum()
    return float(np.logical_and(a, b).sum() / union) if union > 0 else 0.0
