"""Connected-component detections for the serving worker.

A ``ctypes`` binding to ``vn_detections`` of the repository's C++ host
library (``native/vitseg_native.cpp``, built with ``make -C native`` at
first use), with a pure-Python per-class fallback when the library cannot
be built or ``VITSEG_NATIVE=0``. Both are host code; the fallback is not a
device fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libvitseg_native.so")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("VITSEG_NATIVE") == "0":
            return None
        if not os.path.exists(_SO_PATH):
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                               capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        lib.vn_detections.argtypes = [_i32, _i32, ctypes.c_int, ctypes.c_int,
                                      _i32, ctypes.c_int]
        lib.vn_detections.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def connected_components_np(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """4-connected labelling of a binary mask (scipy.ndimage.label default
    structure): (int32 labels, count). Union-find, first-party Python."""
    mask = np.asarray(mask) > 0
    h, w = mask.shape
    labels = np.zeros((h, w), dtype=np.int32)
    parent: List[int] = [0]

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    next_label = 1
    for i in range(h):
        for j in range(w):
            if not mask[i, j]:
                continue
            up = labels[i - 1, j] if i > 0 else 0
            left = labels[i, j - 1] if j > 0 else 0
            if up == 0 and left == 0:
                parent.append(next_label)
                labels[i, j] = next_label
                next_label += 1
            elif up != 0 and left != 0:
                ru, rl = find(up), find(left)
                labels[i, j] = min(ru, rl)
                if ru != rl:
                    parent[max(ru, rl)] = min(ru, rl)
            else:
                labels[i, j] = up or left

    remap = {}
    flat = labels.reshape(-1)
    roots = np.zeros_like(flat)
    for idx, lab in enumerate(flat):
        if lab:
            roots[idx] = remap.setdefault(find(int(lab)), len(remap) + 1)
    return roots.reshape(h, w), len(remap)


def _detections_np(mask: np.ndarray) -> List[Tuple[int, int, int, int, int]]:
    out = []
    for cls in np.unique(mask):
        if cls == 0:
            continue
        labels, n = connected_components_np(mask == cls)
        for region in range(1, n + 1):
            ys, xs = np.nonzero(labels == region)
            out.append((int(cls), int(ys.min()), int(xs.min()),
                        int(ys.max()), int(xs.max())))
    return sorted(out)


def detections(class_mask: np.ndarray) -> List[Tuple[int, int, int, int, int]]:
    """(class_id, y_min, x_min, y_max, x_max) per 4-connected same-class
    region of an integer class mask (0 = background), sorted."""
    mask = np.ascontiguousarray(np.asarray(class_mask).astype(np.int32))
    lib = _load()
    if lib is None:
        return _detections_np(mask)
    h, w = mask.shape
    scratch = np.empty((h, w), np.int32)
    capacity = 4096
    while True:
        boxes = np.empty((capacity, 5), np.int32)
        n = lib.vn_detections(mask, scratch, h, w, boxes, capacity)
        if n <= capacity:
            return sorted(tuple(int(v) for v in row) for row in boxes[:n])
        capacity = n  # the first pass counted them all; one retry at most
