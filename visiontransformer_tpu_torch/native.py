"""Host helpers from the repository's C++ library.

``ctypes`` bindings to ``vn_detections`` (connected-component detections
for the serving worker), ``vn_remap_u8`` and ``vn_resize_nearest_pil_u8``
(mask LUT remap and PIL-exact nearest resize for the datasets) and
``vn_skeletonize`` (Zhang-Suen thinning for ``paed_loss_hard``) of
``native/vitseg_native.cpp``, built with ``make -C native`` at first use,
each with a pure-Python/numpy/PIL fallback when the library cannot be built
or ``VITSEG_NATIVE=0``. All are host code; a fallback is not a device
fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libvitseg_native.so")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


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
        lib.vn_skeletonize.argtypes = [_u8, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int]
        lib.vn_skeletonize.restype = ctypes.c_int
        lib.vn_detections.argtypes = [_i32, _i32, ctypes.c_int, ctypes.c_int,
                                      _i32, ctypes.c_int]
        lib.vn_detections.restype = ctypes.c_int
        lib.vn_remap_u8.argtypes = [_u8, _i32, _i32, ctypes.c_long]
        lib.vn_remap_u8.restype = None
        lib.vn_resize_nearest_pil_u8.argtypes = [
            _u8, _u8, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.vn_resize_nearest_pil_u8.restype = None
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def _neighbours(padded: np.ndarray):
    """P2..P9 clockwise from north, for the interior view of a padded image."""
    return (padded[0:-2, 1:-1], padded[0:-2, 2:], padded[1:-1, 2:],
            padded[2:, 2:], padded[2:, 1:-1], padded[2:, 0:-2],
            padded[1:-1, 0:-2], padded[0:-2, 0:-2])


def skeletonize_np(mask: np.ndarray, max_iters: int = 10000) -> np.ndarray:
    """Zhang-Suen thinning of a binary (H, W) mask to a 1-px skeleton,
    first-party numpy (replaces the reference's skimage skeletonize,
    reference model/PAED/segmentation.py:89-111)."""
    img = (np.asarray(mask) > 0).astype(np.uint8)
    for _ in range(max_iters):
        changed = False
        for step in (0, 1):
            p2, p3, p4, p5, p6, p7, p8, p9 = _neighbours(np.pad(img, 1))
            ring = np.stack([p2, p3, p4, p5, p6, p7, p8, p9, p2], axis=0)
            # A: 0 -> 1 transitions around the ring; B: nonzero neighbours.
            a = np.sum((ring[:-1] == 0) & (ring[1:] == 1), axis=0)
            b = np.sum(ring[:-1], axis=0)
            if step == 0:
                cond = (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
            else:
                cond = (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
            delete = (img == 1) & (a == 1) & (b >= 2) & (b <= 6) & cond
            if delete.any():
                img[delete] = 0
                changed = True
        if not changed:
            break
    return img.astype(bool)


def skeletonize(mask: np.ndarray, max_iters: int = 10000) -> np.ndarray:
    """Zhang-Suen thinning of a binary (H, W) mask; bool skeleton."""
    lib = _load()
    img = np.ascontiguousarray((np.asarray(mask) > 0).astype(np.uint8))
    if lib is None:
        return skeletonize_np(img, max_iters)
    h, w = img.shape
    lib.vn_skeletonize(img, h, w, max_iters)
    return img.astype(bool)


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


def remap_u8(values: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """values: uint8 array; lut: 256-entry int32 -> class indices."""
    lib = _load()
    values = np.ascontiguousarray(values, np.uint8)
    lut = np.ascontiguousarray(lut, np.int32)
    if lib is None:
        return lut[values]
    out = np.empty(values.shape, np.int32)
    lib.vn_remap_u8(values.reshape(-1), lut, out.reshape(-1), values.size)
    return out


def resize_nearest_pil_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL-NEAREST-exact resize of a 2D uint8 image to (h, w)."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    oh, ow = size
    if lib is None:
        return np.asarray(Image.fromarray(img).resize((ow, oh), Image.NEAREST))
    ih, iw = img.shape
    out = np.empty((oh, ow), np.uint8)
    lib.vn_resize_nearest_pil_u8(img, out, ih, iw, oh, ow)
    return out
