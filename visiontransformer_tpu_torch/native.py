"""Host helpers from the repository's C++ library.

``ctypes`` bindings to ``native/vitseg_native.cpp``, as the TPU package's
``native/__init__.py`` binds it: ``vn_skeletonize`` (Zhang-Suen thinning
for ``paed_loss_hard``), ``vn_label`` and ``vn_bounding_boxes``
(4-connected components and their boxes), ``vn_detections`` (all classes'
boxes in one pass, for the serving worker), ``vn_edt`` (exact EDT),
``vn_remap_u8`` and ``vn_resize_nearest_pil_u8`` (mask LUT remap and
PIL-exact nearest resize for the datasets).

The port compiles the source itself, at first use, into the git-ignored
``visiontransformer_tpu_torch/_build/native/`` (it reads ``native/`` and
never writes there): under a file lock, to a temporary name that is then
renamed, so processes that start together wait for one build and never
load a half-written library. The library's name holds a hash of the
source, the flags and the host's CPU (``-march=native``). A failed build
raises on the call that needed the library; ``VITSEG_NATIVE=0`` selects
the numpy/scipy/PIL fallbacks (``ops/morphology.py``). All are host code;
a fallback is not a device fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

SOURCE = (Path(__file__).resolve().parent.parent / "native"
          / "vitseg_native.cpp")
BUILD_DIR = Path(__file__).resolve().parent / "_build" / "native"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
            "-shared")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")

_SIGNATURES = {
    "vn_skeletonize": ([_u8, ctypes.c_int, ctypes.c_int, ctypes.c_int],
                       ctypes.c_int),
    "vn_label": ([_u8, _i32, ctypes.c_int, ctypes.c_int], ctypes.c_int),
    "vn_bounding_boxes": ([_i32, ctypes.c_int, _i32, ctypes.c_int,
                           ctypes.c_int], None),
    "vn_detections": ([_i32, _i32, ctypes.c_int, ctypes.c_int, _i32,
                       ctypes.c_int], ctypes.c_int),
    "vn_edt": ([_u8, _f32, ctypes.c_int, ctypes.c_int], None),
    "vn_remap_u8": ([_u8, _i32, _i32, ctypes.c_long], None),
    "vn_resize_nearest_pil_u8": ([_u8, _u8, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int], None),
}


def _cpu_identity() -> str:
    """What ``-march=native`` compiles for: the first CPU's model and flags
    (the machine's name where /proc/cpuinfo is absent)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [line for line in f if line.startswith(
                ("model name", "flags", "Features"))]
        return "".join(dict.fromkeys(lines)) or platform.machine()
    except OSError:
        return platform.machine()


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXXFLAGS).encode())
    digest.update(SOURCE.read_bytes())
    digest.update(_cpu_identity().encode())
    return BUILD_DIR / f"libvitseg_native.{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiled first if no process has built it yet.
    Raises RuntimeError when the compiler fails or is absent."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if path.exists():  # another process built it while we waited
            return path
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp),
               str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(
                f"building the native library failed ({e}); set "
                f"VITSEG_NATIVE=0 for the numpy fallbacks") from e
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building the native library failed: {' '.join(cmd)}\n"
                f"{proc.stderr}\nset VITSEG_NATIVE=0 for the numpy "
                f"fallbacks")
        os.replace(tmp, path)
    return path


def _load() -> Optional[ctypes.CDLL]:
    """The library, or None when VITSEG_NATIVE=0. Nothing is remembered
    from a failed build: the next call tries again."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        if os.environ.get("VITSEG_NATIVE") == "0":
            _TRIED = True
            return None
        lib = ctypes.CDLL(str(build()))
        for fn, (argtypes, restype) in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIB, _TRIED = lib, True
        return _LIB


def available() -> bool:
    return _load() is not None


def skeletonize(mask: np.ndarray, max_iters: int = 10000) -> np.ndarray:
    """Zhang-Suen thinning of a binary (H, W) mask; bool skeleton."""
    lib = _load()
    img = np.ascontiguousarray((np.asarray(mask) > 0).astype(np.uint8))
    if lib is None:
        from visiontransformer_tpu_torch.ops.morphology import skeletonize_np
        return skeletonize_np(img, max_iters)
    h, w = img.shape
    lib.vn_skeletonize(img, h, w, max_iters)
    return img.astype(bool)


def label(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """4-connected labeling (scipy.ndimage.label default semantics)."""
    lib = _load()
    img = np.ascontiguousarray((np.asarray(mask) > 0).astype(np.uint8))
    if lib is None:
        from visiontransformer_tpu_torch.ops.morphology import (
            connected_components_np,
        )
        return connected_components_np(img)
    h, w = img.shape
    labels = np.empty((h, w), np.int32)
    n = lib.vn_label(img, labels, h, w)
    return labels, n


def bounding_boxes(mask: np.ndarray) -> List[Tuple[int, int, int, int]]:
    """Per-region (y_min, x_min, y_max, x_max) boxes."""
    lib = _load()
    if lib is None:
        from visiontransformer_tpu_torch.ops.morphology import (
            bounding_boxes_np,
        )
        return bounding_boxes_np(mask)
    labels, n = label(mask)
    if n == 0:
        return []
    boxes = np.empty((n, 4), np.int32)
    h, w = labels.shape
    lib.vn_bounding_boxes(np.ascontiguousarray(labels), n, boxes, h, w)
    return [tuple(int(v) for v in row) for row in boxes]


def _detections_np(mask: np.ndarray) -> List[Tuple[int, int, int, int, int]]:
    from visiontransformer_tpu_torch.ops.morphology import (
        connected_components_np,
    )

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


def edt(mask: np.ndarray) -> np.ndarray:
    """Exact EDT: distance of nonzero pixels to the nearest zero pixel."""
    lib = _load()
    img = np.ascontiguousarray((np.asarray(mask) > 0).astype(np.uint8))
    if lib is None:
        from scipy.ndimage import distance_transform_edt
        return distance_transform_edt(img).astype(np.float32)
    h, w = img.shape
    out = np.empty((h, w), np.float32)
    lib.vn_edt(img, out, h, w)
    return out


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
