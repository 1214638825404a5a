"""Fused bilinear upsample + argmax (the seg-head epilogue) on Hopper, and
its plain version.

``upsample_argmax`` launches ``csrc/upsample_argmax.cu`` for a CUDA tensor:
(B, h, w, C) fp32 grid logits -> (B, H, W) int32 class map, with both
interpolation stages and the class argmax fused so the (B, H, W, C) fp32
logits never reach device memory. It replaces the TPU package's
``ops/upsample_argmax.py:_kernel``. For a CPU tensor it runs
``upsample_argmax_plain``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from visiontransformer_tpu_torch.ops import _build
from visiontransformer_tpu_torch.ops.resize import (
    bilinear_matrix,
    resize_bilinear_mm,
)

_SIGNATURES = {"vt_upsample_argmax": (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    ctypes.c_int)}


def upsample_argmax_plain(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """argmax(resize_bilinear_mm(x, size), -1) as int32 (first index wins
    ties)."""
    return torch.argmax(resize_bilinear_mm(x, size), dim=-1).to(torch.int32)


def interpolation_taps(out_size: int, in_size: int):
    """(out, 2) int32 taps and (out, 2) float32 weights: the non-zeros of
    each ``bilinear_matrix`` row, a row with one non-zero padded with a
    zero weight on the same tap."""
    mat = bilinear_matrix(out_size, in_size)
    idx = np.zeros((out_size, 2), np.int32)
    wts = np.zeros((out_size, 2), np.float32)
    for r, row in enumerate(mat):
        nz = np.flatnonzero(row)
        idx[r, :] = nz[0]
        idx[r, :len(nz)] = nz
        wts[r, :len(nz)] = row[nz]
    return idx, wts


@functools.lru_cache(maxsize=64)
def _taps_on(out_size: int, in_size: int, device: str):
    idx, wts = interpolation_taps(out_size, in_size)
    return torch.from_numpy(idx).to(device), torch.from_numpy(wts).to(device)


def upsample_argmax(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, h, w, C) fp32 grid logits -> (B, H, W) int32 argmax class map.

    CUDA: the hand-written fused kernel (x must be contiguous fp32). CPU:
    the plain version. Anything else raises."""
    if x.device.type == "cpu":
        return upsample_argmax_plain(x, size)
    if x.device.type != "cuda":
        raise ValueError(f"upsample_argmax: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"upsample_argmax: expects float32, got {x.dtype}")
    if x.dim() != 4 or min(x.shape) < 1:
        raise ValueError(f"upsample_argmax: expects non-empty (B, h, w, C), "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("upsample_argmax: x must be contiguous")
    out_h, out_w = (int(s) for s in size)
    if out_h < 1 or out_w < 1:
        raise ValueError(f"upsample_argmax: bad output size {size}")
    b, in_h, in_w, c = x.shape
    h_idx, h_w = _taps_on(out_h, in_h, str(x.device))
    w_idx, w_w = _taps_on(out_w, in_w, str(x.device))
    out = torch.empty((b, out_h, out_w), dtype=torch.int32, device=x.device)
    lib = _build.load("upsample_argmax", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vt_upsample_argmax(
            x.data_ptr(), h_idx.data_ptr(), h_w.data_ptr(), w_idx.data_ptr(),
            w_w.data_ptr(), out.data_ptr(), b, in_h, in_w, c, out_h, out_w,
            stream)
    _build.check(lib, err, "upsample_argmax")
    upsample_argmax.launches += 1
    return out


# Kernel launches since the last reset (read by chip_smoke.py to prove the
# main path ran through the kernel).
upsample_argmax.launches = 0
