"""Bilinear resize in interpolation-matrix form (align_corners=False).

Copy of the TPU package's ``ops/resize.py:bilinear_matrix`` and
``resize_bilinear_mm``: the source coordinates are computed in float64 on
the host, so the matrix is bit-identical to the reference's; the resize is
two fp32 products with it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def bilinear_matrix(out_size: int, in_size: int) -> np.ndarray:
    """Dense (out, in) float32 interpolation matrix for align_corners=False
    bilinear resize. Each row has at most two non-zeros; where both taps
    are the same pixel (the clamped edge) it holds one merged weight."""
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = (src - lo).astype(np.float32)
    mat = np.zeros((out_size, in_size), np.float32)
    mat[np.arange(out_size), lo] += 1.0 - w_hi
    mat[np.arange(out_size), hi] += w_hi
    return mat


@functools.lru_cache(maxsize=64)
def _matrix_on(out_size: int, in_size: int, device: str) -> torch.Tensor:
    return torch.from_numpy(bilinear_matrix(out_size, in_size)).to(device)


def resize_bilinear_mm(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, h, w, C) -> (B, H, W, C) fp32 bilinear resize as two
    interpolation-matrix products (H stage, then W stage)."""
    out_h, out_w = size
    wh = _matrix_on(out_h, x.shape[1], str(x.device))
    ww = _matrix_on(out_w, x.shape[2], str(x.device))
    x = torch.einsum("Hh,bhwc->bHwc", wh, x.float())
    return torch.einsum("Ww,bHwc->bHWc", ww, x)
