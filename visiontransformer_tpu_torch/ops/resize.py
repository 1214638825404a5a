"""Resize ops with the TPU package's index semantics.

- ``bilinear_matrix`` / ``resize_bilinear_mm``: bilinear resize
  (align_corners=False) in interpolation-matrix form, copies of the TPU
  package's: the source coordinates are computed in float64 on the host, so
  the matrix is bit-identical to the reference's; the resize is two fp32
  products with it.
- ``resize_bilinear``: the same resize in gather form, top + w·(bot −
  top) per axis, the TPU package's ``resize_bilinear``: its source
  coordinates and weights are fp32, computed on the host with the TPU
  package's fp32 arithmetic, so the result is bit-identical to it (and
  differs from the matrix form by an ulp; the PAED loss resizes its SDFs
  with it).
- ``resize_nearest_torch``: torch ``F.interpolate(mode='nearest')``
  indices, src = floor(dst · in/out) computed in float64, as the TPU
  package's ``_nearest_indices_torch``; the training tasks bring integer
  targets to the input size with it.
- ``resize_nearest_pil``: PIL ``Image.resize(NEAREST)`` indices, the
  source coordinate advanced by repeated ``+= scale`` in float64, as the
  TPU package's ``_nearest_indices_pil``; the evaluation sweep brings its
  ground truth to the prediction grid with it.

Index and weight tables are cached per device: a fresh copy from host
memory would wait for the card at every call. They are made outside
inference mode, so a table first made by a forward under
``torch.inference_mode`` (the serving runner's) can be saved for the
backward of a later training step.
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
@torch.inference_mode(False)
def _matrix_on(out_size: int, in_size: int, device: str) -> torch.Tensor:
    return torch.from_numpy(bilinear_matrix(out_size, in_size)).to(device)


def cached_table(cached, *args):
    """``cached(*args)`` from a per-shape ``lru_cache``, but made afresh
    while ``torch.export`` traces: the tracer's tensors are fake, and a
    table made then is a constant of the program that must not enter the
    cache."""
    if torch.compiler.is_exporting():
        return cached.__wrapped__(*args)
    return cached(*args)


def _matrix(out_size: int, in_size: int, device) -> torch.Tensor:
    return cached_table(_matrix_on, out_size, in_size, str(device))


def resize_bilinear_mm(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, h, w, C) -> (B, H, W, C) fp32 bilinear resize as two
    interpolation-matrix products (H stage, then W stage)."""
    out_h, out_w = size
    wh = _matrix(out_h, x.shape[1], x.device)
    ww = _matrix(out_w, x.shape[2], x.device)
    x = torch.einsum("Hh,bhwc->bHwc", wh, x.float())
    return torch.einsum("Ww,bHwc->bHWc", ww, x)


def nearest_indices_torch(out_size: int, in_size: int) -> np.ndarray:
    """int64 source indices floor(i · in/out), clipped, for
    F.interpolate(mode='nearest'); float64 avoids fp32 boundary errors at
    exact-integer source coordinates."""
    scale = in_size / out_size
    idx = np.floor(np.arange(out_size, dtype=np.float64) * scale)
    return np.clip(idx.astype(np.int64), 0, in_size - 1)


def nearest_indices_pil(out_size: int, in_size: int) -> np.ndarray:
    """int64 source indices of PIL's NEAREST resize: a coordinate that
    starts at scale/2 and is advanced by ``+= scale`` in float64, then
    truncated; the per-step rounding drift shows at exact-integer
    boundaries, so the accumulation is replicated literally."""
    scale = in_size / out_size
    xo = scale * 0.5
    idx = np.empty(out_size, dtype=np.int64)
    for i in range(out_size):
        idx[i] = int(xo)
        xo += scale
    return np.clip(idx, 0, in_size - 1)


_NEAREST = {"torch": nearest_indices_torch, "pil": nearest_indices_pil}


@functools.lru_cache(maxsize=64)
@torch.inference_mode(False)
def _nearest_on(kind: str, out_size: int, in_size: int,
                device: str) -> torch.Tensor:
    return torch.from_numpy(_NEAREST[kind](out_size, in_size)).to(device)


def _resize_nearest(kind: str, x: torch.Tensor, size: Tuple[int, int],
                    h_axis: int, w_axis: int) -> torch.Tensor:
    h_axis, w_axis = h_axis % x.dim(), w_axis % x.dim()
    rows = cached_table(_nearest_on, kind, size[0], x.shape[h_axis],
                        str(x.device))
    cols = cached_table(_nearest_on, kind, size[1], x.shape[w_axis],
                        str(x.device))
    return torch.index_select(torch.index_select(x, h_axis, rows), w_axis,
                              cols)


def resize_nearest_torch(x: torch.Tensor, size: Tuple[int, int],
                         h_axis: int = -2, w_axis: int = -1) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') semantics along (h_axis,
    w_axis), for any dtype (integer targets included)."""
    return _resize_nearest("torch", x, size, h_axis, w_axis)


def resize_nearest_pil(x: torch.Tensor, size: Tuple[int, int],
                       h_axis: int = -2, w_axis: int = -1) -> torch.Tensor:
    """PIL Image.resize(NEAREST) semantics along (h_axis, w_axis), for any
    dtype."""
    return _resize_nearest("pil", x, size, h_axis, w_axis)


def _linear_weights(out_size: int, in_size: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lo, hi, w_hi) of the gather form: half-pixel (align_corners=False)
    source coordinates (i + 0.5)·scale − 0.5 clipped to [0, in − 1], in
    fp32 as the TPU package's ``_linear_weights`` computes them."""
    f32 = np.float32
    src = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(
        in_size / out_size) - f32(0.5)
    src = np.clip(src, f32(0.0), f32(in_size - 1))
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo.astype(f32)).astype(f32)


@functools.lru_cache(maxsize=64)
@torch.inference_mode(False)
def _linear_on(out_size: int, in_size: int, device: str):
    return tuple(torch.from_numpy(a).to(device)
                 for a in _linear_weights(out_size, in_size))


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    h_axis: int = -2, w_axis: int = -1) -> torch.Tensor:
    """Bilinear resize (align_corners=False) along (h_axis, w_axis) in
    gather form: two separable fp32 lerps, top + w·(bot − top), the H axis
    first. Floating inputs come back in their dtype, others as fp32."""
    h_axis, w_axis = h_axis % x.dim(), w_axis % x.dim()
    orig_dtype = x.dtype
    x = x.float()
    for axis, out in ((h_axis, size[0]), (w_axis, size[1])):
        lo, hi, w = cached_table(_linear_on, out, x.shape[axis],
                                 str(x.device))
        shape = [1] * x.dim()
        shape[axis] = out
        a = torch.index_select(x, axis, lo)
        x = a + w.reshape(shape) * (torch.index_select(x, axis, hi) - a)
    return x.to(orig_dtype) if orig_dtype.is_floating_point else x
