"""Fused bilinear upsample + argmax (the seg-head epilogue) on Hopper, and
its plain versions.

``upsample_argmax`` launches ``csrc/upsample_argmax.cu`` for a CUDA tensor
through the custom op ``vt::upsample_argmax``:
(B, h, w, C) fp32 or bf16 grid logits -> (B, H, W) class map, int32 (the
TPU kernel's type, the default) or uint8 (the serving path's mask type),
with both interpolation stages and the class argmax fused so the
(B, H, W, C) fp32 logits never reach device memory. It replaces the TPU
package's ``ops/upsample_argmax.py:_kernel``. ``epilogue_path`` names the
instantiation a shape takes. For a CPU tensor it runs
``upsample_argmax_plain``; ``upsample_argmax_tap_plain`` repeats the
kernel's arithmetic in its order, for checks on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from visiontransformer_tpu_torch.ops import _build
from visiontransformer_tpu_torch.utils import spans
from visiontransformer_tpu_torch.ops.resize import (
    bilinear_matrix,
    resize_bilinear_mm,
)

_SIGNATURES = {"vt_upsample_argmax": (
    [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_void_p], ctypes.c_int)}

IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
OUT_DTYPES = {torch.int32: 0, torch.uint8: 1}
# Output pixels a thread computes and stores together: one 16-byte int32
# store or one 4-byte uint8 word.
_GROUP = 4


def _check(b: int, h: int, w: int, c: int, out_h: int, out_w: int,
           out_dtype: torch.dtype) -> None:
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"upsample_argmax: out_dtype must be int32 or uint8, "
                        f"got {out_dtype}")
    if min(b, h, w, c) < 1 or out_h < 1 or out_w < 1 or b > 65535:
        raise ValueError(f"upsample_argmax: bad shape (B, h, w, C) = "
                         f"{(b, h, w, c)} -> {(out_h, out_w)}")
    if out_dtype == torch.uint8 and c > 256:
        raise ValueError(f"upsample_argmax: uint8 masks hold at most 256 "
                         f"classes, got {c}")


def _check_input(x: torch.Tensor, out_h: int, out_w: int,
                 out_dtype: torch.dtype) -> None:
    """Raise unless x is the (B, h, w, C) contiguous fp32 or bf16 tensor
    the kernel takes and the output fits ``out_dtype``. Every
    implementation of ``vt::upsample_argmax`` runs it, so a direct call of
    the op, or an exported program, holds to the wrapper's contract."""
    if x.dtype not in IN_DTYPES:
        raise TypeError(f"upsample_argmax: expects float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"upsample_argmax: expects (B, h, w, C), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("upsample_argmax: x must be contiguous")
    _check(*x.shape, out_h, out_w, out_dtype)


def epilogue_path(b: int, h: int, w: int, c: int, out_h: int, out_w: int,
                  out_dtype: torch.dtype = torch.int32) -> str:
    """Which instantiation of the epilogue kernel a (B, h, w, C) ->
    (out_h, out_w) shape takes on the card, e.g. "c17/uint8/vec": the
    class loop ("c17" fully unrolled for the repository's 17-class head,
    "chunked" a loop over chunks of 8 classes for any other C), the output
    type and the store ("vec": 4 pixels a store, 16 bytes of int32 or 4 of
    uint8, where out_w is a multiple of 4; else "scalar"). The kernel
    chooses its output rows a block at launch, from the card. Raises for a
    shape or type the kernel does not take."""
    _check(b, h, w, c, out_h, out_w, out_dtype)
    kind = "uint8" if out_dtype == torch.uint8 else "int32"
    return (f"{'c17' if c == 17 else 'chunked'}/{kind}/"
            f"{'vec' if out_w % _GROUP == 0 else 'scalar'}")


def upsample_argmax_plain(x: torch.Tensor, size: Tuple[int, int],
                          out_dtype: torch.dtype = torch.int32
                          ) -> torch.Tensor:
    """argmax(resize_bilinear_mm(x, size), -1) in ``out_dtype`` (first
    index wins ties); x is widened to fp32 first."""
    return torch.argmax(resize_bilinear_mm(x.float(), size), dim=-1).to(
        out_dtype)


def upsample_argmax_tap_plain(x: torch.Tensor, size: Tuple[int, int],
                              out_dtype: torch.dtype = torch.int32
                              ) -> torch.Tensor:
    """The kernel's arithmetic in eager PyTorch: the two taps of each row
    and column (``interpolation_taps``), every product and sum rounded on
    its own, H-stage first, then argmax (first index wins ties). Equal to
    the kernel bit for bit."""
    out_h, out_w = (int(s) for s in size)
    x = x.float()
    hi, hw = _taps_on(out_h, x.shape[1], str(x.device))
    wi, ww = _taps_on(out_w, x.shape[2], str(x.device))
    y = (x[:, hi[:, 0].long()] * hw[:, 0, None, None]
         + x[:, hi[:, 1].long()] * hw[:, 1, None, None])     # (B, H, w, C)
    z = (y[:, :, wi[:, 0].long()] * ww[:, 0, None]
         + y[:, :, wi[:, 1].long()] * ww[:, 1, None])         # (B, H, W, C)
    return torch.argmax(z, dim=-1).to(out_dtype)


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


def upsample_argmax(x: torch.Tensor, size: Tuple[int, int], *,
                    out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(B, h, w, C) fp32 or bf16 grid logits -> (B, H, W) argmax class map
    in ``out_dtype`` (int32, or uint8 for C <= 256), through the custom op
    ``vt::upsample_argmax``, which an exported program holds as one node.

    CUDA: the hand-written fused kernel (x contiguous; raises where one
    output row's H-stage, w x C fp32, exceeds a block's shared memory).
    CPU: the plain version. Anything else raises; so does every
    implementation of the op for an input the kernel does not take
    (``_check_input``)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"upsample_argmax: unsupported device {x.device}")
    out_h, out_w = (int(s) for s in size)
    return torch.ops.vt.upsample_argmax(x, out_h, out_w, out_dtype)


# ------------------------------------------------------ vt::upsample_argmax
# Kernel 5 as a PyTorch operator (see ``ops/flash_attention.py``, which
# registers kernel 1 in the same namespace): the CUDA implementation is the
# kernel's launch, the CPU one the plain version, the fake one the output's
# shape and type. The interpolation taps are made inside the CUDA
# implementation at run time, so an exported program holds none of them as
# constants.
_LIB = torch.library.Library("vt", "FRAGMENT")
_LIB.define("upsample_argmax(Tensor x, int out_h, int out_w, "
            "ScalarType out_dtype) -> Tensor")


def _upsample_argmax_cuda(x: torch.Tensor, out_h: int, out_w: int,
                          out_dtype: torch.dtype) -> torch.Tensor:
    _check_input(x, out_h, out_w, out_dtype)
    b, in_h, in_w, c = x.shape
    h_idx, h_w = _taps_on(out_h, in_h, str(x.device))
    w_idx, w_w = _taps_on(out_w, in_w, str(x.device))
    out = torch.empty((b, out_h, out_w), dtype=out_dtype, device=x.device)
    lib = _build.load("upsample_argmax", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vt_upsample_argmax(
            IN_DTYPES[x.dtype], OUT_DTYPES[out_dtype], x.data_ptr(),
            h_idx.data_ptr(), h_w.data_ptr(), w_idx.data_ptr(),
            w_w.data_ptr(), out.data_ptr(), b, in_h, in_w, c, out_h, out_w,
            stream)
    _build.check(lib, err, "upsample_argmax")
    spans.count("upsample_argmax")
    return out


def _upsample_argmax_cpu(x: torch.Tensor, out_h: int, out_w: int,
                         out_dtype: torch.dtype) -> torch.Tensor:
    _check_input(x, out_h, out_w, out_dtype)
    return upsample_argmax_plain(x, (out_h, out_w), out_dtype)


def _upsample_argmax_fake(x: torch.Tensor, out_h: int, out_w: int,
                          out_dtype: torch.dtype) -> torch.Tensor:
    _check_input(x, out_h, out_w, out_dtype)
    return x.new_empty((x.shape[0], out_h, out_w), dtype=out_dtype)


_LIB.impl("upsample_argmax", _upsample_argmax_cuda, "CUDA")
_LIB.impl("upsample_argmax", _upsample_argmax_cpu, "CPU")
torch.library.register_fake("vt::upsample_argmax", _upsample_argmax_fake,
                            lib=_LIB)
