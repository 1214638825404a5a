"""Flash-attention forward (inference) on Hopper, and its plain version.

``flash_attention`` launches ``csrc/flash_attention_fwd.cu`` for a CUDA
tensor: softmax(Q·Kᵀ·d^-½)·V over (B, H, N, d), online over key tiles, with
the N×N scores never in device memory. It replaces the TPU package's
``ops/flash_attention.py:_fwd_kernel`` with ``need_lse=False`` and no
dropout; the training variant (lse, dropout) and the backward kernels are
not ported yet. For a CPU tensor it runs ``flash_attention_plain``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from visiontransformer_tpu_torch.ops import _build

HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, fp32 math: fp32 scale 1/√d as
    the TPU kernel's ``_fwd`` uses, output in the input dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


_SIGNATURES = {"vt_flash_attention_fwd": (
    [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
    + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int)}


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """(B, H, N, d) q, k, v -> (B, H, N, d) attention output.

    CUDA: the hand-written kernel, for float32 or bfloat16 and d in
    HEAD_DIMS; the inputs may be strided views whose last dimension is
    contiguous. CPU: the plain version. Anything else raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must share one (B, H, N, "
                         f"d) shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one device")
    b, h, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the last dimension of q, k and v "
                         "must be contiguous")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} exceeds 65535")
    if q.dtype == torch.bfloat16 and not all(
            t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])
            for t in (q, k, v)):
        # The tensor-core path moves rows as 16-byte vectors.
        raise ValueError("flash_attention: bfloat16 rows of q, k and v must "
                         "start on 16-byte boundaries")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention_fwd", _SIGNATURES)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vt_flash_attention_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), *strides, b, h, n, d, 1.0 / math.sqrt(d), stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


# Kernel launches since the last reset (read by chip_smoke.py to prove the
# main path ran through the kernel).
flash_attention.launches = 0
