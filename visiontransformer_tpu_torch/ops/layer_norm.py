"""Row-wise LayerNorm on Hopper, alone or after a bias and a residual add,
and its plain versions.

``layer_norm`` and ``add_layer_norm`` launch ``csrc/layer_norm.cu``
(kernel 10 of PERF.md's table; no TPU kernel, since XLA fuses the TPU
package's LayerNorm) through the custom ops ``vt::layer_norm`` and
``vt::add_layer_norm`` where the kernel takes the call
(``kernel_takes``): a CUDA tensor, no gradient being taken, bf16 or fp32,
C a multiple of 8 and at most ``MAX_COLS``. Every other call, the CPU's,
training's and the backward's among them, runs the plain versions, which
autograd sees through; on a CUDA device such a call counts
``layer_norm_plain``, a launch counts ``layer_norm`` (``utils/spans.py``).

- ``layer_norm(x, scale, shift, eps=)``: LayerNorm over the last axis in
  fp32, cast back to x's dtype (``layer_norm_plain``).
- ``add_layer_norm(x, t, b, scale, shift, eps=)``: (s, LN(s)) with
  s = x + (t + b), t a linear layer's product without its bias b (b None:
  s = x + t): the residual stream after the layer and the LayerNorm that
  follows it (``add_layer_norm_plain``). t + b is rounded to the
  activation dtype, then added to x, as the plain code rounds them, so s
  is the plain residual stream bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from visiontransformer_tpu_torch.ops import _build
from visiontransformer_tpu_torch.utils import spans

_SIGNATURES = {
    "vt_layer_norm": (
        [ctypes.c_int] + [ctypes.c_void_p] * 7
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int)}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The widest row the kernel takes: 32 lanes of 8 16-byte vectors
# (``csrc/layer_norm.cu``: kMaxVpl).
MAX_COLS = {torch.float32: 1024, torch.bfloat16: 2048}


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in fp32, cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + shift).to(x.dtype)


def add_layer_norm_plain(x: torch.Tensor, t: torch.Tensor,
                         b: Optional[torch.Tensor], scale: torch.Tensor,
                         shift: torch.Tensor, eps: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, layer_norm_plain(s)), s = x + (t + b in t's dtype)."""
    s = x + (t if b is None else t + b.to(t.dtype))
    return s, layer_norm_plain(s, scale, shift, eps)


def kernel_takes(x: torch.Tensor) -> bool:
    """Whether a call on x launches the kernel (module docstring)."""
    return (x.is_cuda and not torch.is_grad_enabled() and x.dtype in DTYPES
            and x.shape[-1] % 8 == 0 and x.shape[-1] <= MAX_COLS[x.dtype]
            and x.numel() > 0)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in fp32, cast back to x's dtype: the
    kernel where it takes the call, else ``layer_norm_plain``."""
    if kernel_takes(x):
        return torch.ops.vt.layer_norm(x, scale, shift, eps)
    if x.is_cuda:
        spans.count("layer_norm_plain")
    return layer_norm_plain(x, scale, shift, eps)


def add_layer_norm(x: torch.Tensor, t: torch.Tensor,
                   b: Optional[torch.Tensor], scale: torch.Tensor,
                   shift: torch.Tensor, *, eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, LN(s)), s = x + (t + b): one launch where the kernel takes the
    call, else ``add_layer_norm_plain``."""
    if kernel_takes(x) and t.dtype == x.dtype and t.shape == x.shape:
        return torch.ops.vt.add_layer_norm(x, t, b, scale, shift, eps)
    if x.is_cuda:
        spans.count("layer_norm_plain")
    return add_layer_norm_plain(x, t, b, scale, shift, eps)


# ------------------------------------------- vt::layer_norm, add_layer_norm
# Kernel 10 as PyTorch operators, as ``ops/upsample_argmax.py`` registers
# kernel 5: the CUDA implementations launch it, the CPU ones are the plain
# versions, the fake ones give the outputs' shapes and types.
_LIB = torch.library.Library("vt", "FRAGMENT")
_LIB.define("layer_norm(Tensor x, Tensor scale, Tensor shift, float eps) "
            "-> Tensor")
_LIB.define("add_layer_norm(Tensor x, Tensor t, Tensor? b, Tensor scale, "
            "Tensor shift, float eps) -> (Tensor, Tensor)")


def _check(x: torch.Tensor, t: Optional[torch.Tensor],
           b: Optional[torch.Tensor], scale: torch.Tensor,
           shift: torch.Tensor) -> None:
    """Raise unless the call is one the kernel takes: every implementation
    runs it, so a direct call of an op, or an exported program, holds to
    the wrappers' contract."""
    if x.dtype not in DTYPES:
        raise TypeError(f"layer_norm: expects float32 or bfloat16, got "
                        f"{x.dtype}")
    c = x.shape[-1] if x.dim() else 0
    if c % 8 or not 0 < c <= MAX_COLS[x.dtype]:
        raise ValueError(f"layer_norm: the last axis must be a multiple of 8 "
                         f"up to {MAX_COLS[x.dtype]}, got {tuple(x.shape)}")
    if t is not None and (t.shape != x.shape or t.dtype != x.dtype):
        raise ValueError(f"add_layer_norm: t must match x, got "
                         f"{tuple(t.shape)} {t.dtype} and {tuple(x.shape)} "
                         f"{x.dtype}")
    for name, p in (("b", b), ("scale", scale), ("shift", shift)):
        if p is not None and tuple(p.shape) != (c,):
            raise ValueError(f"layer_norm: {name} must be ({c},), got "
                             f"{tuple(p.shape)}")


def _ready(a: torch.Tensor) -> torch.Tensor:
    """a as contiguous rows at a 16-byte aligned address."""
    if a.is_contiguous() and a.data_ptr() % 16 == 0:
        return a
    return a.clone(memory_format=torch.contiguous_format)


def _launch(x: torch.Tensor, t: Optional[torch.Tensor],
            b: Optional[torch.Tensor], scale: torch.Tensor,
            shift: torch.Tensor, eps: float):
    x = _ready(x)
    t = None if t is None else _ready(t)
    b = None if b is None or t is None else _ready(b.float())
    scale, shift = _ready(scale.float()), _ready(shift.float())
    y = torch.empty_like(x)
    s = None if t is None else torch.empty_like(x)
    lib = _build.load("layer_norm", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vt_layer_norm(
            DTYPES[x.dtype], x.data_ptr(),
            None if t is None else t.data_ptr(),
            None if b is None else b.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), None if s is None else s.data_ptr(),
            y.data_ptr(), x.numel() // x.shape[-1], x.shape[-1], eps, stream)
    _build.check(lib, err, "layer_norm")
    spans.count("layer_norm")
    return s, y


def _layer_norm_cuda(x, scale, shift, eps):
    _check(x, None, None, scale, shift)
    return _launch(x, None, None, scale, shift, eps)[1]


def _layer_norm_cpu(x, scale, shift, eps):
    _check(x, None, None, scale, shift)
    return layer_norm_plain(x, scale, shift, eps)


def _layer_norm_fake(x, scale, shift, eps):
    _check(x, None, None, scale, shift)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _add_layer_norm_cuda(x, t, b, scale, shift, eps):
    _check(x, t, b, scale, shift)
    return _launch(x, t, b, scale, shift, eps)


def _add_layer_norm_cpu(x, t, b, scale, shift, eps):
    _check(x, t, b, scale, shift)
    return add_layer_norm_plain(x, t, b, scale, shift, eps)


def _add_layer_norm_fake(x, t, b, scale, shift, eps):
    _check(x, t, b, scale, shift)
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            torch.empty_like(x, memory_format=torch.contiguous_format))


_LIB.impl("layer_norm", _layer_norm_cuda, "CUDA")
_LIB.impl("layer_norm", _layer_norm_cpu, "CPU")
torch.library.register_fake("vt::layer_norm", _layer_norm_fake, lib=_LIB)
_LIB.impl("add_layer_norm", _add_layer_norm_cuda, "CUDA")
_LIB.impl("add_layer_norm", _add_layer_norm_cpu, "CPU")
torch.library.register_fake("vt::add_layer_norm", _add_layer_norm_fake,
                            lib=_LIB)
