"""Layers of the ViT segmentation model, as functions and modules.

The functions mirror the TPU package's ``nn/layers.py`` arithmetic: a
linear kernel is stored (in, out) in fp32 and cast to the activation dtype
at use, with the bias added after the product in that dtype (a W8A8 layer,
``LinearW8A8``, holds an int8 kernel and runs ``_linear_w8a8``'s int8
product instead, for inference only); LayerNorm runs
in fp32 and casts back; convolutions take NHWC activations and HWIO
kernels (``conv2d``, ``depthwise``); dropout draws its mask from an
explicit generator. The modules hold parameters under the TPU package's
names (``kernel``, ``bias``, ``scale``), so its parameter tree maps onto
their state dict key for key (``ckpt/convert.py``).

The conv families (``models/unet.py``) run NCHW with OIHW kernels:
``conv2d_nchw`` pads as XLA's SAME does, ``conv2d_init`` and
``depthwise_init`` draw their parameters, and ``ParamTree`` holds a
family's parameter tree under the TPU package's names.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def linear(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x @ kernel + bias in the activation dtype (or ``dtype``)."""
    if dtype is not None:
        x = x.to(dtype)
    y = torch.matmul(x, kernel.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, as a plain int32
    product (exact: |sum| <= 127^2 K)."""
    return torch.matmul(a.to(torch.int32), b.to(torch.int32))


# torch._int_mm on CUDA takes more than 16 rows.
_INT_MM_MIN_ROWS = 16


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32. On CUDA: cuBLASLt's int8
    product (``torch._int_mm``), whose preconditions are checked here: K and
    N multiples of 8 (raises otherwise), more than 16 rows (fewer are padded
    with zero rows, whose products are dropped). On the CPU: the plain int32
    product."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 \
            or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul takes (M, K) and (K, N) int8, got "
                         f"{tuple(a.shape)} {a.dtype}, {tuple(b.shape)} "
                         f"{b.dtype}")
    if not a.is_cuda:
        return int8_matmul_plain(a, b)
    m, k = a.shape
    if k % 8 or b.shape[1] % 8:
        raise ValueError(f"the int8 product on CUDA needs K and N multiples "
                         f"of 8, got K={k}, N={b.shape[1]}")
    if m > _INT_MM_MIN_ROWS:
        return torch._int_mm(a.contiguous(), b)
    padded = a.new_zeros((_INT_MM_MIN_ROWS + 1, k))
    padded[:m] = a
    return torch._int_mm(padded, b)[:m]


def quantize_per_token(x: torch.Tensor):
    """(int8 x, fp32 per-token scales): s_x = max|x| / 127 over the last
    axis in fp32 (at least 1e-12), x / s_x rounded half to even and
    clipped to +-127."""
    x32 = x.float()
    s_x = torch.clamp(x32.abs().amax(dim=-1, keepdim=True) / 127.0,
                      min=1e-12)
    return torch.clamp(torch.round(x32 / s_x), -127, 127).to(torch.int8), s_x


def _linear_w8a8(x: torch.Tensor, kernel_q: torch.Tensor,
                 kernel_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The TPU package's W8A8 linear step for step: per-token int8
    activations (``quantize_per_token``), the int8 x int8 -> int32
    product, then acc * s_x * s_w + bias in fp32, cast to the activation
    dtype (or ``dtype``)."""
    if dtype is not None:
        x = x.to(dtype)
    xq, s_x = quantize_per_token(x)
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), kernel_q)
    y = acc.reshape(*x.shape[:-1], -1).float() * s_x * kernel_scale
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last axis in fp32, cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as HF ViT uses."""
    return F.gelu(x, approximate="none")


def dropout(x: torch.Tensor, rate: float, *,
            generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout (torch nn.Dropout semantics): keep each element
    with probability 1 - rate and scale it by 1 / (1 - rate), the keep
    draws coming from ``generator`` (on x's device)."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator "
                         "(or deterministic=True)")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def _same_padding(size: int, k: int, stride: int, dilation: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, *,
           stride: int = 1, dilation: int = 1,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """NHWC convolution with an HWIO kernel and SAME padding; bias added
    after the convolution in the activation dtype."""
    if dtype is not None:
        x = x.to(dtype)
    kh, kw = kernel.shape[0], kernel.shape[1]
    top, bottom = _same_padding(x.shape[1], kh, stride, dilation)
    left, right = _same_padding(x.shape[2], kw, stride, dilation)
    xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(xc, kernel.to(x.dtype).permute(3, 2, 0, 1), stride=stride,
                 dilation=dilation)
    return y.permute(0, 2, 3, 1) + bias.to(y.dtype)


def conv2d_nchw(x: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *, stride: int = 1,
                dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """NCHW convolution with an OIHW kernel and XLA's SAME padding: the
    padding of ``_same_padding``, which is asymmetric where the total is odd
    (k = 3, stride 2 on an even size pads (0, 1)), so it is applied by
    ``F.pad`` then, and by the convolution itself where it is symmetric.
    The bias is added inside the convolution, in the activation dtype."""
    kh, kw = kernel.shape[2], kernel.shape[3]
    top, bottom = _same_padding(x.shape[2], kh, stride, dilation)
    left, right = _same_padding(x.shape[3], kw, stride, dilation)
    padding = (top, left)
    if (top, left) != (bottom, right):
        x = F.pad(x, (left, right, top, bottom))
        padding = (0, 0)
    return F.conv2d(x, kernel.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


def depthwise(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, *,
              stride: int = 1) -> torch.Tensor:
    """Per-channel convolution of NHWC activations with an HWIO kernel of
    I = 1 (feature_group_count = C, the TPU package's ``depthwise``) and
    SAME padding; bias added after the convolution in the activation
    dtype."""
    y = conv2d_nchw(x.permute(0, 3, 1, 2), kernel.to(x.dtype).permute(
        3, 2, 0, 1), stride=stride, groups=x.shape[-1])
    return y.permute(0, 2, 3, 1) + bias.to(y.dtype)


def trunc_normal(shape, generator: torch.Generator,
                 std: float = 0.02) -> torch.Tensor:
    """N(0, std) truncated to +-2 std (the TPU package's ``trunc_normal``:
    the same distribution, not the same bits)."""
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                generator=generator)
    return t


def conv2d_init(generator: torch.Generator, in_channels: int,
                out_channels: int, kernel_size: int, std: float = 0.02):
    """A conv layer's parameters as the TPU package's ``conv2d_init`` draws
    them (trunc-normal kernel, zero bias), the kernel stored OIHW."""
    shape = (out_channels, in_channels, kernel_size, kernel_size)
    return {"kernel": trunc_normal(shape, generator, std),
            "bias": torch.zeros(out_channels)}


def depthwise_init(generator: torch.Generator, channels: int,
                   kernel_size: int = 3, std: float = 0.02):
    """A depthwise layer's parameters, the kernel stored OIHW as (C, 1, k,
    k)."""
    shape = (channels, 1, kernel_size, kernel_size)
    return {"kernel": trunc_normal(shape, generator, std),
            "bias": torch.zeros(channels)}


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None):
        return linear(x, self.kernel, self.bias, dtype=dtype)


class LinearW8A8(nn.Module):
    """A linear layer in W8A8 form (``ops/quant.py``): ``kernel_q`` (in,
    out) int8, ``kernel_scale`` (out,) fp32 and ``bias`` fp32 are buffers,
    not parameters, since rounding has no gradient. ``kernel_q`` is held
    column-major (the transpose of a contiguous (out, in) tensor): cuBLASLt's
    int8 product on the H100 takes 4.3-6.5x less time with its second
    operand so laid out than row-major at the encoder's shapes (PERF.md)."""

    def __init__(self, kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("kernel_q", kernel_q.t().contiguous().t())
        self.register_buffer("kernel_scale", kernel_scale)
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None):
        return _linear_w8a8(x, self.kernel_q, self.kernel_scale, self.bias,
                            dtype=dtype)


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, eps=self.eps)


class Conv2d(nn.Module):
    """Kernel stored HWIO, as in the TPU package."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(kernel_size, kernel_size, in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.kernel, self.bias)


class ParamTree(nn.Module):
    """A nested dict of parameters as a module, the form of the TPU
    package's conv-family parameter trees: a dict node is a ParamTree, a
    list an ``nn.ModuleList``, a tensor an ``nn.Parameter``, each under its
    key, so the leaf at path ``stages / 0 / 1 / conv1 / kernel`` is the
    state-dict entry ``stages.0.1.conv1.kernel``. ``tree["key"]`` and
    ``"key" in tree`` read it as the dict it was built from."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            setattr(self, key, _tree_module(value))

    def __getitem__(self, key: str):
        if key not in self:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return (key in self._modules or key in self._parameters
                or key in self._buffers)


def _tree_module(value):
    if isinstance(value, dict):
        return ParamTree(value)
    if isinstance(value, (list, tuple)):
        return nn.ModuleList([_tree_module(v) for v in value])
    return nn.Parameter(value)
