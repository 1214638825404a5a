"""Layers of the ViT segmentation model, as functions and modules.

The functions mirror the TPU package's ``nn/layers.py`` arithmetic: a
linear kernel is stored (in, out) in fp32 and cast to the activation dtype
at use, with the bias added after the product in that dtype; LayerNorm runs
in fp32 and casts back; convolutions take NHWC activations and HWIO
kernels. The modules hold parameters under the TPU package's names
(``kernel``, ``bias``, ``scale``), so its parameter tree maps onto their
state dict key for key (``ckpt/convert.py``).
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


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None):
        return linear(x, self.kernel, self.bias, dtype=dtype)


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
