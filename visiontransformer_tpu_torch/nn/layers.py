"""Layers of the ViT segmentation model, as functions and modules.

The functions mirror the TPU package's ``nn/layers.py`` arithmetic: a
linear kernel is stored (in, out) in fp32 and cast to the activation dtype
at use, with the bias added after the product in that dtype (on a CUDA
device without a gradient, in the GEMM's epilogue before its one rounding:
``linear``; a W8A8 layer, ``LinearW8A8``, holds an int8 kernel and runs
``_linear_w8a8``'s int8 product instead, for inference only); LayerNorm runs
in fp32 and casts back; convolutions take NHWC activations and HWIO
kernels (``conv2d``, ``depthwise``); dropout draws its mask from an
explicit generator. The modules hold parameters under the TPU package's
names (``kernel``, ``bias``, ``scale``), so its parameter tree maps onto
their state dict key for key (``ckpt/convert.py``).

The conv families (``models/unet.py``) run NCHW with OIHW kernels:
``conv2d_nchw`` pads as XLA's SAME does (or symmetrically, as MiT's patch
embeddings ask), ``conv2d_w8a8`` is its W8A8 form, ``conv2d_init`` and
``depthwise_init`` draw their parameters, and ``ParamTree`` holds a
family's parameter tree under the TPU package's names.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from visiontransformer_tpu_torch.ops import layer_norm as _ln
from visiontransformer_tpu_torch.utils import spans

EPILOGUE_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
# The largest GEMM dimension PyTorch hands to cuBLASLt (``addmm``'s rule for
# its bias epilogue); each dimension must also exceed 1 there.
EPILOGUE_MAX_DIM = 65535 * 32


def _folds(x: torch.Tensor) -> bool:
    """Whether x's leading axes merge into one axis of rows without a
    copy, as ``view(-1, in)`` merges them."""
    stride = None
    for size, step in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if size == 1:
            continue
        if stride is not None and step != stride:
            return False
        stride = step * size
    return True


def epilogue_takes(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> bool:
    """Whether ``linear`` on x (in its compute dtype) runs as one GEMM with
    the bias in cuBLASLt's epilogue: a CUDA tensor, no gradient being
    taken, bf16, fp16 or fp32, a 2-D (in, out) kernel and an (out,) bias,
    x's leading axes foldable into rows without a copy, and each of rows,
    in and out above 1 and at most ``EPILOGUE_MAX_DIM``."""
    if not (x.is_cuda and not torch.is_grad_enabled()
            and x.dtype in EPILOGUE_DTYPES and bias is not None
            and kernel.dim() == 2 and bias.dim() == 1 and x.dim() >= 1):
        return False
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    return (tuple(bias.shape) == (kernel.shape[1],)
            and x.shape[-1] == kernel.shape[0]
            and all(1 < n <= EPILOGUE_MAX_DIM
                    for n in (rows, kernel.shape[0], kernel.shape[1]))
            and _folds(x))


def linear(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x @ kernel + bias in the activation dtype (or ``dtype``). Where
    ``epilogue_takes`` the call, one GEMM (``addmm`` over x's rows, which
    reaches cuBLASLt's bias epilogue) adds the bias to the fp32 accumulator
    before the one rounding to that dtype, and counts ``linear_epilogue``;
    every other call runs ``linear_plain``, and counts ``linear_plain`` if
    it has a bias and runs on a CUDA device. The activation after a linear
    stays a pass of its own: cuBLASLt's GELU epilogue is the tanh
    approximation, not the exact GELU the models take."""
    if dtype is not None:
        x = x.to(dtype)
    if epilogue_takes(x, kernel, bias):
        spans.count("linear_epilogue")
        dt = x.dtype
        y = torch.addmm(bias.to(dt), x.reshape(-1, x.shape[-1]),
                        kernel.to(dt))
        return y.view(*x.shape[:-1], y.shape[-1])
    if bias is not None and x.is_cuda:
        spans.count("linear_plain")
    return linear_plain(x, kernel, bias)


def linear_plain(x: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ kernel in x's dtype, then + bias in that dtype: two
    roundings, two kernels on a card."""
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


def div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division on every device. PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal instead, which moves
    the quotient by up to one ulp from the CPU's (and the TPU package's
    op-by-op) division, and with it the int8 rounding of every value near
    a rounding boundary; a divisor on t's device is divided by."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def quantize_per_token(x: torch.Tensor):
    """(int8 x, fp32 per-token scales): s_x = max|x| / 127 over the last
    axis in fp32 (at least 1e-12), x / s_x rounded half to even and
    clipped to +-127."""
    x32 = x.float()
    s_x = torch.clamp(div127(x32.abs().amax(dim=-1, keepdim=True)),
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
    """LayerNorm over the last axis in fp32, cast back to x's dtype: kernel
    10 on a CUDA device without a gradient, else the plain code
    (``ops/layer_norm.py``)."""
    return _ln.layer_norm(x, scale, bias, eps=eps)


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


def _conv_padding(x: torch.Tensor, kh: int, kw: int, stride: int,
                  dilation: int, padding: Optional[Tuple[int, int]]):
    """(x, padding for the convolution): ``padding`` (rows, columns) pads
    both sides alike; None is XLA's SAME, ``_same_padding``, asymmetric where
    the total is odd (k = 3, stride 2 on an even size pads (0, 1)), so
    applied by ``F.pad`` then and by the convolution where symmetric."""
    if padding is not None:
        return x, tuple(padding)
    top, bottom = _same_padding(x.shape[2], kh, stride, dilation)
    left, right = _same_padding(x.shape[3], kw, stride, dilation)
    if (top, left) != (bottom, right):
        return F.pad(x, (left, right, top, bottom)), (0, 0)
    return x, (top, left)


def conv2d_nchw(x: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *, stride: int = 1,
                dilation: int = 1, groups: int = 1,
                padding: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """NCHW convolution with an OIHW kernel, XLA's SAME padding unless
    ``padding`` (rows, columns) asks for symmetric explicit padding (MiT's
    patch embeddings pad k // 2 on each side, which SAME does not: k = 7 at
    stride 4 on 224 pads (1, 2)). The bias is added inside the
    convolution, in the activation dtype."""
    x, padding = _conv_padding(x, kernel.shape[2], kernel.shape[3], stride,
                               dilation, padding)
    return F.conv2d(x, kernel.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


def quantize_per_sample(x: torch.Tensor):
    """(int8 x, fp32 scales of shape (B, 1, 1, 1)) for NCHW activations:
    one scale a sample, s_x = max|x| / 127 over (C, H, W) in fp32 (at least
    1e-12), x / s_x rounded half to even and clipped to +-127. A conv's
    output pixel reduces over H, W and C, so one sample is the finest
    dynamic granularity its dequantization allows."""
    x32 = x.float()
    s_x = torch.clamp(div127(x32.abs().amax(dim=(1, 2, 3), keepdim=True)),
                      min=1e-12)
    return torch.clamp(torch.round(x32 / s_x), -127, 127).to(torch.int8), s_x


def int8_conv_plain(xq: torch.Tensor, kernel_q: torch.Tensor, *,
                    stride: int = 1, dilation: int = 1,
                    padding: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """(B, C, H, W) int8 conv (O, C, kh, kw) int8 -> int32, in float64,
    which holds every partial sum exactly (|sum| <= 127^2 C kh kw < 2^53)."""
    x, pad = _conv_padding(xq.double(), kernel_q.shape[2], kernel_q.shape[3],
                           stride, dilation, padding)
    return F.conv2d(x, kernel_q.double(), stride=stride, padding=pad,
                    dilation=dilation).to(torch.int32)


def _round_up8(n: int) -> int:
    return -(-n // 8) * 8


def int8_conv(xq: torch.Tensor, kernel_q: torch.Tensor, *, stride: int = 1,
              dilation: int = 1, padding: Optional[Tuple[int, int]] = None
              ) -> torch.Tensor:
    """(B, C, H, W) int8 conv (O, C, kh, kw) int8 -> (B, O, Ho, Wo) int32.
    On CUDA: ``int8_conv_gemm`` with cuBLASLt's int8 product
    (``int8_matmul``). On the CPU: ``int8_conv_plain``."""
    if xq.dtype != torch.int8 or kernel_q.dtype != torch.int8 \
            or xq.dim() != 4 or kernel_q.dim() != 4 \
            or xq.shape[1] != kernel_q.shape[1]:
        raise ValueError(f"int8_conv takes (B, C, H, W) and (O, C, kh, kw) "
                         f"int8, got {tuple(xq.shape)} {xq.dtype}, "
                         f"{tuple(kernel_q.shape)} {kernel_q.dtype}")
    if not xq.is_cuda:
        return int8_conv_plain(xq, kernel_q, stride=stride,
                               dilation=dilation, padding=padding)
    return int8_conv_gemm(xq, kernel_q, int8_matmul, stride=stride,
                          dilation=dilation, padding=padding)


def int8_conv_gemm(xq: torch.Tensor, kernel_q: torch.Tensor, matmul, *,
                   stride: int = 1, dilation: int = 1,
                   padding: Optional[Tuple[int, int]] = None
                   ) -> torch.Tensor:
    """The int8 convolution as one (M, K) x (K, N) int8 -> int32 product,
    ``matmul``: the padded input unfolded into (B·Ho·Wo, C·kh·kw) rows (a
    reshape for a 1x1 conv at stride 1; else ``F.unfold`` of a bf16 copy,
    exact for |v| <= 127, cast back to int8) against the kernel as (C·kh·kw,
    O), column-major as a view of the OIHW kernel. K and O short of a
    multiple of 8 (``torch._int_mm``'s rule) get zero columns, whose
    products add nothing."""
    o, c, kh, kw = kernel_q.shape
    x, pad = _conv_padding(xq, kh, kw, stride, dilation, padding)
    b = x.shape[0]
    ho = (x.shape[2] + 2 * pad[0] - dilation * (kh - 1) - 1) // stride + 1
    wo = (x.shape[3] + 2 * pad[1] - dilation * (kw - 1) - 1) // stride + 1
    if (kh, kw, stride) == (1, 1, 1) and pad == (0, 0):
        rows = x.permute(0, 2, 3, 1).reshape(b * ho * wo, c)
    else:
        cols = F.unfold(x.to(torch.bfloat16), (kh, kw), dilation=dilation,
                        padding=pad, stride=stride)  # (B, C·kh·kw, L)
        rows = cols.transpose(1, 2).reshape(b * ho * wo, c * kh * kw).to(
            torch.int8)
    w = kernel_q.reshape(o, c * kh * kw).t()
    k, n = _round_up8(w.shape[0]), _round_up8(o)
    if (k, n) != tuple(w.shape):
        rows = F.pad(rows, (0, k - w.shape[0]))
        w = F.pad(w.t(), (0, k - w.shape[0], 0, n - o)).t()
    acc = matmul(rows.contiguous(), w)[:, :o]
    return acc.reshape(b, ho, wo, o).permute(0, 3, 1, 2)


def conv2d_w8a8(x: torch.Tensor, kernel_q: torch.Tensor,
                kernel_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *, stride: int = 1,
                dilation: int = 1,
                padding: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The TPU package's W8A8 convolution (``_conv2d_w8a8``) on NCHW
    activations and an OIHW int8 kernel: per-sample int8 activations
    (``quantize_per_sample``), the exact int32 convolution (``int8_conv``),
    then acc * s_x * kernel_scale + bias in fp32, cast to x's dtype."""
    xq, s_x = quantize_per_sample(x)
    acc = int8_conv(xq, kernel_q, stride=stride, dilation=dilation,
                    padding=padding)
    y = acc.float() * s_x * kernel_scale.reshape(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    return y.to(x.dtype)


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
