"""PSPNet segmentation family (pyramid-pooling decoder), the TPU package's
``models/pspnet.py``: the deepest features adaptive-average-pooled to
1^2, 2^2, 3^2 and 6^2 grids, each 1x1-projected, resized back and
concatenated with the features, fused by a 3x3 conv, then the 1x1 head
and a bilinear upsample to the input size. NCHW inside, NHWC at the
boundary (``models/unet.py``).

``adaptive_avg_pool`` keeps the TPU package's matrix form: two products
with (bins, size) averaging matrices cast to the activation dtype, so at
bf16 the weights 1/3, 1/6 ... round as they do there
(``F.adaptive_avg_pool2d`` has the same bins, not the same rounding).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from visiontransformer_tpu_torch.models.unet import (
    ConvSegModel,
    EncoderConfig,
    apply_epilogue,
    apply_prologue,
    conv,
    encoder_apply,
    encoder_init,
    group_norm,
    group_norm_init,
    resize,
)
from visiontransformer_tpu_torch.nn.layers import conv2d_init
from visiontransformer_tpu_torch.ops.resize import cached_table


@dataclasses.dataclass(frozen=True)
class PSPNetConfig(EncoderConfig):
    encoder_name: str = "resnet34"
    in_channels: int = 3
    num_classes: int = 17
    pool_sizes: Tuple[int, ...] = (1, 2, 3, 6)
    psp_out_channels: int = 512
    groups: int = 8  # GroupNorm groups
    compute_dtype: str = "float32"
    normalize: bool = True  # smp-style input normalization in forward


def _adaptive_pool_matrix(size_in: int, bins: int) -> np.ndarray:
    """(bins, size_in) row-stochastic averaging matrix with torch
    AdaptiveAvgPool2d bin boundaries: bin i covers [floor(i S / B),
    ceil((i + 1) S / B))."""
    m = np.zeros((bins, size_in), np.float32)
    for i in range(bins):
        lo = math.floor(i * size_in / bins)
        hi = max(math.ceil((i + 1) * size_in / bins), lo + 1)
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


@functools.lru_cache(maxsize=64)
@torch.inference_mode(False)
def _pool_matrix_on(size_in: int, bins: int, device: str,
                    dtype: torch.dtype) -> torch.Tensor:
    # Cached per device: a fresh copy from host memory would wait for the
    # card at every call. Made outside inference mode, so that a training
    # step can save it for its backward (ops/resize.py).
    return torch.from_numpy(_adaptive_pool_matrix(size_in, bins)).to(
        device, dtype)


def adaptive_avg_pool(x: torch.Tensor, bins: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, bins, bins): the H stage, then the W stage,
    each a product with the averaging matrix cast to x's dtype."""
    mh = cached_table(_pool_matrix_on, x.shape[2], bins, str(x.device),
                      x.dtype)
    mw = cached_table(_pool_matrix_on, x.shape[3], bins, str(x.device),
                      x.dtype)
    x = torch.einsum("ph,bchw->bcpw", mh, x)
    return torch.einsum("qw,bcpw->bcpq", mw, x)


def pspnet_init(generator: torch.Generator,
                cfg: PSPNetConfig) -> ConvSegModel:
    params = encoder_init(generator, cfg)
    cin = cfg.stage_channels[-1]
    branch_c = max(cin // len(cfg.pool_sizes), 8)
    params["psp"] = [{"conv": conv2d_init(generator, cin, branch_c, 1),
                      "gn": group_norm_init(branch_c)}
                     for _ in cfg.pool_sizes]
    fused_in = cin + branch_c * len(cfg.pool_sizes)
    params["fuse"] = conv2d_init(generator, fused_in, cfg.psp_out_channels, 3)
    params["fuse_gn"] = group_norm_init(cfg.psp_out_channels)
    params["head"] = conv2d_init(generator, cfg.psp_out_channels,
                                 cfg.num_classes, 1)
    return ConvSegModel("pspnet", cfg, params, pspnet_apply)


def pspnet_apply(params: ConvSegModel, images: torch.Tensor, *,
                 deterministic: bool = True,
                 generator: Optional[torch.Generator] = None,
                 attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, num_classes) fp32 logits at input
    resolution."""
    del deterministic, generator, attn_impl  # no dropout, no attention
    cfg = params.cfg
    x = apply_prologue(params, images, cfg)
    x, _ = encoder_apply(params, x, cfg.groups)  # deepest features only
    pyramid = [x]
    for branch, bins in zip(params["psp"], cfg.pool_sizes):
        y = adaptive_avg_pool(x, bins)
        y = F.relu(group_norm(branch["gn"], conv(branch["conv"], y),
                              cfg.groups))
        pyramid.append(resize(y, x.shape[2:]))
    x = torch.cat(pyramid, dim=1)
    x = F.relu(group_norm(params["fuse_gn"], conv(params["fuse"], x),
                          cfg.groups))
    return apply_epilogue(params, x, images)
