"""DeepLabV3 and DeepLabV3+ segmentation families, the TPU package's
``models/deeplab.py``. ASPP on the deepest features: a 1x1 branch, three
3x3 atrous branches and an image-pool branch, concatenated and projected
by a 1x1 conv; V3+ adds the decoder that resizes the ASPP output to the
OS-4 skip, concatenates its 48-channel projection and refines with two
3x3 convs. NCHW inside, NHWC at the boundary (``models/unet.py``).

The atrous rates are declared on the paper's 33x33 canvas and rescaled
to the feature map at apply time, as the TPU package does:
``max(int(round(rate * min(h, w) / rate_canvas)), previous + 1)`` with
Python's ``round`` (half to even). The dilated convolutions pad as XLA's
SAME does (``nn/layers.py:conv2d_nchw``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

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


@dataclasses.dataclass(frozen=True)
class DeepLabV3Config(EncoderConfig):
    encoder_name: str = "resnet34"
    in_channels: int = 3
    num_classes: int = 17
    atrous_rates: Tuple[int, ...] = (6, 12, 18)  # on the 33x33 canvas
    rate_canvas: int = 33  # feature size the rates are declared for
    aspp_channels: int = 256
    groups: int = 8  # GroupNorm groups
    compute_dtype: str = "float32"
    normalize: bool = True  # smp-style input normalization in forward


@dataclasses.dataclass(frozen=True)
class DeepLabV3PlusConfig(EncoderConfig):
    encoder_name: str = "resnet34"
    in_channels: int = 3
    num_classes: int = 17
    atrous_rates: Tuple[int, ...] = (6, 12, 18)  # on the 33x33 canvas
    rate_canvas: int = 33  # feature size the rates are declared for
    aspp_channels: int = 256
    low_level_channels: int = 48  # 1x1 projection width for the OS-4 skip
    decoder_channels: int = 256
    groups: int = 8  # GroupNorm groups
    compute_dtype: str = "float32"
    normalize: bool = True  # smp-style input normalization in forward


def _branch_init(generator, cin: int, cout: int, kernel: int) -> dict:
    return {"conv": conv2d_init(generator, cin, cout, kernel),
            "gn": group_norm_init(cout)}


def _branch_apply(branch, x: torch.Tensor, groups: int,
                  dilation: int = 1) -> torch.Tensor:
    y = conv(branch["conv"], x, dilation=dilation)
    return F.relu(group_norm(branch["gn"], y, groups))


def _aspp_init(generator, cin: int, cfg) -> dict:
    c = cfg.aspp_channels
    return {
        "conv1x1": _branch_init(generator, cin, c, 1),
        "atrous": [_branch_init(generator, cin, c, 3)
                   for _ in cfg.atrous_rates],
        "image_pool": _branch_init(generator, cin, c, 1),
        "project": _branch_init(generator, c * (2 + len(cfg.atrous_rates)),
                                c, 1),
    }


def atrous_rates(cfg, height: int, width: int) -> List[int]:
    """The rates of the atrous branches on an (height, width) feature map:
    the canonical rates rescaled to it, each above the one before."""
    scale = min(height, width) / cfg.rate_canvas
    rates, seen = [], 0
    for rate in cfg.atrous_rates:
        r = max(int(round(rate * scale)), seen + 1)
        rates.append(r)
        seen = r
    return rates


def _aspp_apply(aspp, x: torch.Tensor, cfg) -> torch.Tensor:
    branches = [_branch_apply(aspp["conv1x1"], x, cfg.groups)]
    for branch, rate in zip(aspp["atrous"],
                            atrous_rates(cfg, x.shape[2], x.shape[3])):
        branches.append(_branch_apply(branch, x, cfg.groups, dilation=rate))
    # Image-level branch: global average pool -> 1x1 conv -> broadcast.
    pooled = _branch_apply(aspp["image_pool"],
                           x.mean(dim=(2, 3), keepdim=True), cfg.groups)
    branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
    return _branch_apply(aspp["project"], torch.cat(branches, dim=1),
                         cfg.groups)


def deeplabv3_init(generator: torch.Generator,
                   cfg: DeepLabV3Config) -> ConvSegModel:
    params = encoder_init(generator, cfg)
    params["aspp"] = _aspp_init(generator, cfg.stage_channels[-1], cfg)
    params["head"] = conv2d_init(generator, cfg.aspp_channels,
                                 cfg.num_classes, 1)
    return ConvSegModel("deeplabv3", cfg, params, deeplabv3_apply)


def deeplabv3_apply(params: ConvSegModel, images: torch.Tensor, *,
                    deterministic: bool = True,
                    generator: Optional[torch.Generator] = None,
                    attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, num_classes) fp32 logits at input
    resolution."""
    del deterministic, generator, attn_impl  # no dropout, no attention
    cfg = params.cfg
    x = apply_prologue(params, images, cfg)
    x, _ = encoder_apply(params, x, cfg.groups)  # deepest features only
    return apply_epilogue(params, _aspp_apply(params["aspp"], x, cfg),
                          images)


def deeplabv3plus_init(generator: torch.Generator,
                       cfg: DeepLabV3PlusConfig) -> ConvSegModel:
    params = encoder_init(generator, cfg)
    params["aspp"] = _aspp_init(generator, cfg.stage_channels[-1], cfg)
    # Low-level skip: encoder_apply's skips[2], the OS-4 feature map.
    params["low_proj"] = _branch_init(
        generator, cfg.stage_channels[2], cfg.low_level_channels, 1)
    c = cfg.decoder_channels
    params["decoder"] = [
        _branch_init(generator, cfg.aspp_channels + cfg.low_level_channels,
                     c, 3),
        _branch_init(generator, c, c, 3),
    ]
    params["head"] = conv2d_init(generator, c, cfg.num_classes, 1)
    return ConvSegModel("deeplabv3plus", cfg, params, deeplabv3plus_apply)


def deeplabv3plus_apply(params: ConvSegModel, images: torch.Tensor, *,
                        deterministic: bool = True,
                        generator: Optional[torch.Generator] = None,
                        attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, num_classes) fp32 logits at input
    resolution."""
    del deterministic, generator, attn_impl  # no dropout, no attention
    cfg = params.cfg
    x = apply_prologue(params, images, cfg)
    x, skips = encoder_apply(params, x, cfg.groups)
    x = _aspp_apply(params["aspp"], x, cfg)
    # Decoder: resize the ASPP output to the OS-4 skip, fuse with the
    # projected low-level features, refine with two 3x3 convs.
    low = _branch_apply(params["low_proj"], skips[2], cfg.groups)
    x = resize(x, low.shape[2:])
    x = torch.cat([x, low.to(x.dtype)], dim=1)
    for block in params["decoder"]:
        x = _branch_apply(block, x, cfg.groups)
    return apply_epilogue(params, x, images)
