"""UPerNet segmentation family (Unified Perceptual Parsing decoder), the
TPU package's ``models/upernet.py``: a pyramid pooling module on the
deepest stage (``pspnet.adaptive_avg_pool`` in its matrix form), an FPN
top-down pathway over the OS-8, OS-4 and OS-2 stages (1x1 laterals,
resize-add, 3x3 smoothing), and the whole pyramid resized to the finest
level, concatenated and fused by a 3x3 conv before the head. NCHW inside,
NHWC at the boundary (``models/unet.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from visiontransformer_tpu_torch.models.pspnet import adaptive_avg_pool
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
class UPerNetConfig(EncoderConfig):
    encoder_name: str = "resnet34"
    in_channels: int = 3
    num_classes: int = 17
    pool_bins: Tuple[int, ...] = (1, 2, 3, 6)  # PPM grid sizes
    pyramid_channels: int = 256
    groups: int = 8  # GroupNorm groups
    compute_dtype: str = "float32"
    normalize: bool = True  # smp-style input normalization in forward


def _cgn_init(generator, cin: int, cout: int, kernel: int) -> dict:
    return {"conv": conv2d_init(generator, cin, cout, kernel),
            "gn": group_norm_init(cout)}


def _cgn(params, x: torch.Tensor, groups: int) -> torch.Tensor:
    return F.relu(group_norm(params["gn"], conv(params["conv"], x), groups))


def upernet_init(generator: torch.Generator,
                 cfg: UPerNetConfig) -> ConvSegModel:
    params = encoder_init(generator, cfg)
    channels = list(cfg.stage_channels)
    c = cfg.pyramid_channels
    params["ppm"] = {
        "branches": [_cgn_init(generator, channels[-1], c, 1)
                     for _ in cfg.pool_bins],
        "project": _cgn_init(generator,
                             channels[-1] + c * len(cfg.pool_bins), c, 3),
    }
    params["lateral"] = [_cgn_init(generator, channels[i], c, 1)
                         for i in (1, 2, 3)]
    params["smooth"] = [_cgn_init(generator, c, c, 3) for _ in range(3)]
    params["fuse"] = _cgn_init(generator, c * 4, c, 3)
    params["head"] = conv2d_init(generator, c, cfg.num_classes, 1)
    return ConvSegModel("upernet", cfg, params, upernet_apply)


def upernet_apply(params: ConvSegModel, images: torch.Tensor, *,
                  deterministic: bool = True,
                  generator: Optional[torch.Generator] = None,
                  attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, num_classes) fp32 logits at input
    resolution."""
    del deterministic, generator, attn_impl  # no dropout, no attention
    cfg = params.cfg
    x = apply_prologue(params, images, cfg)
    deepest, skips = encoder_apply(params, x, cfg.groups)

    # PPM: multi-bin pooled contexts resized back and fused.
    ppm = params["ppm"]
    branches = [deepest]
    for branch, bins in zip(ppm["branches"], cfg.pool_bins):
        pooled = _cgn(branch, adaptive_avg_pool(deepest, bins), cfg.groups)
        branches.append(resize(pooled, deepest.shape[2:]))
    top = _cgn(ppm["project"], torch.cat(branches, dim=1), cfg.groups)

    # FPN top-down: OS-16 (PPM output) -> OS-8 -> OS-4 -> OS-2.
    pyramid = [top]
    h = top
    for lat, smooth, skip in zip(params["lateral"][::-1], params["smooth"],
                                 (skips[3], skips[2], skips[1])):
        lateral = _cgn(lat, skip.to(h.dtype), cfg.groups)
        h = _cgn(smooth, lateral + resize(h, lateral.shape[2:]), cfg.groups)
        pyramid.append(h)

    # Fuse the whole pyramid at the finest level.
    target = pyramid[-1].shape[2:]
    fused = torch.cat([resize(p, target) for p in pyramid], dim=1)
    return apply_epilogue(params, _cgn(params["fuse"], fused, cfg.groups),
                          images)
