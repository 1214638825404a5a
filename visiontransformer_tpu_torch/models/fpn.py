"""FPN segmentation family (Feature Pyramid Network decoder), the TPU
package's ``models/fpn.py``: 1x1 lateral projections of the encoder's
stage outputs onto one pyramid width, a top-down upsample-and-add pathway,
a 3x3 segmentation block per level upsampled to the finest level and
summed, then the 1x1 head and a bilinear upsample to the input size. NCHW
inside, NHWC at the boundary (``models/unet.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

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
class FPNConfig(EncoderConfig):
    encoder_name: str = "resnet34"
    in_channels: int = 3
    num_classes: int = 17
    pyramid_channels: int = 256
    segmentation_channels: int = 128
    groups: int = 8  # GroupNorm groups
    compute_dtype: str = "float32"
    normalize: bool = True  # smp-style input normalization in forward


def _seg_block_init(generator, cin: int, cout: int) -> dict:
    return {"conv": conv2d_init(generator, cin, cout, 3),
            "gn": group_norm_init(cout)}


def _seg_block_apply(params, x: torch.Tensor, groups: int) -> torch.Tensor:
    return F.relu(group_norm(params["gn"], conv(params["conv"], x), groups))


def fpn_init(generator: torch.Generator, cfg: FPNConfig) -> ConvSegModel:
    params = encoder_init(generator, cfg)
    stage_outputs = list(cfg.stage_channels[1:])
    params["laterals"] = [
        conv2d_init(generator, c, cfg.pyramid_channels, 1)
        for c in stage_outputs]
    params["seg_blocks"] = [
        _seg_block_init(generator, cfg.pyramid_channels,
                        cfg.segmentation_channels)
        for _ in stage_outputs]
    params["head"] = conv2d_init(generator, cfg.segmentation_channels,
                                 cfg.num_classes, 1)
    return ConvSegModel("fpn", cfg, params, fpn_apply)


def fpn_apply(params: ConvSegModel, images: torch.Tensor, *,
              deterministic: bool = True,
              generator: Optional[torch.Generator] = None,
              attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, num_classes) fp32 logits at input
    resolution."""
    del deterministic, generator, attn_impl  # no dropout, no attention
    cfg = params.cfg
    x = apply_prologue(params, images, cfg)
    deepest, skips = encoder_apply(params, x, cfg.groups)
    # Per-stage outputs, shallowest..deepest.
    features = skips[1:] + [deepest]

    # Top-down pathway: lateral project, upsample-and-add.
    pyramid = [None] * len(features)
    top = conv(params["laterals"][-1], features[-1])
    pyramid[-1] = top
    for i in range(len(features) - 2, -1, -1):
        lateral = conv(params["laterals"][i], features[i])
        top = lateral + resize(top, lateral.shape[2:])
        pyramid[i] = top

    # Segmentation branches, merged by summation at the finest level.
    finest_hw = pyramid[0].shape[2:]
    merged = None
    for level, seg in zip(pyramid, params["seg_blocks"]):
        y = _seg_block_apply(seg, level, cfg.groups)
        if y.shape[2] != finest_hw[0]:
            y = resize(y, finest_hw)
        merged = y if merged is None else merged + y
    return apply_epilogue(params, merged, images)
