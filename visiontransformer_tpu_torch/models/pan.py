"""PAN segmentation family (Pyramid Attention Network), the TPU package's
``models/pan.py``: a Feature Pyramid Attention module on the deepest
features (a 7/5/3-kernel stride-2 conv pyramid, resized and summed back
up, gating a 1x1 center branch, plus a global-pool branch) and three
Global Attention Upsample blocks fusing the OS-8, OS-4 and OS-2 stages.
The stride-2 convolutions pad as XLA's SAME does
(``nn/layers.py:conv2d_nchw``: (2, 3) for k = 7, (1, 2) for k = 5, (0, 1)
for k = 3 on an even size). NCHW inside, NHWC at the boundary
(``models/unet.py``)."""

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
class PANConfig(EncoderConfig):
    encoder_name: str = "resnet34"
    in_channels: int = 3
    num_classes: int = 17
    decoder_channels: int = 64  # width of the FPA output and GAU stream
    groups: int = 8  # GroupNorm groups
    compute_dtype: str = "float32"
    normalize: bool = True  # smp-style input normalization in forward


def _cgn_init(generator, cin: int, cout: int, kernel: int) -> dict:
    return {"conv": conv2d_init(generator, cin, cout, kernel),
            "gn": group_norm_init(cout)}


def _cgn(params, x: torch.Tensor, groups: int, *, stride: int = 1,
         relu: bool = True) -> torch.Tensor:
    y = group_norm(params["gn"], conv(params["conv"], x, stride=stride),
                   groups)
    return F.relu(y) if relu else y


def _fpa_init(generator, cin: int, c: int) -> dict:
    return {
        "mid": _cgn_init(generator, cin, c, 1),
        "global": _cgn_init(generator, cin, c, 1),
        "down7": _cgn_init(generator, cin, c, 7),
        "down5": _cgn_init(generator, c, c, 5),
        "down3": _cgn_init(generator, c, c, 3),
        "up7": _cgn_init(generator, c, c, 7),
        "up5": _cgn_init(generator, c, c, 5),
        "up3": _cgn_init(generator, c, c, 3),
    }


def _fpa_apply(fpa, x: torch.Tensor, groups: int) -> torch.Tensor:
    """Feature Pyramid Attention: (B, C_in, h, w) -> (B, c, h, w)."""
    mid = _cgn(fpa["mid"], x, groups, relu=False)
    d1 = _cgn(fpa["down7"], x, groups, stride=2)   # h/2
    d2 = _cgn(fpa["down5"], d1, groups, stride=2)  # h/4
    d3 = _cgn(fpa["down3"], d2, groups, stride=2)  # h/8
    p3 = _cgn(fpa["up3"], d3, groups)
    p2 = _cgn(fpa["up5"], d2, groups) + resize(p3, d2.shape[2:])
    p1 = _cgn(fpa["up7"], d1, groups) + resize(p2, d1.shape[2:])
    pyr = resize(p1, x.shape[2:])
    glob = _cgn(fpa["global"], x.mean(dim=(2, 3), keepdim=True), groups,
                relu=False)
    return mid * pyr + glob.expand(-1, -1, x.shape[2], x.shape[3])


def _gau_init(generator, low_cin: int, c: int) -> dict:
    return {"low": _cgn_init(generator, low_cin, c, 3),
            "att": conv2d_init(generator, c, c, 1)}


def _gau_apply(gau, high: torch.Tensor, low: torch.Tensor,
               groups: int) -> torch.Tensor:
    """Global Attention Upsample: the high-level features' pooled channel
    vector reweights the low-level features, then resize-add."""
    low = _cgn(gau["low"], low, groups, relu=False)
    att = torch.sigmoid(conv(gau["att"], high.mean(dim=(2, 3),
                                                   keepdim=True)))
    return resize(high, low.shape[2:]) + low * att


def pan_init(generator: torch.Generator, cfg: PANConfig) -> ConvSegModel:
    params = encoder_init(generator, cfg)
    c = cfg.decoder_channels
    params["fpa"] = _fpa_init(generator, cfg.stage_channels[-1], c)
    # GAU fusion with the OS-8, OS-4 and OS-2 stages (skips[3], [2], [1]).
    params["gau"] = [_gau_init(generator, cfg.stage_channels[i], c)
                     for i in (3, 2, 1)]
    params["head"] = conv2d_init(generator, c, cfg.num_classes, 1)
    return ConvSegModel("pan", cfg, params, pan_apply)


def pan_apply(params: ConvSegModel, images: torch.Tensor, *,
              deterministic: bool = True,
              generator: Optional[torch.Generator] = None,
              attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, num_classes) fp32 logits at input
    resolution."""
    del deterministic, generator, attn_impl  # no dropout, no attention
    cfg = params.cfg
    x = apply_prologue(params, images, cfg)
    deepest, skips = encoder_apply(params, x, cfg.groups)
    h = _fpa_apply(params["fpa"], deepest, cfg.groups)
    for gau, skip in zip(params["gau"], (skips[3], skips[2], skips[1])):
        h = _gau_apply(gau, h, skip.to(h.dtype), cfg.groups)
    return apply_epilogue(params, h, images)
