"""LinkNet segmentation family (additive-skip encoder-decoder), the TPU
package's ``models/linknet.py``: per encoder stage a decoder block (1x1 to
c/4, a 2x bilinear resize then a 3x3 conv, not a transposed conv, and a
1x1 projection onto the skip's width) merged with the skip by addition,
then a 3x3 conv, the 1x1 head and a bilinear upsample to the input size.
NCHW inside, NHWC at the boundary (``models/unet.py``)."""

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
class LinkNetConfig(EncoderConfig):
    encoder_name: str = "resnet34"
    in_channels: int = 3
    num_classes: int = 17
    groups: int = 8  # GroupNorm groups
    compute_dtype: str = "float32"
    normalize: bool = True  # smp-style input normalization in forward


def _decoder_block_init(generator, cin: int, cout: int) -> dict:
    mid = max(cin // 4, 8)
    return {
        "reduce": conv2d_init(generator, cin, mid, 1),
        "gn1": group_norm_init(mid),
        "up": conv2d_init(generator, mid, mid, 3),
        "gn2": group_norm_init(mid),
        "expand": conv2d_init(generator, mid, cout, 1),
        "gn3": group_norm_init(cout),
    }


def _decoder_block_apply(params, x: torch.Tensor,
                         groups: int) -> torch.Tensor:
    """Bottleneck -> 2x resize + 3x3 conv -> project to the skip's width."""
    y = F.relu(group_norm(params["gn1"], conv(params["reduce"], x), groups))
    y = resize(y, (y.shape[2] * 2, y.shape[3] * 2))
    y = F.relu(group_norm(params["gn2"], conv(params["up"], y), groups))
    return F.relu(group_norm(params["gn3"], conv(params["expand"], y),
                             groups))


def linknet_init(generator: torch.Generator,
                 cfg: LinkNetConfig) -> ConvSegModel:
    params = encoder_init(generator, cfg)
    channels = list(cfg.stage_channels)
    cin = channels[-1]
    params["decoder"] = []
    for skip_c in channels[:-1][::-1]:  # deepest skip first
        params["decoder"].append(_decoder_block_init(generator, cin, skip_c))
        cin = skip_c
    params["head_conv"] = conv2d_init(generator, cin, cin, 3)
    params["head_gn"] = group_norm_init(cin)
    params["head"] = conv2d_init(generator, cin, cfg.num_classes, 1)
    return ConvSegModel("linknet", cfg, params, linknet_apply)


def linknet_apply(params: ConvSegModel, images: torch.Tensor, *,
                  deterministic: bool = True,
                  generator: Optional[torch.Generator] = None,
                  attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, num_classes) fp32 logits at input
    resolution."""
    del deterministic, generator, attn_impl  # no dropout, no attention
    cfg = params.cfg
    x = apply_prologue(params, images, cfg)
    x, skips = encoder_apply(params, x, cfg.groups)
    # Additive skip merge, deepest skip first.
    for dec, skip in zip(params["decoder"], skips[::-1]):
        y = _decoder_block_apply(dec, x, cfg.groups)
        if y.shape[2] != skip.shape[2]:
            y = resize(y, skip.shape[2:])
        x = y + skip.to(y.dtype)
    x = F.relu(group_norm(params["head_gn"], conv(params["head_conv"], x),
                          cfg.groups))
    return apply_epilogue(params, x, images)
