"""Segformer segmentation family (the all-MLP decoder), the TPU package's
``models/segformer.py``.

The SegFormer decode head over either encoder: a MiT preset
(``encoder_name="mit_b0"`` ... ``"mit_b5"``, ``models/mit.py``: four
levels at OS-4/8/16/32) or the shared GroupNorm encoder of
``models/unet.py`` (any other preset: three levels at OS-4/8/16, the
encoder's ``(skips[2], skips[3], deepest)``). Each level is projected by a
1x1 conv onto ``embed_channels``, resized (gather form) to the OS-4 grid,
concatenated shallowest first, fused by one more 1x1 conv, normalized
(GroupNorm, or with ``head_norm="affine"`` the per-channel scale and bias
that HF's inference-mode BatchNorm folds to), passed through ReLU and
classified by the fp32 1x1 head, then resized to the input size. NCHW
inside, NHWC at the boundary; a model is a ``ConvSegModel``, so the
trainer, the serving runner and the weight bridge take it as they take
the other conv families. No dropout. A MiT encoder's attention takes
``attn_impl`` (``models/mit.py``: kernel 1 on a CUDA tensor without a
gradient). The decoder, from the projections to the ReLU, runs inside the
range ``segformer.decode`` (``utils/spans.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from visiontransformer_tpu_torch.models.mit import (
    MIT_PRESETS,
    mit_encoder_apply,
    mit_encoder_init,
)
from visiontransformer_tpu_torch.models.unet import (
    ENCODER_PRESETS,
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
from visiontransformer_tpu_torch.utils.spans import ranged


@dataclasses.dataclass(frozen=True)
class SegformerConfig(EncoderConfig):
    encoder_name: str = "resnet34"
    in_channels: int = 3
    num_classes: int = 17
    embed_channels: int = 256  # smp's segmentation_channels default
    groups: int = 8  # GroupNorm groups (the fuse; the conv encoder)
    compute_dtype: str = "float32"
    normalize: bool = True  # smp-style input normalization in forward
    head_norm: str = "gn"  # or "affine": HF's folded BatchNorm

    @property
    def is_mit(self) -> bool:
        return self.encoder_name in MIT_PRESETS

    @property
    def level_channels(self) -> Sequence[int]:
        """Widths of the levels the decode head reads, shallowest first."""
        if self.is_mit:
            return MIT_PRESETS[self.encoder_name][0]
        ch = ENCODER_PRESETS[self.encoder_name][0]
        return (ch[2], ch[3], ch[4])


def segformer_init(generator: torch.Generator,
                   cfg: SegformerConfig) -> ConvSegModel:
    if cfg.is_mit:
        params = mit_encoder_init(generator, cfg.encoder_name,
                                  cfg.in_channels)
    else:
        params = encoder_init(generator, cfg)
    c = cfg.embed_channels
    levels = list(cfg.level_channels)
    params["proj"] = [conv2d_init(generator, cin, c, 1) for cin in levels]
    norm = ({"affine": {"scale": torch.ones(c), "bias": torch.zeros(c)}}
            if cfg.head_norm == "affine" else {"gn": group_norm_init(c)})
    params["fuse"] = {"conv": conv2d_init(generator, c * len(levels), c, 1),
                      **norm}
    params["head"] = conv2d_init(generator, c, cfg.num_classes, 1)
    return ConvSegModel("segformer", cfg, params, segformer_apply)


def segformer_apply(params: ConvSegModel, images: torch.Tensor, *,
                    deterministic: bool = True,
                    generator: Optional[torch.Generator] = None,
                    attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, num_classes) fp32 logits at input
    resolution. ``attn_impl`` reaches a MiT encoder's attention."""
    del deterministic, generator  # no dropout
    cfg = params.cfg
    x = apply_prologue(params, images, cfg)
    if cfg.is_mit:
        levels = mit_encoder_apply(params, x, cfg.encoder_name, attn_impl)
    else:
        deepest, skips = encoder_apply(params, x, cfg.groups)
        levels = (skips[2], skips[3], deepest)  # OS-4, OS-8, OS-16
    with ranged("segformer.decode"):
        target = (levels[0].shape[2], levels[0].shape[3])
        fused = torch.cat([resize(conv(proj, feat.to(x.dtype)), target)
                           for proj, feat in zip(params["proj"], levels)],
                          dim=1)
        fuse = params["fuse"]
        fused = conv(fuse["conv"], fused)
        if "affine" in fuse:
            shape = (1, -1, 1, 1)
            fused = fused * fuse["affine"]["scale"].to(fused.dtype).reshape(
                shape) + fuse["affine"]["bias"].to(fused.dtype).reshape(shape)
        else:
            fused = group_norm(fuse["gn"], fused, cfg.groups)
        fused = F.relu(fused)
    return apply_epilogue(params, fused, images)
