"""UNet++ segmentation family (nested dense skip pathways), the TPU
package's ``models/unetpp.py``: grid node X[i][j] fuses every earlier node
at its level (X[i][0..j-1]) with the resized node one level deeper
(X[i+1][j-1]) through a residual block; the head reads the top node of the
last column. NCHW inside, NHWC at the boundary (``models/unet.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from visiontransformer_tpu_torch.models.unet import (
    ConvSegModel,
    EncoderConfig,
    apply_epilogue,
    apply_prologue,
    block_apply,
    block_init,
    encoder_apply,
    encoder_init,
    resize,
)
from visiontransformer_tpu_torch.nn.layers import conv2d_init


@dataclasses.dataclass(frozen=True)
class UNetPlusPlusConfig(EncoderConfig):
    encoder_name: str = "resnet34"
    in_channels: int = 3
    num_classes: int = 17
    # Node width per resolution level (level 0 = input resolution).
    decoder_channels: Tuple[int, ...] = (32, 64, 128, 256)
    groups: int = 8  # GroupNorm groups
    compute_dtype: str = "float32"
    normalize: bool = True  # smp-style input normalization in forward


def _node_in_channels(cfg: UNetPlusPlusConfig, i: int, j: int) -> int:
    """Input width of grid node X[i][j] (j >= 1): the encoder feature at
    level i, the j - 1 earlier decoder nodes at level i, and the resized
    node from level i + 1, column j - 1."""
    enc, dec = list(cfg.stage_channels), list(cfg.decoder_channels)
    below = enc[i + 1] if j == 1 else dec[i + 1]
    return enc[i] + (j - 1) * dec[i] + below


def unetplusplus_init(generator: torch.Generator,
                      cfg: UNetPlusPlusConfig) -> ConvSegModel:
    n_levels = len(cfg.stage_channels)  # 5: stem + 4 stages
    if len(cfg.decoder_channels) != n_levels - 1:
        raise ValueError(
            f"decoder_channels must have {n_levels - 1} entries "
            f"(one per resolution level above the deepest), got "
            f"{len(cfg.decoder_channels)}")
    params = encoder_init(generator, cfg)
    dec = list(cfg.decoder_channels)
    params["nodes"] = {}
    for j in range(1, n_levels):
        for i in range(n_levels - j):
            params["nodes"][f"x{i}_{j}"] = block_init(
                generator, _node_in_channels(cfg, i, j), dec[i])
    params["head"] = conv2d_init(generator, dec[0], cfg.num_classes, 1)
    return ConvSegModel("unetplusplus", cfg, params, unetplusplus_apply)


def unetplusplus_apply(params: ConvSegModel, images: torch.Tensor, *,
                       deterministic: bool = True,
                       generator: Optional[torch.Generator] = None,
                       attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, num_classes) fp32 logits at input
    resolution."""
    del deterministic, generator, attn_impl  # no dropout, no attention
    cfg = params.cfg
    x = apply_prologue(params, images, cfg)
    deepest, skips = encoder_apply(params, x, cfg.groups)
    levels = skips + [deepest]  # X[i][0], i = 0..4, full res -> OS-16
    n_levels = len(levels)
    grid = {(i, 0): levels[i] for i in range(n_levels)}
    for j in range(1, n_levels):
        for i in range(n_levels - j):
            same_level = [grid[(i, k)] for k in range(j)]
            below = resize(grid[(i + 1, j - 1)], same_level[0].shape[2:])
            fused = torch.cat([t.to(x.dtype) for t in same_level] + [below],
                              dim=1)
            grid[(i, j)] = block_apply(params["nodes"][f"x{i}_{j}"], fused,
                                       cfg.groups)
    return apply_epilogue(params, grid[(0, n_levels - 1)], images)
