"""ViT segmentation model: backbone + conv head + bilinear upsample.

Mirrors the TPU package's ``models/vitseg.py``: drop the CLS token, fold
the tokens to the (g, g) grid, Conv3×3(hidden→256) + ReLU +
Conv1×1(256→classes), then one bilinear upsample (align_corners=False) to
the output size. Activations are NHWC throughout, as in the TPU package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from visiontransformer_tpu_torch.configs import ViTSegConfig
from visiontransformer_tpu_torch.models.vit import ViT, vit_apply
from visiontransformer_tpu_torch.nn.layers import Conv2d
from visiontransformer_tpu_torch.ops.resize import resize_bilinear_mm
from visiontransformer_tpu_torch.ops.upsample_argmax import (
    upsample_argmax,
    upsample_argmax_plain,
)

EPILOGUES = ("auto", "plain", "kernel")


class ViTSeg(nn.Module):
    def __init__(self, cfg: ViTSegConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ViT(cfg.vit)
        self.head_conv1 = Conv2d(cfg.vit.hidden_size, cfg.head_channels, 3)
        self.head_conv2 = Conv2d(cfg.head_channels, cfg.num_classes, 1)

    def forward(self, images: torch.Tensor, *,
                attn_impl: str = "auto") -> torch.Tensor:
        return vitseg_apply(self, images, attn_impl=attn_impl)


def vitseg_head_logits(model: ViTSeg, images: torch.Tensor, *,
                       attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, 3) images -> (B, g, g, classes) grid logits, in the
    compute dtype (before the upsample)."""
    cfg = model.cfg
    tokens = vit_apply(model.backbone, images, attn_impl=attn_impl,
                       dtype=cfg.dtype)
    g = cfg.vit.grid_size
    features = tokens[:, 1:, :].reshape(tokens.shape[0], g, g,
                                        cfg.vit.hidden_size)
    x = torch.relu(model.head_conv1(features))
    return model.head_conv2(x)


def vitseg_apply(model: ViTSeg, images: torch.Tensor, *,
                 attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, 3) images -> (B, H, W, classes) fp32 logits."""
    x = vitseg_head_logits(model, images, attn_impl=attn_impl)
    return resize_bilinear_mm(x.float(), (images.shape[1], images.shape[2]))


def vitseg_predict(model: ViTSeg, images: torch.Tensor, *,
                   out_size: Optional[Tuple[int, int]] = None,
                   epilogue: str = "auto",
                   attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, 3) images -> (B, out_H, out_W) int32 argmax class map, with
    ONE bilinear upsample straight from the token grid to ``out_size``.

    epilogue: "kernel" runs the fused upsample+argmax kernel
    (``ops/upsample_argmax.py``; its plain version on a CPU tensor),
    "plain" the interpolation products then argmax, "auto" the kernel on a
    CUDA tensor and the plain form on the CPU. Both compute the same
    function."""
    if out_size is None:
        out_size = (images.shape[1], images.shape[2])
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; known: {EPILOGUES}")
    grid = vitseg_head_logits(model, images, attn_impl=attn_impl).float()
    if epilogue == "kernel" or (epilogue == "auto" and grid.is_cuda):
        return upsample_argmax(grid.contiguous(), tuple(out_size))
    return upsample_argmax_plain(grid, tuple(out_size))
