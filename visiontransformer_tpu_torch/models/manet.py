"""MAnet segmentation family (Multi-scale Attention Network), the TPU
package's ``models/manet.py``: a Position-wise Attention Block on the
deepest features (softmax attention over every position, out = x + gamma
* softmax(QK^T / sqrt(d)) V, gamma zero at init) and a UNet-shaped
decoder whose skip fusions are residual blocks followed by a
squeeze-excitation gate. The attention is a ``torch.matmul`` pair with the
softmax in fp32, as the TPU package computes it (an XLA op there, not its
flash kernel). NCHW inside, NHWC at the boundary (``models/unet.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from visiontransformer_tpu_torch.models.unet import (
    ConvSegModel,
    EncoderConfig,
    apply_epilogue,
    apply_prologue,
    block_apply,
    block_init,
    conv,
    encoder_apply,
    encoder_init,
    resize,
)
from visiontransformer_tpu_torch.nn.layers import conv2d_init


@dataclasses.dataclass(frozen=True)
class MAnetConfig(EncoderConfig):
    encoder_name: str = "resnet34"
    in_channels: int = 3
    num_classes: int = 17
    decoder_channels: Tuple[int, ...] = (256, 128, 64, 32)
    pab_reduction: int = 8   # q/k width = C / pab_reduction in the PAB
    se_reduction: int = 16   # squeeze-excite bottleneck in the MFABs
    groups: int = 8  # GroupNorm groups
    compute_dtype: str = "float32"
    normalize: bool = True  # smp-style input normalization in forward


def _pab_init(generator, c: int, reduction: int) -> dict:
    cr = max(c // reduction, 8)
    return {
        "query": conv2d_init(generator, c, cr, 1),
        "key": conv2d_init(generator, c, cr, 1),
        "value": conv2d_init(generator, c, c, 1),
        "gamma": torch.zeros(()),  # residual gate, starts closed
    }


def _pab_apply(pab, x: torch.Tensor) -> torch.Tensor:
    """Position-wise attention over the deepest grid, every position
    attending to every position."""
    b, c, h, w = x.shape
    q = conv(pab["query"], x).flatten(2).transpose(1, 2)  # (b, hw, cr)
    k = conv(pab["key"], x).flatten(2).transpose(1, 2)
    v = conv(pab["value"], x).flatten(2).transpose(1, 2)  # (b, hw, c)
    # 1 / sqrt(d) in fp32, rounded to the activation dtype, as a host
    # scalar (no copy to the device).
    scale = float((1.0 / torch.sqrt(torch.tensor(
        float(q.shape[-1])))).to(q.dtype))
    logits = torch.matmul(q, k.transpose(1, 2)) * scale
    attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(b, c, h, w)
    return x + pab["gamma"].to(x.dtype) * out


def _se_init(generator, c: int, reduction: int) -> dict:
    cr = max(c // reduction, 8)
    return {"squeeze": conv2d_init(generator, c, cr, 1),
            "excite": conv2d_init(generator, cr, c, 1)}


def _se_apply(se, x: torch.Tensor) -> torch.Tensor:
    g = F.relu(conv(se["squeeze"], x.mean(dim=(2, 3), keepdim=True)))
    return x * torch.sigmoid(conv(se["excite"], g))


def manet_init(generator: torch.Generator, cfg: MAnetConfig) -> ConvSegModel:
    channels = list(cfg.stage_channels)
    if len(cfg.decoder_channels) != len(channels) - 1:
        raise ValueError(
            f"decoder_channels must have {len(channels) - 1} entries, got "
            f"{len(cfg.decoder_channels)}")
    params = encoder_init(generator, cfg)
    params["pab"] = _pab_init(generator, channels[-1], cfg.pab_reduction)
    # MFAB decoder: deepest -> shallowest, skips from the encoder stages.
    params["decoder"] = []
    cin = channels[-1]
    for dec_c, skip_c in zip(cfg.decoder_channels, channels[:-1][::-1]):
        params["decoder"].append({
            "fuse": block_init(generator, cin + skip_c, dec_c),
            "se": _se_init(generator, dec_c, cfg.se_reduction),
        })
        cin = dec_c
    params["head"] = conv2d_init(generator, cin, cfg.num_classes, 1)
    return ConvSegModel("manet", cfg, params, manet_apply)


def manet_apply(params: ConvSegModel, images: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, num_classes) fp32 logits at input
    resolution."""
    del deterministic, generator, attn_impl  # no dropout; matmul attention
    cfg = params.cfg
    x = apply_prologue(params, images, cfg)
    h, skips = encoder_apply(params, x, cfg.groups)
    h = _pab_apply(params["pab"], h)
    for mfab, skip in zip(params["decoder"], skips[::-1]):
        h = resize(h, skip.shape[2:])
        h = torch.cat([h, skip.to(h.dtype)], dim=1)
        h = _se_apply(mfab["se"], block_apply(mfab["fuse"], h, cfg.groups))
    return apply_epilogue(params, h, images)
