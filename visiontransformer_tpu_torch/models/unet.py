"""UNet-style encoder-decoder segmentation family, and the residual
GroupNorm encoder every conv family shares.

The TPU package's ``models/unet.py``: the alternate architecture of the
reference (``StructuralDamageModel`` over ``smp.create_model(arch,
encoder_name, ...)`` with per-encoder mean/std buffers and CE loss,
reference model/CE/classes.py:105-219), a residual conv encoder with
stride-2 stages, GroupNorm in place of BatchNorm, and a bilinear-upsample
+ skip-concat decoder.

Layout: the apply functions take NHWC images and return NHWC fp32 logits,
as the TPU package's do, and run NCHW inside (the permuted input keeps
its NHWC memory, channels_last, which the convolutions follow) with OIHW
kernels: ``ckpt/convert.py`` transposes the TPU package's HWIO kernels at
the boundary. A model is a ``ConvSegModel``: its parameters form a
``ParamTree`` under the TPU package's names, read by the apply functions
as the dicts the TPU package's read (``params["conv1"]["kernel"]``), with
the normalization constants as buffers (``norm_mean``, ``norm_std``).
The inits draw the TPU package's distributions (trunc-normal(0.02, +-2
std) kernels, zero biases, GroupNorm ones and zeros) from a
``torch.Generator``: the same distributions, not the same bits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from visiontransformer_tpu_torch.nn.layers import (
    ParamTree,
    _linear_w8a8,
    conv2d_init,
    conv2d_nchw,
    conv2d_w8a8,
    depthwise_init,
)
from visiontransformer_tpu_torch.nn.layers import linear as dense
from visiontransformer_tpu_torch.ops.resize import resize_bilinear

# Encoder presets: (stage channels, blocks per stage, block kind), the TPU
# package's: "basic" 3x3 -> 3x3 residual blocks, "bottleneck" 1x1 -> 3x3 ->
# 1x1 (expansion 4), "inverted" the MobileNetV2 block (ReLU6, linear
# bottleneck, expansion 6), "mbconv" the EfficientNet block (SiLU + SE).
ENCODER_PRESETS = {
    "resnet18": ((64, 64, 128, 256, 512), (2, 2, 2, 2), "basic"),
    "resnet34": ((64, 64, 128, 256, 512), (3, 4, 6, 3), "basic"),
    "resnet50": ((64, 256, 512, 1024, 2048), (3, 4, 6, 3), "bottleneck"),
    "mobilenetv2": ((32, 24, 32, 96, 320), (2, 3, 4, 3), "inverted"),
    "efficientnet_b0": ((32, 24, 40, 112, 320), (2, 2, 3, 4), "mbconv"),
    "small": ((32, 32, 64, 128, 256), (1, 1, 1, 1), "basic"),
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class EncoderConfig:
    """The fields and properties every conv-family config shares."""

    @property
    def stage_channels(self) -> Sequence[int]:
        return ENCODER_PRESETS[self.encoder_name][0]

    @property
    def stage_blocks(self) -> Sequence[int]:
        return ENCODER_PRESETS[self.encoder_name][1]

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class UNetConfig(EncoderConfig):
    encoder_name: str = "resnet34"
    in_channels: int = 3
    num_classes: int = 17
    decoder_channels: Tuple[int, ...] = (256, 128, 64, 32)
    groups: int = 8  # GroupNorm groups
    compute_dtype: str = "float32"
    normalize: bool = True  # smp-style input normalization in forward


class ConvSegModel(ParamTree):
    """A conv-family model: the parameter tree of ``init``, the ImageNet
    normalization constants as buffers (``norm_mean``, ``norm_std``; the
    TPU package's tree holds them as parameters), its config and the
    family's apply function, which ``forward`` calls. ``forward`` passes
    ``attn_impl``, ``deterministic`` and ``generator`` on to the apply
    function, which ignores them (no dropout in these families; only
    segformer's MiT encoders read ``attn_impl``), so the training tasks
    and the serving runner call every family alike."""

    def __init__(self, family: str, cfg, tree: dict,
                 apply_fn: Callable[..., torch.Tensor]):
        super().__init__(tree)
        self.family = family
        self.cfg = cfg
        self._apply_fn = apply_fn
        self.register_buffer("norm_mean", torch.tensor(IMAGENET_MEAN))
        self.register_buffer("norm_std", torch.tensor(IMAGENET_STD))

    def forward(self, images: torch.Tensor, **kwargs) -> torch.Tensor:
        return self._apply_fn(self, images, **kwargs)


def conv(params, x: torch.Tensor, *, stride: int = 1, dilation: int = 1,
         padding: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The TPU package's ``conv2d(params, x)`` on NCHW activations (SAME
    padding, or ``padding`` on both sides); a W8A8 layer (``kernel_q``,
    ``ops/quant.py``) runs ``conv2d_w8a8``, as the TPU package's dispatches
    on the same key."""
    if "kernel_q" in params:
        return conv2d_w8a8(x, params["kernel_q"], params["kernel_scale"],
                           params["bias"], stride=stride, dilation=dilation,
                           padding=padding)
    return conv2d_nchw(x, params["kernel"], params["bias"], stride=stride,
                       dilation=dilation, padding=padding)


def linear(params, x: torch.Tensor) -> torch.Tensor:
    """The TPU package's ``linear(params, x)`` on (..., in) activations
    with an (in, out) kernel; a W8A8 layer (``kernel_q``) runs
    ``_linear_w8a8``."""
    bias = params["bias"] if "bias" in params else None
    if "kernel_q" in params:
        return _linear_w8a8(x, params["kernel_q"], params["kernel_scale"],
                            bias)
    return dense(x, params["kernel"], bias)


def _depthwise(params, x: torch.Tensor, *,
                   stride: int = 1) -> torch.Tensor:
    """Per-channel SAME convolution of NCHW x with a (C, 1, k, k) kernel
    (the TPU package's ``depthwise``)."""
    return conv2d_nchw(x, params["kernel"], params["bias"], stride=stride,
                       groups=x.shape[1])


def group_norm_init(channels: int) -> dict:
    return {"scale": torch.ones(channels), "bias": torch.zeros(channels)}


def group_norm(params, x: torch.Tensor, groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """The TPU package's ``_group_norm`` on NCHW: g = min(groups, C),
    lowered until it divides C; fp32 statistics (biased variance, eps
    1e-5) and the affine in fp32, then cast back to x's dtype."""
    c = x.shape[1]
    g = min(groups, c)
    while c % g:
        g -= 1
    return F.group_norm(x.float(), g, params["scale"], params["bias"],
                        eps).to(x.dtype)


def block_init(generator, cin: int, cout: int) -> dict:
    params = {
        "conv1": conv2d_init(generator, cin, cout, 3),
        "gn1": group_norm_init(cout),
        "conv2": conv2d_init(generator, cout, cout, 3),
        "gn2": group_norm_init(cout),
    }
    if cin != cout:
        params["proj"] = conv2d_init(generator, cin, cout, 1)
    return params


def _bottleneck_init(generator, cin: int, cout: int) -> dict:
    mid = cout // 4
    params = {
        "conv1": conv2d_init(generator, cin, mid, 1),
        "gn1": group_norm_init(mid),
        "conv2": conv2d_init(generator, mid, mid, 3),
        "gn2": group_norm_init(mid),
        "conv3": conv2d_init(generator, mid, cout, 1),
        "gn3": group_norm_init(cout),
    }
    if cin != cout:
        params["proj"] = conv2d_init(generator, cin, cout, 1)
    return params


def _inverted_init(generator, cin: int, cout: int, *, se: bool = False,
                   expand: int = 6) -> dict:
    """MobileNetV2 inverted residual; with ``se`` the EfficientNet MBConv
    (squeeze-excitation on the expanded channels, hidden width cin // 4)."""
    mid = cin * expand
    params = {
        "expand": conv2d_init(generator, cin, mid, 1),
        "gn_e": group_norm_init(mid),
        "dw": depthwise_init(generator, mid, 3),
        "gn_d": group_norm_init(mid),
        "project": conv2d_init(generator, mid, cout, 1),
        "gn_p": group_norm_init(cout),
    }
    if se:
        hidden = max(1, cin // 4)
        params["se"] = {"fc1": conv2d_init(generator, mid, hidden, 1),
                        "fc2": conv2d_init(generator, hidden, mid, 1)}
    return params


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def _inverted_apply(params, x: torch.Tensor, groups: int,
                    stride: int) -> torch.Tensor:
    # SE presence selects the activation: MBConv is SiLU, the plain
    # inverted residual ReLU6.
    act = F.silu if "se" in params else _relu6
    y = act(group_norm(params["gn_e"], conv(params["expand"], x), groups))
    y = act(group_norm(params["gn_d"],
                       _depthwise(params["dw"], y, stride=stride), groups))
    if "se" in params:
        s = y.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(conv(params["se"]["fc2"],
                               F.silu(conv(params["se"]["fc1"], s))))
        y = y * s
    y = group_norm(params["gn_p"], conv(params["project"], y), groups)
    # Linear bottleneck: residual only at stride 1 and equal width, no
    # activation after the projection.
    if stride == 1 and x.shape[1] == y.shape[1]:
        y = x + y
    return y


def block_apply(params, x: torch.Tensor, groups: int,
                stride: int = 1) -> torch.Tensor:
    """Residual block, dispatched on the parameters as the TPU package's
    ``_block_apply``: "dw" marks the inverted/MBConv block, a third conv
    the bottleneck (stride on the 3x3), else the basic 3x3 -> 3x3."""
    if "dw" in params:
        return _inverted_apply(params, x, groups, stride)
    if "conv3" in params:
        y = F.relu(group_norm(params["gn1"], conv(params["conv1"], x),
                              groups))
        y = conv(params["conv2"], y, stride=stride)
        y = F.relu(group_norm(params["gn2"], y, groups))
        y = group_norm(params["gn3"], conv(params["conv3"], y), groups)
    else:
        y = conv(params["conv1"], x, stride=stride)
        y = F.relu(group_norm(params["gn1"], y, groups))
        y = group_norm(params["gn2"], conv(params["conv2"], y), groups)
    shortcut = x
    if "proj" in params:
        shortcut = conv(params["proj"], x, stride=stride)
    elif stride != 1:
        shortcut = x[:, :, ::stride, ::stride]
    return F.relu(y + shortcut)


def encoder_init(generator, cfg) -> dict:
    """The shared encoder's parameters (stem + stride-2 stages) for any
    config with ``encoder_name``, ``stage_channels``, ``stage_blocks`` and
    ``in_channels``; the block kind comes from the encoder preset."""
    channels = list(cfg.stage_channels)
    kind = ENCODER_PRESETS[cfg.encoder_name][2]
    init_block = {
        "bottleneck": _bottleneck_init,
        "inverted": functools.partial(_inverted_init, se=False),
        "mbconv": functools.partial(_inverted_init, se=True),
    }.get(kind, block_init)
    params = {"stem": conv2d_init(generator, cfg.in_channels, channels[0], 3),
              "stem_gn": group_norm_init(channels[0]),
              "stages": []}
    cin = channels[0]
    for cout, n_blocks in zip(channels[1:], cfg.stage_blocks):
        stage = []
        for b in range(n_blocks):
            stage.append(init_block(generator, cin if b == 0 else cout, cout))
            cin = cout
        params["stages"].append(stage)
    return params


def encoder_apply(params, x: torch.Tensor, groups: int):
    """Run the shared encoder on NCHW x: (deepest features, the per-stage
    skip inputs, shallowest first)."""
    x = F.relu(group_norm(params["stem_gn"], conv(params["stem"], x),
                          groups))
    skips = []
    for stage in params["stages"]:
        skips.append(x)
        for b_idx, block in enumerate(stage):
            x = block_apply(block, x, groups, stride=2 if b_idx == 0 else 1)
    return x, skips


def resize(x: torch.Tensor, size) -> torch.Tensor:
    """The TPU package's ``resize_bilinear`` (gather form) on NCHW."""
    return resize_bilinear(x, tuple(size), h_axis=2, w_axis=3)


def apply_prologue(params, images: torch.Tensor, cfg) -> torch.Tensor:
    """(B, H, W, C) images -> NCHW activations in the compute dtype,
    normalized as the TPU package does: the constants cast to the compute
    dtype before the arithmetic."""
    x = images.to(cfg.dtype)
    if cfg.normalize:
        x = (x - params["norm_mean"].to(x.dtype)) / \
            params["norm_std"].to(x.dtype)
    return x.permute(0, 3, 1, 2)


def apply_epilogue(params, x: torch.Tensor, images: torch.Tensor
                   ) -> torch.Tensor:
    """The 1x1 head on NCHW x -> (B, H, W, classes) fp32 logits at the
    input resolution."""
    logits = conv(params["head"], x).float()
    if logits.shape[2] != images.shape[1]:
        logits = resize(logits, (images.shape[1], images.shape[2]))
    return logits.permute(0, 2, 3, 1)


def unet_init(generator: torch.Generator, cfg: UNetConfig) -> ConvSegModel:
    channels = list(cfg.stage_channels)
    params = encoder_init(generator, cfg)
    params["decoder"] = []
    # Decoder: deepest -> shallowest, skip channels from encoder stages.
    skip_channels = channels[:-1][::-1] + [0]
    cin = channels[-1]
    for dec_c, skip_c in zip(cfg.decoder_channels, skip_channels):
        params["decoder"].append(block_init(generator, cin + skip_c, dec_c))
        cin = dec_c
    params["head"] = conv2d_init(generator, cin, cfg.num_classes, 1)
    return ConvSegModel("unet", cfg, params, unet_apply)


def unet_apply(params: ConvSegModel, images: torch.Tensor, *,
               deterministic: bool = True,
               generator: Optional[torch.Generator] = None,
               attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, num_classes) fp32 logits at input
    resolution."""
    del deterministic, generator, attn_impl  # no dropout, no attention
    cfg = params.cfg
    x = apply_prologue(params, images, cfg)
    x, skips = encoder_apply(params, x, cfg.groups)
    skips = skips[::-1]
    for i, dec in enumerate(params["decoder"]):
        x = resize(x, (x.shape[2] * 2, x.shape[3] * 2))
        if i < len(skips):
            skip = skips[i]
            if skip.shape[2] != x.shape[2]:
                skip = resize(skip, (x.shape[2], x.shape[3]))
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        x = block_apply(dec, x, cfg.groups)
    return apply_epilogue(params, x, images)
