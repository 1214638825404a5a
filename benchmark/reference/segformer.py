"""Plain PyTorch reference of SegFormer (the MiT encoder and the all-MLP
decoder), in float32.

What it computes, from the configuration's ``hf_config`` and the
benchmark's weights (``benchmark/weights_segformer.py``, HF's names), with
nothing of the program, following the paper (Xie et al., arXiv:2105.15203)
and HF's ``modeling_segformer.py`` module by module:

- uint8 images / 255, normalised by ImageNet's mean and std, NCHW;
- per stage: the overlapping patch embedding, a k x k stride-s conv padded
  k // 2 on each side, then a LayerNorm; the blocks; a final LayerNorm;
- a block: LayerNorm; efficient attention: q from every token, k and v
  from the tokens reduced by the r x r stride-r conv and a LayerNorm (r >
  1) or from every token (r = 1), softmax(q·kᵀ / √d) in float32, the
  heads merged, the output projection; the residual; LayerNorm; Mix-FFN:
  fc1, the 3x3 depthwise conv (padding 1), exact-erf GELU, fc2; the
  residual;
- the decoder: each level's ``linear_c`` projection onto the decoder
  width, resized bilinearly (half-pixel centres, ``align_corners=False``)
  to the OS-4 grid, concatenated deepest first as HF concatenates them,
  the bias-free 1x1 fuse, the BatchNorm with its running statistics
  (eps 1e-5), ReLU, the 1x1 classifier;
- the OS-4 logits resized bilinearly (half-pixel) to the output size.

Every LayerNorm has eps 1e-5: HF's modules build ``nn.LayerNorm`` with
torch's default, whatever the config's ``layer_norm_eps``. Departures from
HF, each on purpose: the normalisation of the input and the resize of the
logits, which HF's image processor and its users do outside the model, are
done here; dropout and drop-path, off at inference, are left out.

Every product (linears, convs, Q·Kᵀ and P·V) takes its operands through
``rounding``: the identity for the float32 reference, a coarser type for
the control (``vitseg.fp8_e4m3``). The caller turns TF32 off
(``no_tf32``); ``served_gaps`` and ``control_masks`` do, and compute in
blocks of images so that the reference fits beside the program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.vitseg import (
    Rounding,
    identity,
    mask_gap,
    no_tf32,
    operand,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-5
BN_EPS = 1e-5


def _linear(x, w, prefix, rounding):
    return (torch.matmul(operand(x, rounding),
                         operand(w[prefix + ".weight"], rounding).t())
            + w[prefix + ".bias"])


def _conv(x, w, prefix, rounding, **kwargs):
    bias = w.get(prefix + ".bias")
    return F.conv2d(operand(x, rounding),
                    operand(w[prefix + ".weight"], rounding), bias, **kwargs)


def _layer_norm(x, w, prefix):
    return F.layer_norm(x, (x.shape[-1],), w[prefix + ".weight"],
                        w[prefix + ".bias"], eps=LN_EPS)


def _tokens(x):
    """(B, C, H, W) -> (B, H·W, C)."""
    return x.flatten(2).transpose(1, 2)


def _map(x, h, wd):
    """(B, H·W, C) -> (B, C, H, W)."""
    return x.transpose(1, 2).reshape(x.shape[0], -1, h, wd)


def _attention(x, w, prefix, h, wd, heads, r, rounding):
    b, n, c = x.shape
    hd = c // heads
    q = _linear(x, w, prefix + "attention.self.query", rounding)
    kv = x
    if r > 1:
        kv = _tokens(_conv(_map(x, h, wd), w, prefix + "attention.self.sr",
                           rounding, stride=r))
        kv = _layer_norm(kv, w, prefix + "attention.self.layer_norm")
    k = _linear(kv, w, prefix + "attention.self.key", rounding)
    v = _linear(kv, w, prefix + "attention.self.value", rounding)
    q, k, v = (t.reshape(b, -1, heads, hd).transpose(1, 2)
               for t in (q, k, v))
    scores = torch.matmul(operand(q, rounding),
                          operand(k, rounding).transpose(-1, -2))
    probs = torch.softmax(scores / math.sqrt(hd), dim=-1)
    ctx = torch.matmul(operand(probs, rounding), operand(v, rounding))
    ctx = ctx.transpose(1, 2).reshape(b, n, c)
    return _linear(ctx, w, prefix + "attention.output.dense", rounding)


def _mix_ffn(x, w, prefix, h, wd, rounding):
    y = _linear(x, w, prefix + "mlp.dense1", rounding)
    y = _conv(_map(y, h, wd), w, prefix + "mlp.dwconv.dwconv", rounding,
              padding=1, groups=y.shape[-1])
    y = F.gelu(_tokens(y), approximate="none")
    return _linear(y, w, prefix + "mlp.dense2", rounding)


def encoder(w: Dict[str, torch.Tensor], x: torch.Tensor, hf: dict,
            rounding: Rounding = identity):
    """(B, 3, H, W) normalised images -> the four stages' (B, C, h, w)
    maps, OS-4 first."""
    feats = []
    for i, (depth, heads, r, k, s) in enumerate(zip(
            hf["depths"], hf["num_attention_heads"], hf["sr_ratios"],
            hf["patch_sizes"], hf["strides"])):
        e = f"segformer.encoder.patch_embeddings.{i}."
        x = _conv(x, w, e + "proj", rounding, stride=s, padding=k // 2)
        h, wd = x.shape[2], x.shape[3]
        t = _layer_norm(_tokens(x), w, e + "layer_norm")
        for j in range(depth):
            b = f"segformer.encoder.block.{i}.{j}."
            t = t + _attention(_layer_norm(t, w, b + "layer_norm_1"), w, b,
                               h, wd, heads, r, rounding)
            t = t + _mix_ffn(_layer_norm(t, w, b + "layer_norm_2"), w, b,
                             h, wd, rounding)
        t = _layer_norm(t, w, f"segformer.encoder.layer_norm.{i}")
        x = _map(t, h, wd)
        feats.append(x)
    return feats


def decoder(w: Dict[str, torch.Tensor], feats, rounding: Rounding = identity
            ) -> torch.Tensor:
    """The four maps -> (B, classes, h, w) logits at OS-4."""
    target = feats[0].shape[2:]
    levels = []
    for i, feat in enumerate(feats):
        y = _linear(_tokens(feat), w, f"decode_head.linear_c.{i}.proj",
                    rounding)
        y = _map(y, feat.shape[2], feat.shape[3])
        levels.append(F.interpolate(y, size=target, mode="bilinear",
                                    align_corners=False))
    y = _conv(torch.cat(levels[::-1], dim=1), w,
              "decode_head.linear_fuse", rounding)
    bn = "decode_head.batch_norm."
    y = ((y - w[bn + "running_mean"].view(1, -1, 1, 1))
         * torch.rsqrt(w[bn + "running_var"].view(1, -1, 1, 1) + BN_EPS)
         * w[bn + "weight"].view(1, -1, 1, 1)
         + w[bn + "bias"].view(1, -1, 1, 1))
    return _conv(torch.relu(y), w, "decode_head.classifier", rounding)


def normalise(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) float32, /255 then ImageNet's
    mean and std."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def logits(w: Dict[str, torch.Tensor], images_u8: torch.Tensor, cfg: dict,
           *, out_size=None, rounding: Rounding = identity) -> torch.Tensor:
    """(B, H, W, 3) uint8 images -> (B, out_H, out_W, classes) float32
    logits, resized to ``out_size`` (default: the input size)."""
    if out_size is None:
        out_size = tuple(images_u8.shape[1:3])
    feats = encoder(w, normalise(images_u8), cfg["hf_config"], rounding)
    y = decoder(w, feats, rounding)
    del feats
    y = F.interpolate(y, size=tuple(out_size), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def served_gaps(w: Dict[str, torch.Tensor], images_u8: torch.Tensor,
                masks: torch.Tensor, cfg: dict, *,
                rounding: Rounding = identity,
                block: int = 1) -> torch.Tensor:
    """``vitseg.mask_gap`` of served uint8 masks against the reference's
    logits of the uint8 images they were served for, in blocks of
    ``block`` images: (B,) float32."""
    out = []
    with torch.no_grad(), no_tf32():
        for s in range(0, images_u8.shape[0], block):
            ref = logits(w, images_u8[s:s + block], cfg,
                         out_size=tuple(masks.shape[1:3]), rounding=rounding)
            out.append(mask_gap(ref, masks[s:s + block]))
            del ref
    return torch.cat(out)


def control_masks(w: Dict[str, torch.Tensor], images_u8: torch.Tensor,
                  cfg: dict, out_size, rounding: Rounding,
                  block: int = 1) -> torch.Tensor:
    """The masks the reference serves when computed with ``rounding``: the
    control, put in the program's place."""
    out = []
    with torch.no_grad(), no_tf32():
        for s in range(0, images_u8.shape[0], block):
            out.append(torch.argmax(logits(
                w, images_u8[s:s + block], cfg, out_size=out_size,
                rounding=rounding), dim=-1).to(torch.uint8))
    return torch.cat(out)
