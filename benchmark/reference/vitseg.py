"""Plain PyTorch reference of the ViT segmentation model, in float32.

What it computes, from the configuration's file and the benchmark's
weights (``benchmark/weights.py`` names), with nothing of the program:

- images (B, H, W, 3) in [0, 1] -> patches (row, column, channel order in a
  patch) -> patch embedding -> CLS token and position embeddings;
- pre-LN encoder blocks: LayerNorm (eps from the config), one fused QKV
  product whose columns are (q | k | v) x heads x head size, softmax
  attention with the scale 1/sqrt(head size), the output projection, the
  residual; LayerNorm, the exact-erf GELU MLP, the residual;
- the final LayerNorm, CLS dropped, the tokens folded to the grid, a 3x3
  convolution with SAME padding, ReLU, a 1x1 convolution (HWIO kernels);
- bilinear upsampling (half-pixel centres, align_corners=False) of the
  grid logits to the output size, as two products with interpolation
  matrices.

Every product takes its operands through ``rounding``: the identity for
the float32 reference, a coarser type for the control (``fp8_e4m3``). The
caller turns TF32 off (``no_tf32``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

Rounding = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude maps to 448, the type's largest), back in float32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


def operand(x: torch.Tensor, rounding: Rounding) -> torch.Tensor:
    return x if rounding is identity else rounding(x)


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def bilinear_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) float32 weights of a half-pixel bilinear resize: source
    coordinate (i + 0.5) * in / out - 0.5 in float64, clipped to the
    image, split between its two neighbours."""
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * (
        in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = (src - lo).astype(np.float32)
    mat = np.zeros((out_size, in_size), np.float32)
    mat[np.arange(out_size), lo] += 1.0 - w_hi
    mat[np.arange(out_size), hi] += w_hi
    return mat


def upsample(x: torch.Tensor, size) -> torch.Tensor:
    """(B, h, w, C) -> (B, H, W, C) bilinear, float32."""
    wh = torch.from_numpy(bilinear_matrix(size[0], x.shape[1])).to(x.device)
    ww = torch.from_numpy(bilinear_matrix(size[1], x.shape[2])).to(x.device)
    x = torch.einsum("Hh,bhwc->bHwc", wh, x.float())
    return torch.einsum("Ww,bHwc->bHWc", ww, x)


def _mm(a, b, rounding):
    return torch.matmul(operand(a, rounding), operand(b, rounding))


def _layer_norm(x, scale, bias, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _attention(q, k, v, rounding):
    scale = 1.0 / math.sqrt(q.shape[-1])
    probs = torch.softmax(_mm(q, k.transpose(-1, -2), rounding) * scale,
                          dim=-1)
    return _mm(probs, v, rounding)


def grid_logits(w: Dict[str, torch.Tensor], images: torch.Tensor,
                cfg: dict, *, rounding: Rounding = identity) -> torch.Tensor:
    """(B, H, W, 3) float32 images in [0, 1] -> (B, g, g, classes) float32
    grid logits. ``w``: float32 leaves by name."""
    b = images.shape[0]
    p, d = cfg["patch_size"], cfg["hidden_size"]
    heads, eps = cfg["num_attention_heads"], cfg["layer_norm_eps"]
    g = cfg["image_size"] // p
    x = images.reshape(b, g, p, g, p, -1).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, g * g, -1)
    x = (_mm(x, w["backbone.patch_embed.kernel"], rounding)
         + w["backbone.patch_embed.bias"])
    x = torch.cat([w["backbone.cls_token"].expand(b, -1, -1), x], dim=1)
    x = x + w["backbone.pos_embed"]
    n = x.shape[1]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"backbone.layers.{i}."
        y = _layer_norm(x, w[pre + "ln1.scale"], w[pre + "ln1.bias"], eps)
        qkv = _mm(y, w[pre + "qkv.kernel"], rounding) + w[pre + "qkv.bias"]
        qkv = qkv.reshape(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        a = _attention(qkv[0], qkv[1], qkv[2], rounding)
        a = a.transpose(1, 2).reshape(b, n, d)
        a = _mm(a, w[pre + "attn_out.kernel"], rounding) + w[
            pre + "attn_out.bias"]
        x = x + a
        y = _layer_norm(x, w[pre + "ln2.scale"], w[pre + "ln2.bias"], eps)
        y = F.gelu(_mm(y, w[pre + "mlp_in.kernel"], rounding)
                   + w[pre + "mlp_in.bias"], approximate="none")
        y = _mm(y, w[pre + "mlp_out.kernel"], rounding) + w[
            pre + "mlp_out.bias"]
        x = x + y
    x = _layer_norm(x, w["backbone.final_ln.scale"],
                    w["backbone.final_ln.bias"], eps)
    feats = x[:, 1:, :].reshape(b, g, g, d).permute(0, 3, 1, 2)
    k1 = w["head_conv1.kernel"].permute(3, 2, 0, 1)      # HWIO -> OIHW
    y = F.conv2d(operand(feats, rounding), operand(k1, rounding), padding=1)
    y = torch.relu(y + w["head_conv1.bias"].view(1, -1, 1, 1))
    k2 = w["head_conv2.kernel"].permute(3, 2, 0, 1)
    y = F.conv2d(operand(y, rounding), operand(k2, rounding))
    y = y + w["head_conv2.bias"].view(1, -1, 1, 1)
    return y.permute(0, 2, 3, 1)


def logits(w: Dict[str, torch.Tensor], images: torch.Tensor, cfg: dict,
           *, out_size=None, rounding: Rounding = identity) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] -> (B, out_H, out_W, classes)
    float32 logits, upsampled to ``out_size`` (default: the input size)."""
    if out_size is None:
        out_size = (images.shape[1], images.shape[2])
    return upsample(grid_logits(w, images, cfg, rounding=rounding),
                    out_size)


def as_float32(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in weights.items()}


def mask_gap(ref_logits: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Per image, the widest gap by which the logit of a served class lies
    below the reference's best at that pixel: (B,) float32. 0 where every
    served class is the reference's argmax."""
    best = ref_logits.amax(dim=-1)
    served = torch.gather(ref_logits, -1, masks.long().unsqueeze(-1))[..., 0]
    return (best - served).flatten(1).amax(dim=1)


def served_gaps(w: Dict[str, torch.Tensor], images_u8: torch.Tensor,
                masks: torch.Tensor, cfg: dict, *,
                rounding: Rounding = identity,
                block: int = 8) -> torch.Tensor:
    """mask_gap of served uint8 masks against the reference's logits of
    the uint8 images they were served for, in blocks of ``block`` images
    so that the reference fits beside nothing else: (B,) float32."""
    out = []
    with torch.no_grad(), no_tf32():
        for s in range(0, images_u8.shape[0], block):
            x = images_u8[s:s + block].float() / 255.0
            ref = logits(w, x, cfg, out_size=tuple(masks.shape[1:3]))
            out.append(mask_gap(ref, masks[s:s + block]))
            del ref
    return torch.cat(out)


def control_masks(w: Dict[str, torch.Tensor], images_u8: torch.Tensor,
                  cfg: dict, out_size, rounding: Rounding,
                  block: int = 8) -> torch.Tensor:
    """The masks the reference serves when computed with ``rounding``: the
    control, put in the program's place."""
    out = []
    with torch.no_grad(), no_tf32():
        for s in range(0, images_u8.shape[0], block):
            x = images_u8[s:s + block].float() / 255.0
            out.append(torch.argmax(logits(w, x, cfg, out_size=out_size,
                                           rounding=rounding), dim=-1)
                       .to(torch.uint8))
    return torch.cat(out)
