"""Segment Anything (SAM; Kirillov et al., arXiv:2304.02643) with one box
prompt and one mask an image: the forward of facebook/segment-anything's
``modeling/`` (``image_encoder.py``, ``prompt_encoder.py``,
``mask_decoder.py``, ``transformer.py``) under the parameter names of HF's
``SamModel``, so that the state dict of an HF ``save_pretrained`` directory
loads as it is (``ckpt/hf_dir.py:read_hf_sam``). No model of the TPU
package corresponds; the family serves, it is not trained.

- Image encoder: ImageNet's mean and std on the [0, 1] images (SAM's pixel
  mean and std over 255), the 16 x 16 patch embedding as one product of the
  patchified image, the learned absolute position embedding on the g x g
  grid, then pre-LN blocks (LayerNorm eps 1e-6, qkv with a bias,
  exact-erf GELU MLP). Windowed blocks zero-pad the normed grid to a
  multiple of the window (64 -> 70 at 1024^2), cut it into windows of 14 x
  14 tokens whose padded tokens are keys like the others, run qkv,
  attention and the output product a window, then un-partition and crop;
  the blocks of ``global_attn_indexes`` attend over the whole grid. Every
  block adds the decomposed relative-position bias to its logits: rel_h =
  einsum(q, Rh) and rel_w = einsum(q, Rw) with q unscaled, Rh and Rw
  gathered from ``rel_pos_h`` and ``rel_pos_w`` ((2S - 1, head dim) tables)
  at q - k + S - 1, and key (kr, kc) of query i adding rel_h[i, kr] +
  rel_w[i, kc]. The neck: a bias-free 1x1 conv onto 256, LayerNorm over the
  channels, a bias-free 3x3 conv, LayerNorm.
- Prompt encoder (boxes only, no mask input): the box's corners shifted
  half a pixel and divided by the image side, 2c - 1, times the (2, 128)
  Gaussian matrix, times 2 pi, [sin, cos]; corner j adds ``point_embed[2 +
  j]``; ``no_mask_embed`` is broadcast over the grid as the dense
  embedding. The image-wide positional encoding is the same encoding of the
  grid's cell centres.
- Mask decoder: the two-way transformer (depth 2, 8 heads, ReLU MLP of
  2048; cross-attention at half width), its tokens the IoU token, the four
  mask tokens and the two corners; the two transposed convs (x4 in all)
  with LayerNorm and exact GELU; mask token 0's hypernetwork MLP (ReLU)
  against the upscaled embedding gives the single mask's logits at 4g x 4g
  (``multimask_output=False``); the IoU head, which the mask does not
  depend on, is held but not run.
- Output: the logits resized bilinearly (half-pixel) to the image, and the
  mask is logit > 0. The served masks (``SamMasks``) take both steps in the
  epilogue kernel (``ops/upsample_argmax.py``, kernel 5) on the two-class
  logits (0, m), whose argmax, the first index winning a tie, is m > 0.

The decoder's LayerNorms take HF's eps (``decoder_layer_norm_eps``, 1e-6;
the final one 1e-5), where SAM's own code builds each with torch's 1e-5.

Arithmetic: parameters in fp32, every product in the compute dtype; the
residual adds and LayerNorms through kernel 10 (``add_layer_norm``: the
output product's bias, the residual and ``layer_norm2`` after the
un-partition; the MLP's and the next block's ``layer_norm1``), the linears
through ``nn/layers.py:linear``; the Fourier encodings, the resize of the
logits and the threshold in fp32 (the served masks: kernel 5's fp32
taps). The attention core goes through
``ops/attention.py:biased_attention_path``: with no gradient to take, on a
CUDA tensor in bfloat16 at head dim 64 or 80, kernel 1's bias instantiation
(``ops/flash_attention.py:flash_attention_bias``), which never writes the
N x Nk logits; otherwise its plain version, the bias and the logits
materialised in fp32.
The decoder's attention runs ``multi_head_attention`` ("auto": kernel 1 on
a CUDA tensor, Nk != Nq, head dims 16 and 32).

Spans (``utils/spans.py``): the ranges ``sam.embed``, ``sam.relpos`` (the
rel_h and rel_w products), ``sam.attention.window`` and
``sam.attention.global`` (the attention core alone: q, k, v and the bias
in, its output out), ``sam.neck``, ``sam.prompt``, ``sam.decoder`` and
``sam.postprocess``; the counters ``sam.attention_flash`` and
``sam.attention_eager``, one a call of the core by the path it took.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from visiontransformer_tpu_torch.nn.layers import (
    gelu_exact,
    layer_norm,
    linear,
)
from visiontransformer_tpu_torch.ops.attention import (
    biased_attention_path,
    multi_head_attention,
)
from visiontransformer_tpu_torch.ops.flash_attention import (
    flash_attention_bias,
    flash_attention_bias_plain,
)
from visiontransformer_tpu_torch.ops.layer_norm import add_layer_norm
from visiontransformer_tpu_torch.ops.upsample_argmax import upsample_argmax
from visiontransformer_tpu_torch.utils.spans import count, ranged

# HF's SamVisionConfig geometry of the published checkpoints: width, depth,
# heads and the blocks that attend globally (the others take 14 x 14
# windows); each at 1024^2 with 16 x 16 patches and a 256-wide neck.
SAM_PRESETS = {
    "sam_vit_b": (768, 12, 12, (2, 5, 8, 11)),
    "sam_vit_l": (1024, 24, 16, (5, 11, 17, 23)),
    "sam_vit_h": (1280, 32, 16, (7, 15, 23, 31)),
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FINAL_LN_EPS = 1e-5  # HF's layer_norm_final_attn: torch's default


@dataclasses.dataclass(frozen=True)
class SamConfig:
    """SAM's geometry (HF ``SamConfig``'s keys, flattened)."""
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    mlp_dim: int = 3072
    window_size: int = 14
    image_size: int = 1024
    patch_size: int = 16
    output_channels: int = 256  # the neck, the prompts and the decoder
    num_pos_feats: int = 128
    layer_norm_eps: float = 1e-6
    decoder_layers: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_mask_tokens: int = 4
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    decoder_layer_norm_eps: float = 1e-6
    # Background and the prompted object: the served masks are {0, 1}.
    num_classes: int = 2
    compute_dtype: str = "float32"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def sam_config(name: str, *, input_size: int = 1024,
               compute_dtype: str = "bfloat16") -> SamConfig:
    """A preset's config at ``input_size`` (a multiple of the patch)."""
    if name not in SAM_PRESETS:
        raise KeyError(f"unknown SAM preset {name!r}; known: "
                       f"{sorted(SAM_PRESETS)}")
    if input_size % 16:
        raise ValueError(f"input_size {input_size} is not divisible by "
                         f"SAM's patch size 16")
    hidden, depth, heads, global_idx = SAM_PRESETS[name]
    return SamConfig(hidden_size=hidden, num_hidden_layers=depth,
                     num_attention_heads=heads,
                     global_attn_indexes=global_idx, mlp_dim=4 * hidden,
                     image_size=input_size, compute_dtype=compute_dtype)


# ------------------------------------------------------------------ modules
# Parameter holders under HF's names; the forward is the functions below.
class _Linear(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))  # (out, in)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight.t(), self.bias)

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The product without the bias (``add_layer_norm`` adds it)."""
        return linear(x, self.weight.t())


class _Norm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, eps=self.eps)

    def add(self, x: torch.Tensor, t: torch.Tensor,
            b: Optional[torch.Tensor]):
        """(s, norm(s)), s = x + (t + b): one launch of kernel 10."""
        return add_layer_norm(x, t, b, self.weight, self.bias, eps=self.eps)


class _Weight(nn.Module):
    """An embedding table or a conv kernel under HF's ``weight``."""

    def __init__(self, *shape: int, bias: Optional[int] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(*shape))
        if bias is not None:
            self.bias = nn.Parameter(torch.zeros(bias))


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1, self.lin2 = _Linear(dim, hidden), _Linear(hidden, dim)


class _VisionAttention(nn.Module):
    def __init__(self, cfg: SamConfig, size: int):
        super().__init__()
        c = cfg.hidden_size
        self.qkv, self.proj = _Linear(c, 3 * c), _Linear(c, c)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, cfg.head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, cfg.head_dim))


class _VisionLayer(nn.Module):
    def __init__(self, cfg: SamConfig, window: int):
        super().__init__()
        c = cfg.hidden_size
        self.window_size = window  # 0: global
        self.layer_norm1 = _Norm(c, cfg.layer_norm_eps)
        self.attn = _VisionAttention(cfg, window or cfg.grid)
        self.layer_norm2 = _Norm(c, cfg.layer_norm_eps)
        self.mlp = _MLP(c, cfg.mlp_dim)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        p = cfg.patch_size
        self.projection = _Weight(cfg.hidden_size, 3, p, p,
                                  bias=cfg.hidden_size)


class _Neck(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        c, o = cfg.hidden_size, cfg.output_channels
        self.conv1 = _Weight(o, c, 1, 1)
        self.layer_norm1 = _Norm(o, 1e-6)
        self.conv2 = _Weight(o, o, 3, 3)
        self.layer_norm2 = _Norm(o, 1e-6)


class _VisionEncoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        g = cfg.grid
        self.patch_embed = _PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, cfg.hidden_size))
        self.layers = nn.ModuleList(
            _VisionLayer(cfg, 0 if i in cfg.global_attn_indexes
                         else cfg.window_size)
            for i in range(cfg.num_hidden_layers))
        self.neck = _Neck(cfg)


class _PositionalEmbedding(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.register_buffer("positional_embedding",
                             torch.zeros(2, cfg.num_pos_feats))


class _PromptEncoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        o = cfg.output_channels
        self.no_mask_embed = _Weight(1, o)
        # 0 and 1: point labels (not served); 2 and 3: a box's corners.
        self.point_embed = nn.ModuleList(_Weight(1, o) for _ in range(4))


class _DecoderAttention(nn.Module):
    def __init__(self, cfg: SamConfig, downsample: int):
        super().__init__()
        c = cfg.output_channels
        inner = c // downsample
        self.heads = cfg.decoder_heads
        self.q_proj, self.k_proj = _Linear(c, inner), _Linear(c, inner)
        self.v_proj, self.out_proj = _Linear(c, inner), _Linear(inner, c)


class _TwoWayBlock(nn.Module):
    def __init__(self, cfg: SamConfig, skip_first_layer_pe: bool):
        super().__init__()
        c, eps, rate = (cfg.output_channels, cfg.decoder_layer_norm_eps,
                        cfg.attention_downsample_rate)
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = _DecoderAttention(cfg, 1)
        self.layer_norm1 = _Norm(c, eps)
        self.cross_attn_token_to_image = _DecoderAttention(cfg, rate)
        self.layer_norm2 = _Norm(c, eps)
        self.mlp = _MLP(c, cfg.decoder_mlp_dim)
        self.layer_norm3 = _Norm(c, eps)
        self.layer_norm4 = _Norm(c, eps)
        self.cross_attn_image_to_token = _DecoderAttention(cfg, rate)


class _TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.layers = nn.ModuleList(_TwoWayBlock(cfg, i == 0)
                                    for i in range(cfg.decoder_layers))
        self.final_attn_token_to_image = _DecoderAttention(
            cfg, cfg.attention_downsample_rate)
        self.layer_norm_final_attn = _Norm(cfg.output_channels, FINAL_LN_EPS)


class _FeedForward(nn.Module):
    def __init__(self, cin: int, hidden: int, cout: int, depth: int):
        super().__init__()
        self.proj_in = _Linear(cin, hidden)
        self.layers = nn.ModuleList(_Linear(hidden, hidden)
                                    for _ in range(depth - 2))
        self.proj_out = _Linear(hidden, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.proj_in(x))
        for layer in self.layers:
            x = torch.relu(layer(x))
        return self.proj_out(x)


class _MaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        c, n = cfg.output_channels, cfg.num_mask_tokens
        self.iou_token = _Weight(1, c)
        self.mask_tokens = _Weight(n, c)
        self.transformer = _TwoWayTransformer(cfg)
        self.upscale_conv1 = _Weight(c, c // 4, 2, 2, bias=c // 4)
        self.upscale_conv2 = _Weight(c // 4, c // 8, 2, 2, bias=c // 8)
        self.upscale_layer_norm = _Norm(c // 4, 1e-6)
        self.output_hypernetworks_mlps = nn.ModuleList(
            _FeedForward(c, c, c // 8, 3) for _ in range(n))
        self.iou_prediction_head = _FeedForward(
            c, cfg.iou_head_hidden_dim, n, cfg.iou_head_depth)


class SamSeg(nn.Module):
    """SAM's parameters under HF ``SamModel``'s names (those a box prompt
    and a single mask use, the IoU head and the other mask tokens'
    hypernetworks with them); called, ``sam_apply``; ``SamMasks`` serves
    it."""

    family = "sam"

    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        self.shared_image_embedding = _PositionalEmbedding(cfg)
        self.vision_encoder = _VisionEncoder(cfg)
        self.prompt_encoder = _PromptEncoder(cfg)
        self.mask_decoder = _MaskDecoder(cfg)

    def forward(self, images: torch.Tensor,
                boxes: Optional[torch.Tensor] = None) -> torch.Tensor:
        return sam_apply(self, images, boxes)


def sam_init(generator: torch.Generator, cfg: SamConfig) -> SamSeg:
    """Random weights: trunc-normal(0.02) kernels, tables and embeddings
    (the relative-position tables too, where HF starts them at zero, so
    that a random model runs every path), zero biases, unit LayerNorm
    scales, a standard-normal Fourier matrix (SAM's scale 1)."""
    model = SamSeg(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".layer_norm" in name or "upscale_layer_norm" in name:
                p.fill_(1.0)
            else:
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)
        model.shared_image_embedding.positional_embedding.copy_(torch.randn(
            2, cfg.num_pos_feats, generator=generator))
    return model


# ----------------------------------------------------------------- forward
def _cached(fn):
    """``fn`` cached by its arguments, but while ``torch.export`` traces: a
    tensor made there belongs to the traced program and must not be kept
    for later calls."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def call(*args):
        return fn(*args) if torch.compiler.is_exporting() else cached(*args)
    return call


# Constant tensors on a device, made once: a tensor made from host values
# at each call would copy to the card and wait for it.
@_cached
def _on_device(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _normalize(images: torch.Tensor) -> torch.Tensor:
    mean = _on_device(IMAGENET_MEAN, images.device)
    std = _on_device(IMAGENET_STD, images.device)
    return (images.float() - mean) / std


@_cached
def _rel_index(size: int, device: torch.device) -> torch.Tensor:
    """(size, size) indexes q - k + size - 1 into a (2 size - 1, d) table."""
    r = torch.arange(size, device=device)
    return r[:, None] - r[None, :] + size - 1


def decomposed_rel_pos(q: torch.Tensor, rel_pos_h: torch.Tensor,
                       rel_pos_w: torch.Tensor, h: int, w: int):
    """(rel_h (B, H, h·w, h), rel_w (B, H, h·w, w)) of unscaled q (B, H,
    h·w, d): one batched product each, in q's dtype."""
    b, heads, _, d = q.shape
    rh = rel_pos_h.to(q.dtype)[_rel_index(h, q.device)]  # (h, h, d)
    rw = rel_pos_w.to(q.dtype)[_rel_index(w, q.device)]  # (w, w, d)
    grid = q.reshape(b, heads, h, w, d)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", grid, rh)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", grid, rw)
    return rel_h.reshape(b, heads, h * w, h), rel_w.reshape(b, heads, h * w, w)


def _attention_core(q, k, v, rel_h, rel_w, attn_impl: str) -> torch.Tensor:
    """Kernel 1's bias instantiation where ``biased_attention_path`` takes
    it, its plain version (the bias and logits materialised in fp32)
    otherwise."""
    if biased_attention_path(attn_impl, q, k, rel_h, rel_w) == "flash":
        count("sam.attention_flash")
        return flash_attention_bias(q, k, v, rel_h, rel_w)
    count("sam.attention_eager")
    return flash_attention_bias_plain(q, k, v, rel_h, rel_w)


def _vision_attention(attn: _VisionAttention, tokens: torch.Tensor, h: int,
                      w: int, heads: int, range_name: str,
                      attn_impl: str) -> torch.Tensor:
    """(n, h·w, C) tokens -> the attention's output (n, h·w, C) before the
    output product."""
    n, hw, c = tokens.shape
    qkv = attn.qkv(tokens).view(n, hw, 3, heads, c // heads).permute(
        2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    with ranged("sam.relpos"):
        rel_h, rel_w = decomposed_rel_pos(q, attn.rel_pos_h, attn.rel_pos_w,
                                          h, w)
    with ranged(range_name):
        out = _attention_core(q, k, v, rel_h, rel_w, attn_impl)
    return out.transpose(1, 2).reshape(n, hw, c)


def _block_attention(layer: _VisionLayer, y: torch.Tensor, cfg: SamConfig,
                     attn_impl: str) -> torch.Tensor:
    """layer_norm1(x) (B, g, g, C) -> the output product without its bias,
    (B, g, g, C): windows zero-padded, partitioned, attended and put back
    (cropped), or the whole grid."""
    b, g, _, c = y.shape
    heads, s = cfg.num_attention_heads, layer.window_size
    attn = layer.attn
    if not s:
        out = _vision_attention(attn, y.reshape(b, g * g, c), g, g, heads,
                                "sam.attention.global", attn_impl)
        return attn.proj.product(out).view(b, g, g, c)
    pad = (-g) % s
    if pad:
        y = F.pad(y, (0, 0, 0, pad, 0, pad))
    gp, nw = g + pad, (g + pad) // s
    windows = y.view(b, nw, s, nw, s, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b * nw * nw, s * s, c)
    out = _vision_attention(attn, windows, s, s, heads,
                            "sam.attention.window", attn_impl)
    t = attn.proj.product(out).view(b, nw, nw, s, s, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, gp, gp, c)
    return t[:, :g, :g].contiguous()


def sam_image_embeddings(model: SamSeg, images: torch.Tensor, *,
                         attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] -> the neck's (B, g, g, 256)
    embedding, NHWC, in the compute dtype."""
    cfg, enc = model.cfg, model.vision_encoder
    dt, p, g, c = cfg.dtype, cfg.patch_size, cfg.grid, cfg.hidden_size
    b = images.shape[0]
    with ranged("sam.embed"):
        x = _normalize(images).to(dt)
        patches = x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4)
        proj = enc.patch_embed.projection
        x = linear(patches.reshape(b, g, g, 3 * p * p),
                   proj.weight.reshape(c, -1).t(), proj.bias)
        x = x + enc.pos_embed.to(dt)
    layers = enc.layers
    y = layers[0].layer_norm1(x)
    for i, layer in enumerate(layers):
        t = _block_attention(layer, y, cfg, attn_impl)
        x, y = layer.layer_norm2.add(x, t, layer.attn.proj.bias)
        h = gelu_exact(layer.mlp.lin1(y))
        t = layer.mlp.lin2.product(h)
        if i + 1 < len(layers):
            x, y = layers[i + 1].layer_norm1.add(x, t, layer.mlp.lin2.bias)
        else:
            x = x + (t + layer.mlp.lin2.bias.to(t.dtype))
    neck = enc.neck
    with ranged("sam.neck"):
        o = cfg.output_channels
        y = neck.layer_norm1(linear(x, neck.conv1.weight.view(o, c).t()))
        y = F.conv2d(y.permute(0, 3, 1, 2), neck.conv2.weight.to(dt),
                     padding=1).permute(0, 2, 3, 1)
        return neck.layer_norm2(y)


def _fourier(model: SamSeg, coords: torch.Tensor) -> torch.Tensor:
    """[0, 1]^2 coordinates (..., 2) -> (..., 2 · num_pos_feats) fp32:
    [sin, cos] of 2π (2c - 1) G."""
    g = model.shared_image_embedding.positional_embedding.float()
    x = 2.0 * math.pi * ((2.0 * coords.float() - 1.0) @ g)
    return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


def image_positional_encoding(model: SamSeg, device) -> torch.Tensor:
    """(g·g, 256) fp32: the encoding of each grid cell's centre, row-major
    over (y, x)."""
    g = model.cfg.grid
    centres = (torch.arange(g, device=device, dtype=torch.float32) + 0.5) / g
    ys, xs = torch.meshgrid(centres, centres, indexing="ij")
    return _fourier(model, torch.stack([xs, ys], dim=-1)).reshape(g * g, -1)


def whole_image_boxes(n: int, size: int, device) -> torch.Tensor:
    """(n, 4) boxes (x0, y0, x1, y1) covering a size x size image."""
    return _on_device((0.0, 0.0, float(size), float(size)),
                      torch.device(device)).expand(n, 4)


def sam_prompt(model: SamSeg, boxes: torch.Tensor) -> torch.Tensor:
    """(B, 4) boxes (x0, y0, x1, y1) in input pixels -> the two corner
    tokens, (B, 2, 256) fp32."""
    pe = model.prompt_encoder
    coords = (boxes.float() + 0.5).view(-1, 2, 2) / model.cfg.image_size
    corners = torch.cat([pe.point_embed[2].weight, pe.point_embed[3].weight])
    return _fourier(model, coords) + corners


def _decoder_attention(attn: _DecoderAttention, q: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor,
                       attn_impl: str) -> torch.Tensor:
    """(B, Nq, 256) queries against (B, Nk, 256) keys and values -> the
    output product without its bias, (B, Nq, 256)."""
    b, nq, _ = q.shape
    nk = k.shape[1]
    q, k, v = attn.q_proj(q), attn.k_proj(k), attn.v_proj(v)
    inner = q.shape[-1]
    hd = inner // attn.heads
    q = q.view(b, nq, attn.heads, hd).transpose(1, 2)
    k = k.view(b, nk, attn.heads, hd).transpose(1, 2)
    v = v.view(b, nk, attn.heads, hd).transpose(1, 2)
    out = multi_head_attention(q, k, v, implementation=attn_impl)
    return attn.out_proj.product(out.transpose(1, 2).reshape(b, nq, inner))


def _two_way(model: SamSeg, tokens: torch.Tensor, keys: torch.Tensor,
             key_pe: torch.Tensor, attn_impl: str):
    """HF's ``SamTwoWayTransformer``: (queries, keys) after the blocks and
    the final token-to-image attention."""
    tw = model.mask_decoder.transformer
    queries = tokens
    for layer in tw.layers:
        sa = layer.self_attn
        if layer.skip_first_layer_pe:
            t = _decoder_attention(sa, queries, queries, queries, attn_impl)
            queries = layer.layer_norm1(t + sa.out_proj.bias.to(t.dtype))
        else:
            q = queries + tokens
            t = _decoder_attention(sa, q, q, queries, attn_impl)
            queries = layer.layer_norm1.add(queries, t, sa.out_proj.bias)[1]
        ca = layer.cross_attn_token_to_image
        t = _decoder_attention(ca, queries + tokens, keys + key_pe, keys,
                               attn_impl)
        queries = layer.layer_norm2.add(queries, t, ca.out_proj.bias)[1]
        t = layer.mlp.lin2.product(torch.relu(layer.mlp.lin1(queries)))
        queries = layer.layer_norm3.add(queries, t, layer.mlp.lin2.bias)[1]
        ia = layer.cross_attn_image_to_token
        t = _decoder_attention(ia, keys + key_pe, queries + tokens, queries,
                               attn_impl)
        keys = layer.layer_norm4.add(keys, t, ia.out_proj.bias)[1]
    fa = tw.final_attn_token_to_image
    t = _decoder_attention(fa, queries + tokens, keys + key_pe, keys,
                           attn_impl)
    queries = tw.layer_norm_final_attn.add(queries, t, fa.out_proj.bias)[1]
    return queries, keys


def _upscale_norm(norm: _Norm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channels of an NCHW map."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def sam_mask_logits(model: SamSeg, images: torch.Tensor,
                    boxes: torch.Tensor, *,
                    attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] and (B, 4) boxes in their pixels ->
    the single mask's logits at 4g x 4g, (B, 4g, 4g) in the compute
    dtype."""
    cfg, dec = model.cfg, model.mask_decoder
    dt, g, o = cfg.dtype, cfg.grid, cfg.output_channels
    emb = sam_image_embeddings(model, images, attn_impl=attn_impl)
    b = emb.shape[0]
    with ranged("sam.prompt"):
        sparse = sam_prompt(model, boxes).to(dt)
        dense = model.prompt_encoder.no_mask_embed.weight.to(dt)
        key_pe = image_positional_encoding(model, emb.device).to(dt)
    with ranged("sam.decoder"):
        out_tokens = torch.cat([dec.iou_token.weight, dec.mask_tokens.weight])
        tokens = torch.cat([out_tokens.to(dt).expand(b, -1, -1), sparse],
                           dim=1)
        keys = (emb + dense).reshape(b, g * g, o)
        queries, keys = _two_way(model, tokens, keys, key_pe, attn_impl)
        y = keys.view(b, g, g, o).permute(0, 3, 1, 2)
        c1, c2 = dec.upscale_conv1, dec.upscale_conv2
        y = F.conv_transpose2d(y, c1.weight.to(dt), c1.bias.to(dt), stride=2)
        y = gelu_exact(_upscale_norm(dec.upscale_layer_norm, y))
        y = gelu_exact(F.conv_transpose2d(y, c2.weight.to(dt), c2.bias.to(dt),
                                          stride=2))
        hyper = dec.output_hypernetworks_mlps[0](queries[:, 1])  # (B, o/8)
        side = y.shape[-1]
        return torch.matmul(hyper.unsqueeze(1), y.reshape(b, o // 8, -1)
                            ).view(b, side, side)


def upscale_logits(logits: torch.Tensor, size: Tuple[int, int]
                   ) -> torch.Tensor:
    """(B, h, w) mask logits -> (B, H, W) fp32, bilinear (half-pixel)."""
    return F.interpolate(logits.float().unsqueeze(1), size=tuple(size),
                         mode="bilinear", align_corners=False)[:, 0]


def sam_apply(model: SamSeg, images: torch.Tensor,
              boxes: Optional[torch.Tensor] = None, *,
              attn_impl: str = "auto", **_) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] -> (B, H, W, 2) fp32 logits (0, m),
    m the mask's logit: the argmax is the mask. ``boxes`` None: the
    whole image."""
    b, h = images.shape[0], images.shape[1]
    if boxes is None:
        boxes = whole_image_boxes(b, h, images.device)
    m = upscale_logits(sam_mask_logits(model, images, boxes,
                                       attn_impl=attn_impl), images.shape[1:3])
    return torch.stack([torch.zeros_like(m), m], dim=-1)


class SamMasks(nn.Module):
    """SAM's masks forward for the runner and the exported program:
    (B, H, W, 3) images in [0, 1] and (B, 4) boxes (None: the whole image)
    -> (B, H, W) masks, 1 where the resized logit is above 0, in
    ``mask_dtype``: the epilogue kernel's argmax of the logits (0, m), as
    ``sam_apply`` gives them, resized. Eager (``cut`` False)."""

    cut = False
    prompted = True

    def __init__(self, model: SamSeg, mask_dtype: torch.dtype,
                 attn_impl: str = "auto"):
        super().__init__()
        self.model, self.mask_dtype, self.attn_impl = (model, mask_dtype,
                                                       attn_impl)

    def forward(self, images: torch.Tensor,
                boxes: Optional[torch.Tensor] = None) -> torch.Tensor:
        size = self.model.cfg.image_size
        if tuple(images.shape[1:3]) != (size, size):
            raise ValueError(f"SAM takes {size} x {size} images, got "
                             f"{tuple(images.shape[1:3])}")
        if boxes is None:
            boxes = whole_image_boxes(images.shape[0], size, images.device)
        logits = sam_mask_logits(self.model, images, boxes,
                                 attn_impl=self.attn_impl)
        with ranged("sam.postprocess"):
            two = torch.stack([torch.zeros_like(logits), logits], dim=-1)
            return upsample_argmax(two, (size, size),
                                   out_dtype=self.mask_dtype)
