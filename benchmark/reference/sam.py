"""Plain PyTorch reference of Segment Anything (SAM) with one box prompt and
a single mask, in float32.

What it computes, from the configuration's ``hf_config`` and the
benchmark's weights (``benchmark/weights_sam.py``, HF ``SamModel``'s
names), with nothing of the program, following facebook/segment-anything's
``modeling/`` (Kirillov et al., arXiv:2304.02643) function by function:

- ``image_encoder.py``: uint8 images / 255, normalised by SAM's pixel mean
  and std (ImageNet's, over 255), NCHW; the 16 x 16 stride-16 patch conv,
  NHWC, plus the absolute position embedding; each ``Block``: LayerNorm;
  for a windowed block ``window_partition`` (zero padding at the bottom and
  right to a multiple of the window, then windows); ``Attention``: the qkv
  linear, (q · scale) @ kᵀ, ``add_decomposed_rel_pos`` (``get_rel_pos``'s
  table rows q - k + S - 1, rel_h = einsum(q, Rh) and rel_w = einsum(q, Rw)
  with q unscaled, added as attn[i, kr, kc] += rel_h[i, kr] + rel_w[i,
  kc]), the softmax, @ v, the proj linear; ``window_unpartition`` (the
  crop); the residual; LayerNorm, the exact-erf GELU MLP, the residual;
  the neck (bias-free 1x1 conv, ``LayerNorm2d``, bias-free 3x3 conv padded
  1, ``LayerNorm2d``);
- ``prompt_encoder.py``: ``_embed_boxes`` (corners + 0.5 over the image
  side, ``PositionEmbeddingRandom``'s 2π (2c - 1) G encoding, [sin, cos],
  corner j adding ``point_embeddings[2 + j]``), the dense ``no_mask_embed``
  and ``get_dense_pe`` over the grid's cell centres;
- ``mask_decoder.py`` and ``transformer.py``: ``predict_masks`` (the IoU
  and mask tokens before the two corners, ``TwoWayTransformer`` with its
  ``TwoWayAttentionBlock``s and the final token-to-image attention, the
  output upscaling, the hypernetwork MLP of mask token 0) and
  ``multimask_output=False``'s first mask;
- ``sam.py``'s ``postprocess_masks``: the 4g x 4g logits resized
  bilinearly (half-pixel) to the image, the crop (none at the image's own
  size) and the resize to the original size (the same); the mask is
  logit > 0.

Departures from the published code, each on purpose:

- The parameters carry HF ``SamModel``'s names, and the mask decoder's
  LayerNorms take HF's eps (the configuration's ``layer_norm_eps``, 1e-6,
  and 1e-5 for the final one), where SAM's own ``TwoWayTransformer``
  builds each with torch's default 1e-5: the reference is held to HF's
  ``SamModel`` (``tests/test_torch_sam.py``).
- ``get_rel_pos`` resizes a table of another length than 2S - 1; the
  checkpoints' tables have that length at their own image size, so the
  resize is left out (another length raises).
- The IoU head, which the mask does not depend on, is not computed.
- Global attention is computed with its logits materialised, one image at
  a time; nothing is batched across images.

Every product (linears, convs, transposed convs, Q·Kᵀ, P·V and the
relative-position products) takes its operands through ``rounding``: the
identity for the float32 reference, a coarser type for the control
(``vitseg.fp8_e4m3``). ``served_gaps`` and ``control_masks`` turn TF32 off
(``no_tf32``) and compute a block of images at a time.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.vitseg import Rounding, identity, no_tf32, operand

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def _mm(a, b, rounding):
    return torch.matmul(operand(a, rounding), operand(b, rounding))


def _linear(x, w, name, rounding):
    return _mm(x, w[name + ".weight"].t(), rounding) + w[name + ".bias"]


def _layer_norm(x, w, name, eps):
    return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"],
                        w[name + ".bias"], eps=eps)


def _layer_norm_2d(x, w, name, eps=1e-6):
    """SAM's ``LayerNorm2d`` over the channels of an NCHW map."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return (w[name + ".weight"][:, None, None] * x
            + w[name + ".bias"][:, None, None])


# ------------------------------------------------------------ image encoder
def window_partition(x, window: int):
    b, h, wd, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - wd % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, wd + pad_w
    x = x.view(b, hp // window, window, wp // window, window, c)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(
        -1, window, window, c)
    return windows, (hp, wp)


def window_unpartition(windows, window: int, pad_hw, hw):
    hp, wp = pad_hw
    h, wd = hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.view(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
    return x[:, :h, :wd, :].contiguous()


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor):
    """(q_size, k_size, d) rows q - k + k_size - 1 of the table."""
    if rel_pos.shape[0] != 2 * max(q_size, k_size) - 1:
        raise ValueError(f"a relative-position table of {rel_pos.shape[0]} "
                         f"rows at size {q_size}: the resize is not "
                         f"reproduced")
    q = torch.arange(q_size, device=rel_pos.device)[:, None]
    k = torch.arange(k_size, device=rel_pos.device)[None, :]
    return rel_pos[(q - k) + (k_size - 1)]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size,
                           rounding):
    qh, qw = q_size
    kh, kw = k_size
    rh = get_rel_pos(qh, kh, rel_pos_h)
    rw = get_rel_pos(qw, kw, rel_pos_w)
    b, _, dim = q.shape
    r_q = operand(q.reshape(b, qh, qw, dim), rounding)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, operand(rh, rounding))
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, operand(rw, rounding))
    attn = (attn.view(b, qh, qw, kh, kw) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :])
    return attn.view(b, qh * qw, kh * kw)


def _attention(x, w, prefix, heads, rounding):
    """SAM's ``Attention`` on (B, H, W, C) tokens."""
    b, h, wd, _ = x.shape
    qkv = _linear(x, w, prefix + "qkv", rounding).reshape(
        b, h * wd, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, b * heads, h * wd, -1).unbind(0)
    scale = q.shape[-1] ** -0.5
    attn = _mm(q * scale, k.transpose(-2, -1), rounding)
    attn = add_decomposed_rel_pos(attn, q, w[prefix + "rel_pos_h"],
                                  w[prefix + "rel_pos_w"], (h, wd), (h, wd),
                                  rounding)
    attn = attn.softmax(dim=-1)
    x = _mm(attn, v, rounding).view(b, heads, h, wd, -1).permute(
        0, 2, 3, 1, 4).reshape(b, h, wd, -1)
    return _linear(x, w, prefix + "proj", rounding)


def image_encoder(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
                  rounding: Rounding = identity) -> torch.Tensor:
    """(B, 3, S, S) normalised images -> the neck's (B, 256, g, g)."""
    v = cfg["hf_config"]["vision_config"]
    eps, heads = v["layer_norm_eps"], v["num_attention_heads"]
    pre = "vision_encoder."
    x = F.conv2d(operand(x, rounding),
                 operand(w[pre + "patch_embed.projection.weight"], rounding),
                 w[pre + "patch_embed.projection.bias"],
                 stride=v["patch_size"]).permute(0, 2, 3, 1)
    x = x + w[pre + "pos_embed"]
    for i in range(v["num_hidden_layers"]):
        blk = f"{pre}layers.{i}."
        window = 0 if i in v["global_attn_indexes"] else v["window_size"]
        shortcut = x
        x = _layer_norm(x, w, blk + "layer_norm1", eps)
        if window:
            h, wd = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, window)
        x = _attention(x, w, blk + "attn.", heads, rounding)
        if window:
            x = window_unpartition(x, window, pad_hw, (h, wd))
        x = shortcut + x
        y = _layer_norm(x, w, blk + "layer_norm2", eps)
        y = F.gelu(_linear(y, w, blk + "mlp.lin1", rounding),
                   approximate="none")
        x = x + _linear(y, w, blk + "mlp.lin2", rounding)
    x = x.permute(0, 3, 1, 2)
    x = F.conv2d(operand(x, rounding),
                 operand(w[pre + "neck.conv1.weight"], rounding))
    x = _layer_norm_2d(x, w, pre + "neck.layer_norm1")
    x = F.conv2d(operand(x, rounding),
                 operand(w[pre + "neck.conv2.weight"], rounding), padding=1)
    return _layer_norm_2d(x, w, pre + "neck.layer_norm2")


# ----------------------------------------------------------- prompt encoder
def _pe_encoding(w, coords):
    """[0, 1]^2 coordinates (..., 2) -> (..., 2 · feats)."""
    coords = 2 * coords - 1
    coords = coords @ w["shared_image_embedding.positional_embedding"]
    coords = 2 * math.pi * coords
    return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


def embed_boxes(w, boxes: torch.Tensor, image_size: int) -> torch.Tensor:
    """(B, 4) boxes (x0, y0, x1, y1) in input pixels -> (B, 2, 256)."""
    boxes = boxes + 0.5
    coords = boxes.reshape(-1, 2, 2).clone()
    coords[:, :, 0] = coords[:, :, 0] / image_size
    coords[:, :, 1] = coords[:, :, 1] / image_size
    corner = _pe_encoding(w, coords)
    corner[:, 0, :] += w["prompt_encoder.point_embed.2.weight"][0]
    corner[:, 1, :] += w["prompt_encoder.point_embed.3.weight"][0]
    return corner


def dense_pe(w, g: int) -> torch.Tensor:
    """``get_dense_pe``: (1, 256, g, g)."""
    grid = torch.ones((g, g), device=w["prompt_encoder.no_mask_embed.weight"]
                      .device, dtype=torch.float32)
    y_embed = (grid.cumsum(dim=0) - 0.5) / g
    x_embed = (grid.cumsum(dim=1) - 0.5) / g
    pe = _pe_encoding(w, torch.stack([x_embed, y_embed], dim=-1))
    return pe.permute(2, 0, 1).unsqueeze(0)


# ------------------------------------------------------------- mask decoder
def _dec_attention(w, prefix, q, k, v, heads, rounding):
    """``transformer.py``'s ``Attention``."""
    q = _linear(q, w, prefix + "q_proj", rounding)
    k = _linear(k, w, prefix + "k_proj", rounding)
    v = _linear(v, w, prefix + "v_proj", rounding)

    def separate(x):
        b, n, c = x.shape
        return x.reshape(b, n, heads, c // heads).transpose(1, 2)

    q, k, v = separate(q), separate(k), separate(v)
    attn = _mm(q, k.permute(0, 1, 3, 2), rounding) / math.sqrt(q.shape[-1])
    out = _mm(torch.softmax(attn, dim=-1), v, rounding)
    b, _, n, _ = out.shape
    out = out.transpose(1, 2).reshape(b, n, -1)
    return _linear(out, w, prefix + "out_proj", rounding)


def two_way_transformer(w, image_embedding, image_pe, point_embedding, cfg,
                        rounding):
    m = cfg["hf_config"]["mask_decoder_config"]
    heads, eps = m["num_attention_heads"], m["layer_norm_eps"]
    pre = "mask_decoder.transformer."
    keys = image_embedding.flatten(2).permute(0, 2, 1)
    key_pe = image_pe.flatten(2).permute(0, 2, 1)
    queries = point_embedding
    for i in range(m["num_hidden_layers"]):
        blk = f"{pre}layers.{i}."
        if i == 0:  # skip_first_layer_pe
            queries = _dec_attention(w, blk + "self_attn.", queries, queries,
                                     queries, heads, rounding)
        else:
            q = queries + point_embedding
            queries = queries + _dec_attention(w, blk + "self_attn.", q, q,
                                               queries, heads, rounding)
        queries = _layer_norm(queries, w, blk + "layer_norm1", eps)
        q, k = queries + point_embedding, keys + key_pe
        queries = queries + _dec_attention(
            w, blk + "cross_attn_token_to_image.", q, k, keys, heads,
            rounding)
        queries = _layer_norm(queries, w, blk + "layer_norm2", eps)
        mlp = torch.relu(_linear(queries, w, blk + "mlp.lin1", rounding))
        queries = queries + _linear(mlp, w, blk + "mlp.lin2", rounding)
        queries = _layer_norm(queries, w, blk + "layer_norm3", eps)
        q, k = queries + point_embedding, keys + key_pe
        keys = keys + _dec_attention(w, blk + "cross_attn_image_to_token.",
                                     k, q, queries, heads, rounding)
        keys = _layer_norm(keys, w, blk + "layer_norm4", eps)
    q, k = queries + point_embedding, keys + key_pe
    queries = queries + _dec_attention(w, pre + "final_attn_token_to_image.",
                                       q, k, keys, heads, rounding)
    queries = _layer_norm(queries, w, pre + "layer_norm_final_attn", 1e-5)
    return queries, keys


def _conv_t(x, w, name, rounding):
    return F.conv_transpose2d(operand(x, rounding),
                              operand(w[name + ".weight"], rounding),
                              w[name + ".bias"], stride=2)


def _hypernetwork(w, prefix, x, depth, rounding):
    x = torch.relu(_linear(x, w, prefix + "proj_in", rounding))
    for j in range(depth - 2):
        x = torch.relu(_linear(x, w, f"{prefix}layers.{j}", rounding))
    return _linear(x, w, prefix + "proj_out", rounding)


def predict_mask(w, image_embeddings, sparse, cfg, rounding):
    """``predict_masks``' first mask: (B, 4g, 4g) logits."""
    pre = "mask_decoder."
    g = image_embeddings.shape[-1]
    output_tokens = torch.cat([w[pre + "iou_token.weight"],
                               w[pre + "mask_tokens.weight"]], dim=0)
    output_tokens = output_tokens.unsqueeze(0).expand(sparse.shape[0], -1, -1)
    tokens = torch.cat((output_tokens, sparse), dim=1)
    dense = w["prompt_encoder.no_mask_embed.weight"].reshape(1, -1, 1, 1)
    src = image_embeddings + dense
    pos_src = dense_pe(w, g).expand(src.shape[0], -1, -1, -1)
    b, c, h, wd = src.shape
    hs, src = two_way_transformer(w, src, pos_src, tokens, cfg, rounding)
    mask_token = hs[:, 1, :]
    src = src.transpose(1, 2).reshape(b, c, h, wd)
    up = _conv_t(src, w, pre + "upscale_conv1", rounding)
    up = F.gelu(_layer_norm_2d(up, w, pre + "upscale_layer_norm"),
                approximate="none")
    up = F.gelu(_conv_t(up, w, pre + "upscale_conv2", rounding),
                approximate="none")
    hyper = _hypernetwork(w, pre + "output_hypernetworks_mlps.0.", mask_token,
                          3, rounding)
    b, c, h, wd = up.shape
    return _mm(hyper.unsqueeze(1), up.view(b, c, h * wd), rounding).view(
        b, h, wd)


# -------------------------------------------------------------------- model
def normalise(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) float32 in SAM's normalisation
    (pixel mean and std over 255, as its image processor has them)."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(PIXEL_MEAN, device=x.device) / 255.0
    std = torch.tensor(PIXEL_STD, device=x.device) / 255.0
    return ((x - mean) / std).permute(0, 3, 1, 2)


def mask_logits(w: Dict[str, torch.Tensor], images_u8: torch.Tensor,
                boxes: torch.Tensor, cfg: dict, *,
                rounding: Rounding = identity) -> torch.Tensor:
    """(B, S, S, 3) uint8 images and (B, 4) boxes -> (B, S, S) float32 mask
    logits at the image's size."""
    size = cfg["image_size"]
    emb = image_encoder(w, normalise(images_u8), cfg, rounding)
    sparse = embed_boxes(w, boxes.float(), size)
    low = predict_mask(w, emb, sparse, cfg, rounding)
    return F.interpolate(low.unsqueeze(1), (size, size), mode="bilinear",
                         align_corners=False)[:, 0]


def mask_gap(ref: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """The binary mask read as two classes with logits (0, m): per image,
    the largest |m| where the served bit is not m > 0, (B,) float32; 0
    where every bit agrees."""
    disagree = masks.bool() != (ref > 0)
    return torch.where(disagree, ref.abs(), torch.zeros_like(ref)).flatten(
        1).amax(dim=1)


def served_gaps(w, images_u8, boxes, masks, cfg, *,
                rounding: Rounding = identity, block: int = 1
                ) -> torch.Tensor:
    """``mask_gap`` of served masks against the reference's logits of the
    images and boxes they were served for, ``block`` images at a time."""
    out = []
    with torch.no_grad(), no_tf32():
        for s in range(0, images_u8.shape[0], block):
            ref = mask_logits(w, images_u8[s:s + block],
                              boxes[s:s + block], cfg, rounding=rounding)
            out.append(mask_gap(ref, masks[s:s + block]))
            del ref
    return torch.cat(out)


def control_masks(w, images_u8, boxes, cfg, rounding: Rounding,
                  block: int = 1) -> torch.Tensor:
    """The masks the reference serves when computed with ``rounding``: the
    control, put in the program's place."""
    out = []
    with torch.no_grad(), no_tf32():
        for s in range(0, images_u8.shape[0], block):
            out.append((mask_logits(w, images_u8[s:s + block],
                                    boxes[s:s + block], cfg,
                                    rounding=rounding) > 0).to(torch.uint8))
    return torch.cat(out)
