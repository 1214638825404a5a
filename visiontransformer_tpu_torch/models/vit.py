"""ViT backbone forward, for inference and training.

Mirrors the TPU package's ``models/vit.py`` (HF ``ViTModel`` semantics):
patch embedding as patchify + one matmul, CLS token and learned position
embeddings, pre-LN encoder blocks with a fused (H, 3H) QKV projection and
exact-erf GELU MLP, final LayerNorm. With ``deterministic=False`` dropout
applies where the TPU package applies it (embeddings, attention probs,
attention output, MLP output), its draws taken in that order from one
explicit ``torch.Generator``. Remat, token merging and sharding are not
ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from visiontransformer_tpu_torch.configs import ViTConfig
from visiontransformer_tpu_torch.nn.layers import (
    LayerNorm,
    Linear,
    dropout,
    gelu_exact,
)
from visiontransformer_tpu_torch.ops.attention import multi_head_attention


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ln1 = LayerNorm(h, eps)
        self.qkv = Linear(h, 3 * h, bias=cfg.qkv_bias)
        self.attn_out = Linear(h, h)
        self.ln2 = LayerNorm(h, eps)
        self.mlp_in = Linear(h, cfg.intermediate_size)
        self.mlp_out = Linear(cfg.intermediate_size, h)


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        if cfg.remat or cfg.token_merge_r:
            raise ValueError("remat and token merging are not ported")
        self.cfg = cfg
        patch_dim = cfg.patch_size * cfg.patch_size * cfg.num_channels
        self.patch_embed = Linear(patch_dim, cfg.hidden_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.hidden_size))
        self.pos_embed = nn.Parameter(
            torch.empty(1, cfg.seq_len, cfg.hidden_size))
        self.layers = nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.final_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, images: torch.Tensor, *, attn_impl: str = "auto",
                dtype: torch.dtype = torch.float32,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return vit_apply(self, images, attn_impl=attn_impl, dtype=dtype,
                         deterministic=deterministic, generator=generator)


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, p*p*C), (ph, pw, C) pixel order per patch."""
    b, h, w, c = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, gh, gw, ph, pw, C)
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


def vit_embed(model: ViT, images: torch.Tensor, *,
              dtype: torch.dtype = torch.float32, deterministic: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Patchify + project + CLS + position embeddings + embedding
    dropout."""
    x = patchify(images.to(dtype), model.cfg.patch_size)
    x = model.patch_embed(x, dtype=dtype)
    cls = model.cls_token.to(dtype).expand(x.shape[0], -1, -1)
    x = torch.cat([cls, x], dim=1)
    x = x + model.pos_embed.to(dtype)
    return dropout(x, model.cfg.hidden_dropout_prob, generator=generator,
                   deterministic=deterministic)


def encoder_layer(layer: EncoderLayer, x: torch.Tensor, cfg: ViTConfig, *,
                  attn_impl: str, deterministic: bool = True,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    b, n, h = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    rate = cfg.hidden_dropout_prob

    y = layer.ln1(x)
    qkv = layer.qkv(y).reshape(b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    attn = multi_head_attention(
        qkv[0], qkv[1], qkv[2], implementation=attn_impl,
        dropout_rate=cfg.attention_probs_dropout_prob, generator=generator,
        deterministic=deterministic)
    attn = attn.transpose(1, 2).reshape(b, n, h)
    x = x + dropout(layer.attn_out(attn), rate, generator=generator,
                    deterministic=deterministic)

    y = layer.ln2(x)
    y = layer.mlp_out(gelu_exact(layer.mlp_in(y)))
    return x + dropout(y, rate, generator=generator,
                       deterministic=deterministic)


def vit_encode(model: ViT, x: torch.Tensor, *, attn_impl: str,
               deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Encoder blocks + final LayerNorm over embedded tokens."""
    for layer in model.layers:
        x = encoder_layer(layer, x, model.cfg, attn_impl=attn_impl,
                          deterministic=deterministic, generator=generator)
    return model.final_ln(x)


def vit_apply(model: ViT, images: torch.Tensor, *, attn_impl: str = "auto",
              dtype: torch.dtype = torch.float32, deterministic: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, H, W, C) images -> (B, N+1, hidden) final token states."""
    x = vit_embed(model, images, dtype=dtype, deterministic=deterministic,
                  generator=generator)
    return vit_encode(model, x, attn_impl=attn_impl,
                      deterministic=deterministic, generator=generator)
