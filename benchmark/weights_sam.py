"""Seeded weights of a SAM configuration under HF ``SamModel``'s names, made
on the device, and the HF ``save_pretrained`` directory that holds them.

As ``weights_segformer.py`` does: one normal draw on the device covers
every leaf, each leaf a slice of it, scaled and shifted, rounded to bf16.
The names and shapes are those of ``SamModel``'s state dict (HF's
``modeling_sam.py``: linear kernels (out, in), conv kernels OIHW,
transposed-conv kernels (in, out, kh, kw)), less the prompt encoder's tied
copy of the Fourier matrix, which ``save_pretrained`` leaves out too.
``write_hf_dir`` saves them in fp32 as ``pytorch_model.bin`` beside the
configuration's ``hf_config`` as ``config.json``, the format
``save_pretrained(safe_serialization=False)`` writes; the reference reads
the same names.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import torch

# (mean, std) of each kind of leaf. Kernels ("kernel", "tkernel") take std
# 1/sqrt(fan-in) (None): every product keeps its input's scale, so that the
# query and key kernels in qkv give logits that spread by about 1 and the
# mask's logits spread by about 1 with both signs over the image (at HF's
# std 0.02 the decoder's products shrink the mask logits to a few
# thousandths, which its biases then outweigh, and a fault upstream hardly
# reaches the mask). The relative-position tables ("table") take std
# 1/sqrt(head dim), so that rel_h = q·Rh and rel_w = q·Rw spread by about 1
# (SAM starts them at zero, which would hide every fault of the bias); the
# Fourier matrix std 1 (SAM's scale); embedding tables std 1 (torch's
# nn.Embedding); the absolute position embedding std 0.02; biases std
# 0.02, non-zero so that every bias path is exercised; LayerNorm scales
# around 1.
_DRAW = {"kernel": (0.0, None), "tkernel": (0.0, None), "table": (0.0, None),
         "bias": (0.0, 0.02), "scale": (1.0, 0.02), "pos": (0.0, 0.02),
         "embed": (0.0, 1.0), "fourier": (0.0, 1.0)}


def _linear(name: str, cout: int, cin: int) -> List[Tuple[str, tuple, str]]:
    return [(name + ".weight", (cout, cin), "kernel"),
            (name + ".bias", (cout,), "bias")]


def _norm(name: str, dim: int) -> List[Tuple[str, tuple, str]]:
    return [(name + ".weight", (dim,), "scale"), (name + ".bias", (dim,),
                                                  "bias")]


def _feed_forward(name: str, cin: int, hidden: int, cout: int, depth: int):
    spec = _linear(name + ".proj_in", hidden, cin)
    for j in range(depth - 2):
        spec += _linear(f"{name}.layers.{j}", hidden, hidden)
    return spec + _linear(name + ".proj_out", cout, hidden)


def sam_spec(hf: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every floating-point leaf, in a fixed
    order."""
    v, p, m = (hf["vision_config"], hf["prompt_encoder_config"],
               hf["mask_decoder_config"])
    c, o = v["hidden_size"], v["output_channels"]
    g = v["image_size"] // v["patch_size"]
    hd = c // v["num_attention_heads"]
    spec = [("shared_image_embedding.positional_embedding",
             (2, v["num_pos_feats"]), "fourier"),
            ("vision_encoder.pos_embed", (1, g, g, c), "pos"),
            ("vision_encoder.patch_embed.projection.weight",
             (c, v["num_channels"], v["patch_size"], v["patch_size"]),
             "kernel"),
            ("vision_encoder.patch_embed.projection.bias", (c,), "bias")]
    for i in range(v["num_hidden_layers"]):
        b = f"vision_encoder.layers.{i}."
        size = g if i in v["global_attn_indexes"] else v["window_size"]
        spec += _norm(b + "layer_norm1", c)
        spec += [(b + "attn.rel_pos_h", (2 * size - 1, hd), "table"),
                 (b + "attn.rel_pos_w", (2 * size - 1, hd), "table")]
        spec += _linear(b + "attn.qkv", 3 * c, c)
        spec += _linear(b + "attn.proj", c, c)
        spec += _norm(b + "layer_norm2", c)
        spec += _linear(b + "mlp.lin1", v["mlp_dim"], c)
        spec += _linear(b + "mlp.lin2", c, v["mlp_dim"])
    n = "vision_encoder.neck."
    spec += [(n + "conv1.weight", (o, c, 1, 1), "kernel")]
    spec += _norm(n + "layer_norm1", o)
    spec += [(n + "conv2.weight", (o, o, 3, 3), "kernel")]
    spec += _norm(n + "layer_norm2", o)
    e = "prompt_encoder."
    mi = p["mask_input_channels"]
    spec += [(e + "mask_embed.conv1.weight", (mi // 4, 1, 2, 2), "kernel"),
             (e + "mask_embed.conv1.bias", (mi // 4,), "bias"),
             (e + "mask_embed.conv2.weight", (mi, mi // 4, 2, 2), "kernel"),
             (e + "mask_embed.conv2.bias", (mi,), "bias"),
             (e + "mask_embed.conv3.weight", (o, mi, 1, 1), "kernel"),
             (e + "mask_embed.conv3.bias", (o,), "bias")]
    spec += _norm(e + "mask_embed.layer_norm1", mi // 4)
    spec += _norm(e + "mask_embed.layer_norm2", mi)
    spec += [(e + "no_mask_embed.weight", (1, o), "embed")]
    spec += [(f"{e}point_embed.{j}.weight", (1, o), "embed")
             for j in range(p["num_point_embeddings"])]
    spec += [(e + "not_a_point_embed.weight", (1, o), "embed")]
    d = "mask_decoder."
    tokens = m["num_multimask_outputs"] + 1
    inner = o // m["attention_downsample_rate"]
    spec += [(d + "iou_token.weight", (1, o), "embed"),
             (d + "mask_tokens.weight", (tokens, o), "embed")]

    def attention(name, width):
        return (_linear(name + ".q_proj", width, o)
                + _linear(name + ".k_proj", width, o)
                + _linear(name + ".v_proj", width, o)
                + _linear(name + ".out_proj", o, width))

    t = d + "transformer."
    for j in range(m["num_hidden_layers"]):
        b = f"{t}layers.{j}."
        spec += attention(b + "self_attn", o)
        spec += _norm(b + "layer_norm1", o)
        spec += attention(b + "cross_attn_token_to_image", inner)
        spec += _norm(b + "layer_norm2", o)
        spec += _linear(b + "mlp.lin1", m["mlp_dim"], o)
        spec += _linear(b + "mlp.lin2", o, m["mlp_dim"])
        spec += _norm(b + "layer_norm3", o)
        spec += _norm(b + "layer_norm4", o)
        spec += attention(b + "cross_attn_image_to_token", inner)
    spec += attention(t + "final_attn_token_to_image", inner)
    spec += _norm(t + "layer_norm_final_attn", o)
    spec += [(d + "upscale_conv1.weight", (o, o // 4, 2, 2), "tkernel"),
             (d + "upscale_conv1.bias", (o // 4,), "bias"),
             (d + "upscale_conv2.weight", (o // 4, o // 8, 2, 2), "tkernel"),
             (d + "upscale_conv2.bias", (o // 8,), "bias")]
    spec += _norm(d + "upscale_layer_norm", o // 4)
    for j in range(tokens):
        spec += _feed_forward(f"{d}output_hypernetworks_mlps.{j}", o, o,
                              o // 8, 3)
    spec += _feed_forward(d + "iou_prediction_head", o,
                          m["iou_head_hidden_dim"], tokens,
                          m["iou_head_depth"])
    return spec


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _std(kind: str, shape: tuple) -> float:
    if kind == "kernel":          # (out, in, ...): fan-in in · kh · kw
        return _numel(shape[1:]) ** -0.5
    if kind == "tkernel":         # (in, out, 2, 2) at stride 2: fan-in in
        return shape[0] ** -0.5
    return shape[1] ** -0.5       # "table": (2S - 1, head dim)


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{HF name: fp32 tensor on ``device`` holding bf16 values} from
    ``seed``."""
    spec = sam_spec(cfg["hf_config"])
    total = sum(_numel(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, start = {}, 0
    for name, shape, kind in spec:
        mean, std = _DRAW[kind]
        if std is None:
            std = _std(kind, shape)
        part = flat[start:start + _numel(shape)].view(shape)
        out[name] = (part * std + mean).to(torch.bfloat16).float()
        start += _numel(shape)
    return out


def write_hf_dir(path: str, cfg: dict,
                 weights: Dict[str, torch.Tensor]) -> str:
    """``config.json`` and ``pytorch_model.bin`` under ``path``; returns
    ``path``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg["hf_config"], f, indent=2)
    torch.save({k: t.cpu() for k, t in weights.items()},
               os.path.join(path, "pytorch_model.bin"))
    return path
