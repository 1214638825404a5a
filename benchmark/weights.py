"""Seeded weights of a ViT segmentation configuration, made on the device.

The benchmark makes the weights and hands the same values to the program
(through a checkpoint or its parameters) and to the plain reference. One
normal draw on the device covers every leaf; each leaf is a slice of it,
scaled and shifted, in bf16, the type a served model computes in (exact
in the port's fp32 parameters too). Leaves are named
as the port's state dict names them (its checkpoint format); the reference
reads the same names.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# (mean, std) of each kind of leaf: products' kernels and the embeddings
# as HF ViT initialises them (std 0.02); biases small and non-zero, so
# that every bias path is exercised; LayerNorm scales around 1.
_DRAW = {"kernel": (0.0, 0.02), "bias": (0.0, 0.02), "scale": (1.0, 0.02),
         "embed": (0.0, 0.02)}


def vitseg_spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every leaf, in a fixed order."""
    d, m = cfg["hidden_size"], cfg["intermediate_size"]
    p, c = cfg["patch_size"], cfg["num_channels"]
    n = (cfg["image_size"] // p) ** 2 + 1
    spec = [("backbone.cls_token", (1, 1, d), "embed"),
            ("backbone.pos_embed", (1, n, d), "embed"),
            ("backbone.patch_embed.kernel", (p * p * c, d), "kernel"),
            ("backbone.patch_embed.bias", (d,), "bias")]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"backbone.layers.{i}."
        spec += [(pre + "ln1.scale", (d,), "scale"),
                 (pre + "ln1.bias", (d,), "bias"),
                 (pre + "qkv.kernel", (d, 3 * d), "kernel"),
                 (pre + "qkv.bias", (3 * d,), "bias"),
                 (pre + "attn_out.kernel", (d, d), "kernel"),
                 (pre + "attn_out.bias", (d,), "bias"),
                 (pre + "ln2.scale", (d,), "scale"),
                 (pre + "ln2.bias", (d,), "bias"),
                 (pre + "mlp_in.kernel", (d, m), "kernel"),
                 (pre + "mlp_in.bias", (m,), "bias"),
                 (pre + "mlp_out.kernel", (m, d), "kernel"),
                 (pre + "mlp_out.bias", (d,), "bias")]
    h = cfg["head_channels"]
    spec += [("backbone.final_ln.scale", (d,), "scale"),
             ("backbone.final_ln.bias", (d,), "bias"),
             ("head_conv1.kernel", (3, 3, d, h), "kernel"),
             ("head_conv1.bias", (h,), "bias"),
             ("head_conv2.kernel", (1, 1, h, cfg["num_classes"]), "kernel"),
             ("head_conv2.bias", (cfg["num_classes"],), "bias")]
    return spec


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: bf16 tensor on ``device``} from ``seed``."""
    spec = vitseg_spec(cfg)
    total = sum(_numel(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, start = {}, 0
    for name, shape, kind in spec:
        mean, std = _DRAW[kind]
        part = flat[start:start + _numel(shape)].view(shape)
        out[name] = (part * std + mean).to(torch.bfloat16)
        start += _numel(shape)
    return out
