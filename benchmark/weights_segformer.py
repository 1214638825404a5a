"""Seeded weights of a SegFormer configuration under HF's names, made on
the device, and the HF ``save_pretrained`` directory that holds them.

As ``weights.py`` does for the ViT: one normal draw on the device covers
every leaf, each leaf a slice of it, scaled and shifted, rounded to bf16.
The names and shapes are those of ``SegformerForSemanticSegmentation``'s
state dict (HF's ``modeling_segformer.py``: conv kernels OIHW, linear
kernels (out, in)); the BatchNorm of the decode head gets seeded running
statistics. ``write_hf_dir`` saves them in fp32 as ``pytorch_model.bin``
beside the configuration's ``hf_config`` as ``config.json``, the format
``save_pretrained(safe_serialization=False)`` writes; the reference reads
the same names.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import torch

# (mean, std) of each kind of leaf: kernels and biases as HF initialises
# its linears (std 0.02), biases non-zero so that every bias path is
# exercised; LayerNorm and BatchNorm scales around 1; BatchNorm running
# means around 0 and variances around 1. The query and key kernels ("qk")
# take std 1/√fan-in (None): on LayerNorm-ed tokens q and k then have unit
# entries and the scaled logits a spread of about 1, so the softmax picks
# among the keys as trained SegFormer attention does. At std 0.02 the
# logits spread 0.03 (stage 1) to 0.2 (stage 4), the softmax is nearly
# uniform, and a fault in the attention core hardly reaches the masks.
_DRAW = {"kernel": (0.0, 0.02), "bias": (0.0, 0.02), "scale": (1.0, 0.02),
         "mean": (0.0, 0.02), "var": (1.0, 0.02), "qk": (0.0, None)}


def segformer_spec(hf: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every floating-point leaf, in a fixed
    order."""
    spec = []
    cin = hf["num_channels"]
    for i, (c, depth, r, k, ratio) in enumerate(zip(
            hf["hidden_sizes"], hf["depths"], hf["sr_ratios"],
            hf["patch_sizes"], hf["mlp_ratios"])):
        e = f"segformer.encoder.patch_embeddings.{i}."
        spec += [(e + "proj.weight", (c, cin, k, k), "kernel"),
                 (e + "proj.bias", (c,), "bias"),
                 (e + "layer_norm.weight", (c,), "scale"),
                 (e + "layer_norm.bias", (c,), "bias")]
        hidden = ratio * c
        for j in range(depth):
            b = f"segformer.encoder.block.{i}.{j}."
            spec += [(b + "layer_norm_1.weight", (c,), "scale"),
                     (b + "layer_norm_1.bias", (c,), "bias")]
            for name, kind in (("query", "qk"), ("key", "qk"),
                               ("value", "kernel")):
                spec += [(b + f"attention.self.{name}.weight", (c, c), kind),
                         (b + f"attention.self.{name}.bias", (c,), "bias")]
            if r > 1:
                spec += [(b + "attention.self.sr.weight", (c, c, r, r),
                          "kernel"),
                         (b + "attention.self.sr.bias", (c,), "bias"),
                         (b + "attention.self.layer_norm.weight", (c,),
                          "scale"),
                         (b + "attention.self.layer_norm.bias", (c,),
                          "bias")]
            spec += [(b + "attention.output.dense.weight", (c, c), "kernel"),
                     (b + "attention.output.dense.bias", (c,), "bias"),
                     (b + "layer_norm_2.weight", (c,), "scale"),
                     (b + "layer_norm_2.bias", (c,), "bias"),
                     (b + "mlp.dense1.weight", (hidden, c), "kernel"),
                     (b + "mlp.dense1.bias", (hidden,), "bias"),
                     (b + "mlp.dwconv.dwconv.weight", (hidden, 1, 3, 3),
                      "kernel"),
                     (b + "mlp.dwconv.dwconv.bias", (hidden,), "bias"),
                     (b + "mlp.dense2.weight", (c, hidden), "kernel"),
                     (b + "mlp.dense2.bias", (c,), "bias")]
        spec += [(f"segformer.encoder.layer_norm.{i}.weight", (c,), "scale"),
                 (f"segformer.encoder.layer_norm.{i}.bias", (c,), "bias")]
        cin = c
    e = hf["decoder_hidden_size"]
    for i, c in enumerate(hf["hidden_sizes"]):
        spec += [(f"decode_head.linear_c.{i}.proj.weight", (e, c), "kernel"),
                 (f"decode_head.linear_c.{i}.proj.bias", (e,), "bias")]
    n_levels = len(hf["hidden_sizes"])
    classes = len(hf["id2label"])
    spec += [("decode_head.linear_fuse.weight", (e, n_levels * e, 1, 1),
              "kernel"),
             ("decode_head.batch_norm.weight", (e,), "scale"),
             ("decode_head.batch_norm.bias", (e,), "bias"),
             ("decode_head.batch_norm.running_mean", (e,), "mean"),
             ("decode_head.batch_norm.running_var", (e,), "var"),
             ("decode_head.classifier.weight", (classes, e, 1, 1), "kernel"),
             ("decode_head.classifier.bias", (classes,), "bias")]
    return spec


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{HF name: fp32 tensor on ``device`` holding bf16 values} from
    ``seed``."""
    spec = segformer_spec(cfg["hf_config"])
    total = sum(_numel(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, start = {}, 0
    for name, shape, kind in spec:
        mean, std = _DRAW[kind]
        if std is None:
            std = _numel(shape[1:]) ** -0.5
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
    state = {k: v.cpu() for k, v in weights.items()}
    state["decode_head.batch_norm.num_batches_tracked"] = torch.tensor(0)
    torch.save(state, os.path.join(path, "pytorch_model.bin"))
    return path
