"""Post-training W8A8 dynamic int8 quantization, for every family.

The TPU package's ``ops/quant.py`` scheme:

- weights: symmetric per-output-channel scales, ``s_w[o] = max|W[:, o]| /
  127`` (at least 1e-12), ``round(W / s_w)`` clipped to +-127 as int8,
  once, when the model is loaded;
- activations: symmetric per-token scales computed inside the forward
  (``nn/layers.py:_linear_w8a8``), the int8 x int8 -> int32 product, then
  ``acc * s_x * s_w + bias`` in fp32. A convolution's activations take
  one scale a sample (``nn/layers.py:conv2d_w8a8``): its output pixel
  reduces over H, W and C.

Only the encoder layers' linears (``QUANTIZED_LAYER_KEYS``: fused QKV,
attention output, MLP in and out) are quantized; the patch embedding,
LayerNorms, attention, the conv head and the upsample stay in the compute
dtype. ``quantize_vit_`` swaps them in place (the serving runner and the
weight bridge use it); ``quantize_vit``/``quantize_vitseg`` return a new
model, the input unchanged, as the TPU package's functions of the same
names return a new tree. The form is for inference only: rounding has no
gradient, so the trainer refuses a quantized model.

``quantize_params_tree`` is the generic walk over a parameter tree (nested
dicts and lists of tensors or arrays, the TPU package's layout, HWIO conv
kernels) for its linears and interior convs, the counterpart of the TPU
package's; ``quantize_conv_model_`` applies the same rule in place to a
``ConvSegModel`` (the conv families and segformer, OIHW kernels), whose
quantized layers hold ``kernel_q``, ``kernel_scale`` and ``bias`` as
buffers, and which the tree helpers of ``models/unet.py`` (``conv``,
``linear``) then run in the W8A8 form.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch
from torch import nn

from visiontransformer_tpu_torch.nn.layers import (
    Linear,
    LinearW8A8,
    ParamTree,
    div127,
)

# The encoder-layer linears that carry the FLOPs (models/vit.py
# EncoderLayer). The patch embedding is left out: first-layer quantization
# is the classic PTQ accuracy cliff, and its share of the FLOPs is small.
QUANTIZED_LAYER_KEYS = ("qkv", "attn_out", "mlp_in", "mlp_out")

# Subtrees ``quantize_params_tree`` leaves in the compute dtype wherever
# they appear: the logits head and the input stem / patch embedding.
QUANT_SKIP_KEYS = frozenset({"head", "stem", "patch_embed"})


def quantize_linear_params(kernel, bias=None) -> Dict[str, torch.Tensor]:
    """A linear's (in, out) kernel (and bias) -> the W8A8 form
    {"kernel_q": (in, out) int8, "kernel_scale": (out,) fp32, ["bias"]}:
    s_w[o] = max|W[:, o]| / 127 (at least 1e-12)."""
    return _quantize(torch.as_tensor(kernel), bias, (0,))


def _w8a8(linear: Linear) -> LinearW8A8:
    bias = None if linear.bias is None else linear.bias.detach()
    return LinearW8A8(**quantize_linear_params(linear.kernel.detach(), bias))


def quantize_vit_(backbone: nn.Module) -> nn.Module:
    """Swap every encoder layer's ``QUANTIZED_LAYER_KEYS`` linears for
    their W8A8 form, in place; returns ``backbone``."""
    for layer in backbone.layers:
        for key in QUANTIZED_LAYER_KEYS:
            module = getattr(layer, key)
            if isinstance(module, Linear):
                setattr(layer, key, _w8a8(module))
    return backbone


def quantize_vit(backbone: nn.Module) -> nn.Module:
    """A W8A8 copy of a ViT backbone (``models/vit.py:ViT``); the input is
    unchanged."""
    return quantize_vit_(copy.deepcopy(backbone))


def quantize_vitseg(model: nn.Module) -> nn.Module:
    """A copy of a vitseg model with a W8A8 backbone; the conv head stays
    in the compute dtype. The input is unchanged."""
    new = copy.deepcopy(model)
    quantize_vit_(new.backbone)
    return new


def quantize_conv_params(kernel, bias=None) -> Dict[str, torch.Tensor]:
    """A conv's (kh, kw, in, out) HWIO kernel (and bias) -> the W8A8 form
    {"kernel_q": HWIO int8, "kernel_scale": (out,) fp32, ["bias"]}: one
    scale an output channel, over the H, W and I axes."""
    return _quantize(torch.as_tensor(kernel), bias, (0, 1, 2))


def _quantize(w: torch.Tensor, bias, axes) -> Dict[str, torch.Tensor]:
    w = w.to(torch.float32)
    scale = torch.clamp(div127(w.abs().amax(dim=axes, keepdim=True)),
                        min=1e-12)
    out = {"kernel_q": torch.clamp(torch.round(w / scale), -127,
                                   127).to(torch.int8),
           "kernel_scale": scale.flatten()}
    if bias is not None:
        out["bias"] = torch.as_tensor(bias).to(torch.float32)
    return out


def _quantizes(kernel, in_axis: int) -> bool:
    """The TPU package's rule: every linear, and every conv but the
    depthwise (I == 1) and input-facing (cin <= 4) ones."""
    return kernel.ndim == 2 or (kernel.ndim == 4
                                and kernel.shape[in_axis] > 4)


def quantize_params_tree(params, *, skip_keys=QUANT_SKIP_KEYS):
    """W8A8 form of every linear (a dict with a 2-D ``kernel``) and every
    interior conv (a 4-D HWIO kernel with more than 4 input channels) in a
    parameter tree of nested dicts and lists, leaving ``skip_keys``
    subtrees, depthwise and input-facing convs as they are. Returns a new
    tree."""
    def walk(node):
        if isinstance(node, dict):
            kernel = node.get("kernel")
            if kernel is not None and hasattr(kernel, "ndim"):
                if not _quantizes(kernel, 2):
                    return node
                if kernel.ndim == 2:
                    return quantize_linear_params(kernel, node.get("bias"))
                return quantize_conv_params(kernel, node.get("bias"))
            return {k: (v if k in skip_keys else walk(v))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def quantize_conv_model_(model: nn.Module, *,
                         skip_keys=QUANT_SKIP_KEYS) -> nn.Module:
    """``quantize_params_tree``'s rule applied in place to a
    ``ConvSegModel`` (OIHW conv kernels, (in, out) linear kernels): each
    layer it quantizes gives up its ``kernel`` parameter for ``kernel_q``
    (int8; a linear's column-major, as ``LinearW8A8`` holds it),
    ``kernel_scale`` and ``bias`` buffers, quantized on the CPU. Returns
    ``model``."""
    def walk(node):
        kernel = node._parameters.get("kernel")
        if kernel is not None:
            if not _quantizes(kernel, 1):
                return
            w = kernel.detach().cpu()
            bias = node._parameters.pop("bias", None)
            q = (quantize_linear_params(w) if w.ndim == 2
                 else _quantize(w, None, (1, 2, 3)))
            kernel_q = q["kernel_q"]
            if w.ndim == 2:
                kernel_q = kernel_q.t().contiguous().t()
            del node._parameters["kernel"]
            for name, value in (("kernel_q", kernel_q),
                                ("kernel_scale", q["kernel_scale"]),
                                ("bias", None if bias is None
                                 else bias.detach().float())):
                node.register_buffer(name, None if value is None
                                     else value.to(kernel.device))
            return
        for name, child in node.named_children():
            if name not in skip_keys:
                walk(child)

    walk(model)
    return model


def tree_is_quantized(params) -> bool:
    """True if any dict in a parameter tree is in the W8A8 form (the weight
    bridge asks it of a TPU-package tree)."""
    if isinstance(params, dict):
        return "kernel_q" in params or any(
            tree_is_quantized(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return any(tree_is_quantized(v) for v in params)
    return False


def is_quantized(model_or_params) -> bool:
    """True for a module holding a W8A8 layer, or a parameter tree holding
    a W8A8 kernel."""
    if isinstance(model_or_params, nn.Module):
        return any(isinstance(m, LinearW8A8) or (
            isinstance(m, ParamTree) and "kernel_q" in m._buffers)
            for m in model_or_params.modules())
    return tree_is_quantized(model_or_params)

