"""Weight bridge from the TPU package's parameter trees.

vitseg: the TPU package's parameters are a nested dict/list tree
(``models/vitseg.py:vitseg_init``, ``models/vit.py:vit_init``): linear
kernels stored (in, out) — ``patch_embed`` (p²C, H), ``qkv`` (H, 3H) —
and conv kernels HWIO. The port's modules keep the same names and layouts,
so a leaf at path ``backbone / layers / 3 / qkv / kernel`` is the state-dict
entry ``backbone.layers.3.qkv.kernel``. A W8A8-quantized tree (the TPU
package's ``ops/quant.py``: ``kernel_q`` int8, ``kernel_scale`` fp32) maps
onto the port's ``LinearW8A8`` buffers the same way.

The conv families (``models/unet.py`` and the decoders beside it) and
segformer (``models/segformer.py``, ``models/mit.py``) keep the tree's
names too, but not its layouts. Their state dict holds:

- every conv kernel OIHW, (out, in, kh, kw): the tree's HWIO kernel
  transposed by (3, 2, 0, 1);
- every depthwise kernel as (C, 1, k, k): the tree's (k, k, 1, C)
  transposed the same way (groups = C);
- every linear kernel (MiT's) as the tree holds it, (in, out);
- conv biases (out,), GroupNorm ``scale`` and ``bias`` (C,), MAnet's
  ``pab.gamma`` 0-dim, all as in the tree;
- ``norm_mean`` and ``norm_std`` (3,), buffers of the model (the
  reference model's buffers), where the tree holds them as parameters.

A W8A8 tree of these families (the TPU package's ``quantize_params_tree``)
holds ``kernel_q`` int8, transposed as the kernel it replaces, and
``kernel_scale`` fp32.
Leaves arrive as numpy arrays (the tests convert with ``np.asarray``), so
this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from visiontransformer_tpu_torch.models.unet import ConvSegModel
from visiontransformer_tpu_torch.ops.quant import (
    is_quantized,
    tree_is_quantized,
)


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}{key}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            _flatten(value, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def vitseg_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """TPU-package vitseg param tree (numpy leaves) -> the port's state
    dict: fp32, but int8 for the W8A8 kernels."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k: torch.from_numpy(np.array(
        v, dtype=np.int8 if v.dtype == np.int8 else np.float32))
        for k, v in flat.items()}


def conv_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """TPU-package conv-family or segformer param tree (numpy leaves) ->
    the port's state dict: fp32 (int8 for W8A8 kernels); 4-D kernels HWIO
    -> OIHW, 2-D (linear) kernels kept (in, out)."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k: torch.from_numpy(np.array(
        v.transpose(3, 2, 0, 1) if v.ndim == 4 else v,
        dtype=np.int8 if v.dtype == np.int8 else np.float32, order="C"))
        for k, v in flat.items()}


def load_jax_params(model: nn.Module, tree) -> nn.Module:
    """Load a TPU-package param tree into ``model`` (strict: every
    parameter and buffer must be present with its shape; values are copied
    onto the model's device). A W8A8 tree first puts the model in that
    form, in place (``models/registry.py:quantize_int8_``)."""
    from visiontransformer_tpu_torch.models.registry import quantize_int8_

    if tree_is_quantized(tree) and not is_quantized(model):
        quantize_int8_(model)
    bridge = (conv_params_from_jax if isinstance(model, ConvSegModel)
              else vitseg_params_from_jax)
    model.load_state_dict(bridge(tree), strict=True)
    return model
