"""Weight bridge from the TPU package's parameter tree.

The TPU package's vitseg parameters are a nested dict/list tree
(``models/vitseg.py:vitseg_init``, ``models/vit.py:vit_init``): linear
kernels stored (in, out) — ``patch_embed`` (p²C, H), ``qkv`` (H, 3H) —
and conv kernels HWIO. The port's modules keep the same names and layouts,
so a leaf at path ``backbone / layers / 3 / qkv / kernel`` is the state-dict
entry ``backbone.layers.3.qkv.kernel``. A W8A8-quantized tree (the TPU
package's ``ops/quant.py``: ``kernel_q`` int8, ``kernel_scale`` fp32) maps
onto the port's ``LinearW8A8`` buffers the same way. Leaves arrive as numpy
arrays (the tests convert with ``np.asarray``), so this module needs no
JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from visiontransformer_tpu_torch.ops.quant import (
    is_quantized,
    quantize_vit_,
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


def load_jax_params(model: nn.Module, tree) -> nn.Module:
    """Load a TPU-package param tree into ``model`` (strict: every
    parameter must be present with its shape; values are copied onto the
    model's device). A W8A8 tree first turns the model's encoder linears
    into ``LinearW8A8`` layers, in place."""
    if tree_is_quantized(tree) and not is_quantized(model):
        quantize_vit_(model.backbone)
    model.load_state_dict(vitseg_params_from_jax(tree), strict=True)
    return model
