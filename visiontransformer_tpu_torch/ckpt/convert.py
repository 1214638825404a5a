"""Weight bridge from the TPU package's parameter tree.

The TPU package's vitseg parameters are a nested dict/list tree
(``models/vitseg.py:vitseg_init``, ``models/vit.py:vit_init``): linear
kernels stored (in, out) — ``patch_embed`` (p²C, H), ``qkv`` (H, 3H) —
and conv kernels HWIO. The port's modules keep the same names and layouts,
so a leaf at path ``backbone / layers / 3 / qkv / kernel`` is the state-dict
entry ``backbone.layers.3.qkv.kernel``. Leaves arrive as numpy arrays (the
tests convert with ``np.asarray``), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


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
    """TPU-package vitseg param tree (numpy leaves) -> the port's fp32
    state dict."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flat.items()}


def load_jax_params(model: nn.Module, tree) -> nn.Module:
    """Load a TPU-package param tree into ``model`` (strict: every
    parameter must be present with its shape; values are copied onto the
    model's device)."""
    model.load_state_dict(vitseg_params_from_jax(tree), strict=True)
    return model
