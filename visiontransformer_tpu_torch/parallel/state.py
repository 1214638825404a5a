"""A checkpoint's train state in the pipeline-stacked form and back.

The trainer's state is (params state dict, optimizer state dict) in the
single-device format: the optimizer's state keyed by the parameters'
places in the params' order. A pipeline checkpoint stores
``backbone.layers`` stacked (``parallel/pipeline.py:stack_stage_params``),
so its optimizer state is keyed by the places in the stacked order, each
stacked leaf's moments stacked alike (the TPU package's mu/nu trees hold
the layers in the params' form). ``stack_train_state`` and
``unstack_train_state`` convert both together, so a resume across modes
keeps the Adam moments.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from visiontransformer_tpu_torch.parallel.pipeline import (
    LAYERS,
    _LAYER_KEY,
    is_stacked,
    stack_stage_params,
    unstack_stage_params,
)


def _groups(opt: Mapping, n: int) -> list:
    if len(opt["param_groups"]) != 1:
        raise ValueError("stacked optimizer states have one parameter group")
    group = {k: v for k, v in opt["param_groups"][0].items() if k != "params"}
    return [{**group, "params": list(range(n))}]


def stack_train_state(params: Mapping[str, torch.Tensor],
                      opt: Optional[Mapping]) -> Tuple[dict, Optional[dict]]:
    """Per-layer form -> stacked form, params and optimizer state."""
    stacked = stack_stage_params(params)
    if opt is None:
        return stacked, None
    names = list(params)
    by_name = {names[i]: s for i, s in opt["state"].items()}
    state: Dict[int, dict] = {}
    for i, key in enumerate(stacked):
        if not key.startswith(LAYERS):
            if key in by_name:
                state[i] = by_name[key]
            continue
        leaf = key[len(LAYERS):]
        layers = [by_name.get(f"{LAYERS}{j}.{leaf}")
                  for j in range(len(stacked[key]))]
        if any(s is None for s in layers):
            continue
        state[i] = {k: (torch.stack([s[k] for s in layers])
                        if isinstance(v, torch.Tensor) and v.dim() else v)
                    for k, v in layers[0].items()}
    return stacked, {"state": state,
                     "param_groups": _groups(opt, len(stacked))}


def unstack_train_state(params: Mapping[str, torch.Tensor],
                        opt: Optional[Mapping]
                        ) -> Tuple[dict, Optional[dict]]:
    """Stacked form -> per-layer form, params and optimizer state."""
    flat = unstack_stage_params(params)
    if opt is None:
        return flat, None
    stacked_names = list(params)
    by_name = {stacked_names[i]: s for i, s in opt["state"].items()}
    state: Dict[int, dict] = {}
    for i, key in enumerate(flat):
        m = _LAYER_KEY.match(key)
        if m is None:
            if key in by_name:
                state[i] = by_name[key]
            continue
        saved = by_name.get(LAYERS + m.group(2))
        if saved is None:
            continue
        j = int(m.group(1))
        state[i] = {k: (v[j] if isinstance(v, torch.Tensor) and v.dim()
                        else v) for k, v in saved.items()}
    return flat, {"state": state, "param_groups": _groups(opt, len(flat))}


def match_layer_form(params: Mapping[str, torch.Tensor],
                     opt: Optional[Mapping], stacked: bool
                     ) -> Tuple[Mapping, Optional[Mapping]]:
    """A checkpoint's (params, optimizer state) in the target's layer
    form: stacked or per-layer."""
    if is_stacked(params) == stacked:
        return params, opt
    return (stack_train_state if stacked else unstack_train_state)(
        params, opt)
