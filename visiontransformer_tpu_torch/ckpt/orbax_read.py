"""The TPU package's Orbax checkpoints, read without JAX.

The TPU package saves ``{"params", "opt_state", "step"}`` with Orbax
(``ckpt/io.py:save_checkpoint`` there): a directory holding ``_METADATA``
(JSON) and an OCDBT key-value store (``manifest.ocdbt``) of zarr arrays.
``_METADATA``'s ``tree_metadata`` names every leaf by its key path
(``key_type`` 2: a dict key or named field, 1: a sequence index); a leaf
marked ``skip_deserialize`` is a leafless subtree (``value_type`` "None",
"Tuple" or "Dict"). Each array is read with tensorstore alone,
through the spec ``{"driver": "zarr", "kvstore": {"driver": "ocdbt",
"base": "file://<dir>", "path": "params.a.kernel"}}``; the chunks are
zstd-compressed, which Python's standard library cannot read, so this is
a host-side tool: ``convert_orbax_checkpoint`` (the ``convert-orbax``
command) writes a port checkpoint (``ckpt/io.py``) on a host that has
tensorstore, and the card reads that. tensorstore is imported inside the
functions that read.

The parameters reach the port through the weight bridge
(``ckpt/convert.py``); pipeline-stacked ``backbone.layers`` (one mapping
whose leaves carry a leading layer axis) are unstacked first, as the TPU
package's ``parallel/pipeline.py:unstack_stage_params`` does. The
optimizer state is the TPU package's chain (``train/optim.py`` there):
``inject_hyperparams(adam | adamw)``, whose ``inner_state`` holds
``scale_by_adam``'s ``count``, ``mu`` and ``nu`` beside empty states
(``_METADATA`` of a TPU ``Trainer`` checkpoint). ``mu`` and ``nu``
have the parameters' tree, so they take the same name map into torch
Adam/AdamW's ``exp_avg`` and ``exp_avg_sq``; ``count`` becomes ``step``
and the injected ``learning_rate`` the group's ``lr``. Any other
optimizer tree is left out (one printed line says so): the port's resume
keeps a fresh state then, as the TPU package's does.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from visiontransformer_tpu_torch.ckpt.convert import (
    conv_params_from_jax,
    load_jax_params,
    vitseg_params_from_jax,
)
from visiontransformer_tpu_torch.ckpt.io import parse_epoch, save_checkpoint

_LEAFLESS = {"None": None, "Tuple": (), "Dict": {}}


def is_orbax_dir(path: str) -> bool:
    return (os.path.isfile(os.path.join(path, "_METADATA"))
            and os.path.isfile(os.path.join(path, "manifest.ocdbt")))


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading a TPU-package Orbax checkpoint needs tensorstore; run "
            "the conversion (python -m visiontransformer_tpu_torch "
            "convert-orbax) on a host that has it, and give the card the "
            "converted directory") from e
    return tensorstore


def _to_torch(array: np.ndarray) -> torch.Tensor:
    """A tensorstore array as a CPU tensor of the same dtype; bf16 (numpy's
    ml_dtypes bfloat16) through its bits, never through fp32."""
    array = np.ascontiguousarray(array)
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(array.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def _as_sequences(node):
    """Dicts keyed by sequence indices become lists, bottom up."""
    if not isinstance(node, dict):
        return node
    node = {k: _as_sequences(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"sequence indices {sorted(node)} have gaps")
        return [node[i] for i in range(len(node))]
    return node


def read_orbax_tree(path: str) -> Dict[str, Any]:
    """The nested dict/list tree of an Orbax checkpoint directory, every
    leaf a CPU tensor of the dtype on disk (leafless subtrees as None, an
    empty tuple or an empty dict)."""
    ts = _tensorstore()
    path = os.path.abspath(path)
    if not is_orbax_dir(path):
        raise ValueError(f"{path} is not an Orbax checkpoint (no _METADATA "
                         f"and manifest.ocdbt in it)")
    with open(os.path.join(path, "_METADATA")) as f:
        entries = json.load(f)["tree_metadata"].values()
    root: Dict[Any, Any] = {}
    reads = []
    for entry in entries:
        keys = [int(k["key"]) if k["key_type"] == 1 else k["key"]
                for k in entry["key_metadata"]]
        node = root
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        value = entry["value_metadata"]
        if value.get("skip_deserialize"):
            if value["value_type"] not in _LEAFLESS:
                raise ValueError(f"{'.'.join(map(str, keys))}: leafless "
                                 f"value of type {value['value_type']!r}")
            node[keys[-1]] = _LEAFLESS[value["value_type"]]
            continue
        spec = {"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": f"file://{path}",
            "path": ".".join(map(str, keys))}}
        reads.append((node, keys[-1], ts.open(spec, open=True, read=True)))
    # Every open is in flight before the first wait, then every read.
    reads = [(node, key, store.result().read())
             for node, key, store in reads]
    for node, key, future in reads:
        node[key] = _to_torch(future.result())
    return _as_sequences(root)


def unstack_stage_params(stacked):
    """Split the leading layer axis of a pipeline-stacked layer tree into
    the per-layer list (the TPU package's
    ``parallel/pipeline.py:unstack_stage_params``)."""
    leaves = []
    _leaves(stacked, leaves)
    n = leaves[0].shape[0]
    return [_map(lambda x, i=i: x[i], stacked) for i in range(n)]


def _leaves(tree, out: list) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif tree is not None:
        out.append(tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _unstacked(params):
    """``params`` with pipeline-stacked ``backbone.layers`` unstacked (the
    TPU package's ``maybe_unstack_params``); unchanged otherwise."""
    backbone = params.get("backbone") if isinstance(params, dict) else None
    layers = backbone.get("layers") if isinstance(backbone, dict) else None
    if isinstance(layers, dict) and layers:
        params = {**params, "backbone": {
            **backbone, "layers": unstack_stage_params(layers)}}
    return params


def _numpy_tree(tree):
    """Leaves as numpy for the bridge; bf16 widened to fp32 exactly."""
    return _map(lambda t: (t.float() if t.dtype == torch.bfloat16 else t)
                .numpy(), tree)


def _state_dict(family: str, tree) -> Dict[str, torch.Tensor]:
    bridge = vitseg_params_from_jax if family == "vitseg" else (
        conv_params_from_jax)
    return bridge(_numpy_tree(_unstacked(tree)))


def _check_keys(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                what: str) -> None:
    """ValueError naming the first key missing, unexpected or misshapen."""
    for key in sorted(set(want) | set(got)):
        if key not in got:
            raise ValueError(f"{what}: {key} is missing (the model of this "
                             f"family and config has it)")
        if key not in want:
            raise ValueError(f"{what}: {key} is not in the model of this "
                             f"family and config")
        if tuple(got[key].shape) != tuple(want[key].shape):
            raise ValueError(f"{what}: {key} has shape "
                             f"{tuple(got[key].shape)}, the model "
                             f"{tuple(want[key].shape)}")


def tree_config(family: str, params, cfg, *, infer_size: bool = False):
    """``cfg`` with the geometry the parameters fix and the name does not:
    segformer's decode width and head norm, and, with ``infer_size``,
    vitseg's input size (from ``pos_embed``)."""
    if family == "segformer":
        fuse = params.get("fuse", {})
        cfg = dataclasses.replace(
            cfg, embed_channels=int(params["head"]["kernel"].shape[2]),
            head_norm="affine" if "affine" in fuse else "gn")
    if family == "vitseg" and infer_size:
        pos = params["backbone"]["pos_embed"]
        grid = int(round(np.sqrt(pos.shape[1] - 1)))
        cfg = dataclasses.replace(cfg, vit=dataclasses.replace(
            cfg.vit, image_size=grid * cfg.vit.patch_size))
    return cfg


def model_from_params(family: str, params, cfg) -> nn.Module:
    """The port's model of ``cfg`` holding the TPU-package param tree
    ``params`` (pipeline-stacked layers unstacked; a W8A8 tree quantizes
    the model as the tree is), on the CPU. A tree that does not fit raises
    ValueError naming the first key at fault."""
    from visiontransformer_tpu_torch.models.registry import get_model_family
    from visiontransformer_tpu_torch.models.vitseg import ViTSeg

    # The weights are overwritten: vitseg skips its init's draws.
    model = (ViTSeg(cfg) if family == "vitseg" else
             get_model_family(family).init(torch.Generator(), cfg))
    tree = _numpy_tree(_unstacked(params))
    try:
        load_jax_params(model, tree)
    except RuntimeError:
        _check_keys(_state_dict(family, params), model.state_dict(), "params")
        raise
    return model


def _adam_state(opt_state) -> Tuple[Optional[dict], str]:
    """(the ``scale_by_adam`` state and the injected hyperparameters, or
    None, and what was found) of the TPU package's optimizer tree."""
    node = opt_state
    if not (isinstance(node, dict)
            and {"hyperparams", "inner_state"} <= set(node)):
        return None, "no inject_hyperparams state"
    chain = node["inner_state"]
    chain = chain if isinstance(chain, (list, tuple)) else [chain]
    adam = [s for s in chain if isinstance(s, dict)
            and set(s) == {"count", "mu", "nu"}]
    rest = [s for s in chain if not (isinstance(s, dict)
                                     and set(s) == {"count", "mu", "nu"})]
    if len(adam) != 1 or any(s not in (None, (), {}) for s in rest):
        return None, "no single scale_by_adam state in the chain"
    hyper = {k: float(v) for k, v in node["hyperparams"].items()}
    if hyper.get("eps_root", 0.0) != 0.0:
        return None, f"eps_root {hyper['eps_root']} (torch's Adam has none)"
    return {**adam[0], "hyper": hyper}, "adam"


def _literal(value: float) -> float:
    """The shortest decimal that rounds to the same fp32 value: the Python
    number the TPU package stored as fp32 (0.9, not 0.8999999761)."""
    return float(str(np.float32(value)))


def optimizer_from_state(family: str, opt_state, model: nn.Module
                         ) -> Optional[torch.optim.Optimizer]:
    """torch Adam or AdamW over ``model``'s parameters holding the TPU
    package's Adam moments, step and learning rate; None (with one printed
    line) for any other optimizer tree."""
    adam, found = _adam_state(opt_state)
    if adam is None:
        print(f"convert-orbax: optimizer state left out ({found}); a resume "
              f"starts it afresh", flush=True)
        return None
    hyper = adam["hyper"]
    kwargs = dict(lr=_literal(hyper["learning_rate"]),
                  betas=(_literal(hyper["b1"]), _literal(hyper["b2"])),
                  eps=_literal(hyper["eps"]))
    if "weight_decay" in hyper:
        optimizer = torch.optim.AdamW(
            model.parameters(), weight_decay=_literal(hyper["weight_decay"]),
            **kwargs)
    else:
        optimizer = torch.optim.Adam(model.parameters(), **kwargs)
    names = dict(model.named_parameters())
    moments = {}
    for key in ("mu", "nu"):
        state = _state_dict(family, adam[key])
        # The tree's parameters the port holds as buffers (the conv
        # families' norm_mean/norm_std) have no moments in torch.
        state = {k: v for k, v in state.items() if k in names}
        _check_keys(state, {k: p.detach() for k, p in names.items()},
                    f"opt_state {key}")
        moments[key] = state
    step = torch.tensor(float(adam["count"]), dtype=torch.float32)
    for name, param in names.items():
        optimizer.state[param] = {
            "step": step.clone(),
            "exp_avg": moments["mu"][name].to(param.dtype),
            "exp_avg_sq": moments["nu"][name].to(param.dtype)}
    return optimizer


def convert_orbax_checkpoint(src: str, dst_dir: str, *, family: str,
                             num_classes: int, config: Optional[str] = None,
                             encoder: Optional[str] = None) -> str:
    """A TPU-package Orbax checkpoint ``src`` -> a port checkpoint
    ``dst_dir/epoch=N-step=M`` (``ckpt/io.py``; N from ``src``'s name,
    M its step) of ``{"params", "opt_state", "step"}``, the optimizer
    state where it is Adam's (``optimizer_from_state``). ``config`` names
    vitseg's sweep config or ViT preset, ``encoder`` the other families'
    encoder preset; the input size (vitseg) and segformer's decode width
    are read from the parameters. Returns the new checkpoint's path."""
    from visiontransformer_tpu_torch.models.registry import model_config

    name = config if family == "vitseg" else encoder
    if not name:
        raise ValueError(f"--family {family} needs "
                         f"{'--config' if family == 'vitseg' else '--encoder'}")
    tree = read_orbax_tree(src)
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{src}: no params in the checkpoint's tree")
    cfg = tree_config(family, tree["params"], model_config(
        family, name, num_classes=num_classes), infer_size=True)
    model = model_from_params(family, tree["params"], cfg)
    out = {"params": model.state_dict(),
           "step": int(tree.get("step", 0))}
    if tree.get("opt_state") is not None:
        optimizer = optimizer_from_state(family, tree["opt_state"], model)
        if optimizer is not None:
            out["opt_state"] = optimizer.state_dict()
    return save_checkpoint(dst_dir, out, epoch=parse_epoch(src) or 0,
                           step=out["step"])
