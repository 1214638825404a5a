"""Checkpoints with the reference's naming convention, in the port's format.

Naming and "latest" selection mirror Lightning's ModelCheckpoint as the TPU
package's ``ckpt/io.py`` does (``epoch=N-step=M``, reference
model/CE/trainCurrentViTmodel.py:69; the highest epoch is the latest,
datasetTestViTmodel.py:38-54). A checkpoint is a directory of that name
holding one ``torch.save`` file of plain tensors and containers: the
trainer's tree is ``{"params": model state dict, "opt_state":
optimizer.state_dict(), "step": int}``, every tensor on the CPU, so it
reads back with ``weights_only=True``. The TPU package's Orbax
checkpoints are converted into this format by ``ckpt/orbax_read.py``
(tensorstore, no JAX); the two packages also exchange vitseg weights
through the reference's Lightning ``.ckpt`` (``ckpt/torch_convert.py``).

``restore_checkpoint`` keeps the TPU package's partial-restore semantics:
keys missing on disk keep the target's values, keys on disk that the
target lacks are ignored, params that do not fit raise, an optimizer state
that does not fit warns and keeps the fresh one. A pipeline checkpoint
stores ``backbone.layers`` stacked, one tensor per leaf with a leading
layer axis, and its optimizer state in the same form
(``parallel/state.py``); a restore onto a per-layer target unstacks both,
one onto a stacked target stacks them, so a checkpoint resumes and serves
across modes with its Adam moments. A checkpoint written under a mesh
holds the gathered full state in this same format (``parallel/plan.py``).
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Any, Mapping, Optional

import torch

_FILE = "checkpoint.pt"


def _ckpt_name(epoch: int, step: int) -> str:
    return f"epoch={epoch}-step={step}"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(directory: str, tree: Any, *, epoch: int,
                    step: int) -> str:
    """Write ``tree`` (nested dicts, lists and tuples of tensors, numbers,
    strings and None) as ``directory/epoch=N-step=M``, tensors moved to the
    CPU first; returns the checkpoint's absolute path."""
    path = os.path.abspath(os.path.join(directory, _ckpt_name(epoch, step)))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{_FILE}.{os.getpid()}.tmp")
    torch.save(_to_cpu(tree), tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def _load(path: str):
    file = os.path.join(path, _FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"{path} is not a checkpoint of the port "
                                f"(no {_FILE} in it)")
    return torch.load(file, map_location="cpu", weights_only=True)


def _check_params(disk, target, path: str) -> None:
    """Raise ValueError unless ``disk`` holds exactly the target's keys at
    the target's shapes."""
    if not isinstance(disk, Mapping):
        raise ValueError(f"checkpoint at {path}: params are a "
                         f"{type(disk).__name__}, not a state dict")
    missing, extra = sorted(set(target) - set(disk)), sorted(
        set(disk) - set(target))
    shapes = [f"{k}: {tuple(disk[k].shape)} vs {tuple(t.shape)}"
              for k, t in target.items()
              if k in disk and tuple(disk[k].shape) != tuple(t.shape)]
    if missing or extra or shapes:
        raise ValueError(
            f"checkpoint at {path} does not match the target model's "
            f"parameters: it was written by a different model configuration "
            f"(missing {missing[:4]}, unexpected {extra[:4]}, shapes "
            f"{shapes[:4]})")


def check_optimizer(disk, optimizer: torch.optim.Optimizer,
                    shapes=None) -> None:
    """Raise ValueError unless ``disk`` is a state dict of ``optimizer``'s
    kind: the same groups with the same hyperparameters but the learning
    rate (which the plateau schedule lowers during a run; Adam and AdamW
    differ in their weight decay), over parameters of the same shapes.
    ``shapes``: the full model's parameter shapes in order, where the
    optimizer holds this rank's parts of them (one group)."""
    groups = optimizer.param_groups
    if (not isinstance(disk, Mapping) or set(disk) != {"state", "param_groups"}
            or len(disk["param_groups"]) != len(groups)):
        raise ValueError("not a state dict of this optimizer's groups")
    params = []
    skip = ("params", "lr", "foreach")  # foreach: torch's implementation
    for saved, group in zip(disk["param_groups"], groups):
        hyper = {k: v for k, v in group.items() if k not in skip}
        targets = (group["params"] if shapes is None else
                   [torch.empty(s, device="meta") for s in shapes])
        if ({k: v for k, v in saved.items() if k not in skip}
                != hyper or len(saved["params"]) != len(targets)):
            raise ValueError(f"parameter group {sorted(saved)} does not "
                             f"match {hyper}")
        params += zip(saved["params"], targets)
    for index, param in params:
        for key, value in disk["state"].get(index, {}).items():
            if (isinstance(value, torch.Tensor) and value.dim()
                    and value.shape != param.shape):
                raise ValueError(f"state {key!r} of parameter {index}: "
                                 f"{tuple(value.shape)} vs "
                                 f"{tuple(param.shape)}")


def _restore_key(key: str, disk, target, path: str):
    """The target's value for ``key`` with the checkpoint's written in:
    a flat state dict of tensors is copied into in place (onto the target's
    devices and dtypes), an optimizer loads its state, anything else (the
    step) takes the value on disk."""
    if isinstance(target, torch.optim.Optimizer):
        try:
            check_optimizer(disk, target)
        except ValueError as e:
            warnings.warn(
                f"checkpoint key {key!r} at {path} does not match the "
                f"target optimizer; keeping the freshly-initialized state "
                f"({e})", stacklevel=3)
            return target
        target.load_state_dict(disk)
        return target
    if isinstance(target, Mapping) and all(
            isinstance(t, torch.Tensor) for t in target.values()):
        _check_params(disk, target, path)
        with torch.no_grad():
            for k, t in target.items():
                t.copy_(disk[k])
        return target
    return disk


def restore_checkpoint(path: str, target: Optional[Mapping] = None, *,
                       partial: bool = True) -> Any:
    """Read the checkpoint at ``path`` (always onto the CPU first, never
    onto a device the file names).

    Without a target: the tree as saved, tensors on the CPU. With a dict
    target (for the trainer ``{"params": model.state_dict(), "opt_state":
    optimizer, "step": 0}``): every key present in both is written into the
    target's value (``_restore_key``), so the params land in the target's
    tensors and the optimizer's state on its parameters' device. ``partial``
    (the default) keeps the target's value for a key missing on disk, as
    the TPU package's partial restore does (a params-only checkpoint
    resumes with fresh Adam moments); ``partial=False`` requires the same
    keys on both sides. A params mismatch raises ValueError."""
    path = os.path.abspath(path)
    disk = _load(path)
    if target is None:
        return disk
    if not isinstance(disk, Mapping):
        raise ValueError(f"checkpoint at {path} is not a dict-rooted tree; "
                         f"cannot restore it onto a dict target")
    if not partial and set(disk) != set(target):
        raise ValueError(f"checkpoint at {path} holds keys {sorted(disk)}, "
                         f"the target {sorted(target)}")
    disk = _match_layer_form(disk, target.get("params"))
    return {key: (_restore_key(key, disk[key], value, path)
                  if key in disk else value)
            for key, value in target.items()}


def _match_layer_form(disk: Mapping, target_params) -> Mapping:
    """``disk`` with its params and optimizer state in the layer form of
    ``target_params`` (stacked or per-layer)."""
    from visiontransformer_tpu_torch.parallel.pipeline import is_stacked
    from visiontransformer_tpu_torch.parallel.state import match_layer_form

    if not (isinstance(target_params, Mapping)
            and isinstance(disk.get("params"), Mapping)):
        return disk
    params, opt = match_layer_form(disk["params"], disk.get("opt_state"),
                                   is_stacked(target_params))
    out = {**disk, "params": params}
    if "opt_state" in disk:
        out["opt_state"] = opt
    return out


def get_latest_checkpoint(directory: str) -> Optional[str]:
    """Highest-epoch checkpoint in `directory`, by filename convention
    (the reference's selection rule, datasetTestViTmodel.py:50)."""
    if not os.path.isdir(directory):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(directory):
        m = re.match(r"epoch=(\d+)-step=(\d+)", name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(directory, name)
    return best


def parse_epoch(path: str) -> Optional[int]:
    m = re.search(r"epoch=(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else None
