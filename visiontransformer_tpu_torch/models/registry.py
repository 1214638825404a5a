"""Named models: the vitseg part of the TPU package's
``models/registry.py:resolve_model``, with its checkpoint loading (a port
checkpoint directory or a reference Lightning ``.ckpt``). The conv
families are not ported yet."""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch

from visiontransformer_tpu_torch.ckpt.io import restore_checkpoint
from visiontransformer_tpu_torch.ckpt.torch_convert import (
    load_lightning_checkpoint,
)
from visiontransformer_tpu_torch.configs import (
    ViTSegConfig,
    sweep_by_name,
    vit_config_by_name,
)
from visiontransformer_tpu_torch.device import resolve_device
from visiontransformer_tpu_torch.models.vitseg import ViTSeg


def vitseg_config(config_name: str, *, num_classes: int,
                  input_size: int = 224,
                  compute_dtype: str = "bfloat16") -> ViTSegConfig:
    """ViTSegConfig from a sweep row name ("P16H768A12") or a named size
    preset ("vit_b_16" / "vit_l_16" / "vit_h_14") at ``input_size``."""
    try:
        vit_cfg = sweep_by_name(config_name).vit_config(image_size=input_size)
    except KeyError:
        vit_cfg = vit_config_by_name(config_name, image_size=input_size)
    if input_size % vit_cfg.patch_size:
        raise ValueError(
            f"input_size {input_size} is not divisible by "
            f"{config_name}'s patch size {vit_cfg.patch_size}")
    return ViTSegConfig(vit=vit_cfg, num_classes=num_classes,
                        compute_dtype=compute_dtype)


def init_vitseg_(model: ViTSeg, generator: torch.Generator) -> ViTSeg:
    """HF-ViT initialisation in place: trunc-normal(initializer_range,
    ±2 std) kernels and embeddings, zero biases, unit LayerNorm scales.
    Same distribution as the TPU package's init, not the same bits."""
    std = model.cfg.vit.initializer_range
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias":
                p.zero_()
            elif leaf == "scale":
                p.fill_(1.0)
            else:  # kernel, cls_token, pos_embed
                torch.nn.init.trunc_normal_(p, std=std, a=-2 * std,
                                            b=2 * std, generator=generator)
    return model


def resolve_model(family: str, config_name: str, *, num_classes: int,
                  input_size: int = 224, compute_dtype: str = "bfloat16",
                  checkpoint_path: str = "",
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Tuple[ViTSegConfig, ViTSeg]:
    """(cfg, model) for a named vitseg model in eval mode on ``device``
    (None means CUDA; raises without it).

    checkpoint_path: a directory is a port checkpoint (``ckpt/io.py``); its
    ``params``, or the whole tree if it has none, load strictly. A path
    ending in ``.ckpt`` is a reference Lightning file
    (``ckpt/torch_convert.py``). Empty means random weights from a
    generator seeded with 0 (the same weights on every call, like the TPU
    package's PRNGKey(0)). Any other path raises: the TPU package falls
    through to random weights there, which would serve random masks under
    a trained model's name. The weights load on the CPU and the model
    moves to the device once."""
    dev = resolve_device(device)
    if family != "vitseg":
        raise KeyError(f"model family {family!r} is not ported yet; "
                       f"known: ['vitseg']")
    cfg = vitseg_config(config_name, num_classes=num_classes,
                        input_size=input_size, compute_dtype=compute_dtype)
    params = (_checkpoint_params(checkpoint_path, cfg) if checkpoint_path
              else None)
    model = ViTSeg(cfg)
    if params is None:
        init_vitseg_(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(params, strict=True)
    return cfg, model.to(dev).eval()


def _checkpoint_params(path: str, cfg: ViTSegConfig):
    if os.path.isdir(path):
        tree = restore_checkpoint(path)
        return tree["params"] if "params" in tree else tree
    if path.endswith(".ckpt"):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"checkpoint {path} does not exist")
        return load_lightning_checkpoint(path, cfg)
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint {path} does not exist")
    raise ValueError(f"checkpoint {path} is neither a checkpoint directory "
                     f"nor a reference .ckpt file")
