"""Named models: the vitseg part of the TPU package's
``models/registry.py:resolve_model``. The conv families and checkpoint
loading are not ported yet."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

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
    """(cfg, model) for a named vitseg model with random weights from a
    generator seeded with 0 (the same weights on every call, like the TPU
    package's PRNGKey(0)), in eval mode on ``device`` (None means CUDA;
    raises without it)."""
    dev = resolve_device(device)
    if family != "vitseg":
        raise KeyError(f"model family {family!r} is not ported yet; "
                       f"known: ['vitseg']")
    if checkpoint_path:
        raise ValueError("checkpoint loading is not ported yet; load weights "
                         "with ckpt.convert.load_jax_params")
    cfg = vitseg_config(config_name, num_classes=num_classes,
                        input_size=input_size, compute_dtype=compute_dtype)
    model = init_vitseg_(ViTSeg(cfg), torch.Generator().manual_seed(0))
    return cfg, model.to(dev).eval()
