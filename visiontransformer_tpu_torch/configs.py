"""Typed configuration objects of the ViT segmentation model.

A copy of the TPU package's ``configs.py`` (``ViTConfig``, ``ViTSegConfig``,
the 9-config sweep table and the named size presets) with the same field
names and defaults; ``ViTSegConfig.dtype`` is a ``torch.dtype``. Fields the
port does not use yet (dropout, ``remat``, ``token_merge_r``) are kept so
that one configuration means the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViT backbone hyperparameters.

    Field defaults mirror the reference's HF ViTConfig instantiation
    (reference model/CE/classes.py:224-236): image 224, intermediate 3072,
    qkv_bias True, dropout 0.1, initializer_range 0.02, layer_norm_eps 1e-12
    (HF default).
    """

    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    qkv_bias: bool = True
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    # Per-block rematerialisation and ToMe token merging: options of the
    # TPU package not ported yet (the port's models reject non-defaults).
    remat: bool = False
    token_merge_r: int = 0

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        """Token count including the CLS token (197/785/3137 at 224px)."""
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_attention_heads == 0
        return self.hidden_size // self.num_attention_heads

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class ViTSegConfig:
    """Full segmentation model = ViT backbone + conv seg head.

    Head shape mirrors reference model/CE/classes.py:240-244:
    Conv3x3(hidden->256) + ReLU + Conv1x1(256->num_classes), bilinear upsample
    back to the input resolution (align_corners=False).
    """

    vit: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    num_classes: int = 17
    head_channels: int = 256
    # Computation dtype for the forward pass ("float32" or "bfloat16").
    # Params are always stored fp32 and cast at use.
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class SweepEntry:
    """One row of the reference's 9-config sweep
    (reference model/CE/datasetTestViTmodel.py:97-107)."""

    id: int
    patch_size: int
    hidden_size: int
    hidden_layers: int
    attention_heads: int

    @property
    def name(self) -> str:
        # Naming convention from reference model/CE/datasetTestViTmodel.py:141.
        return f"P{self.patch_size}H{self.hidden_size}A{self.attention_heads}"

    def vit_config(self, **overrides) -> ViTConfig:
        return ViTConfig(
            patch_size=self.patch_size,
            hidden_size=self.hidden_size,
            num_hidden_layers=self.hidden_layers,
            num_attention_heads=self.attention_heads,
            **overrides,
        )

    def seg_config(self, num_classes: int = 17, **overrides) -> ViTSegConfig:
        return ViTSegConfig(vit=self.vit_config(), num_classes=num_classes, **overrides)


# The 9-config sweep, single source of truth
# (reference model/CE/datasetTestViTmodel.py:97-107; ID order preserved).
SWEEP_CONFIGS: Tuple[SweepEntry, ...] = (
    SweepEntry(0, 16, 768, 12, 12),
    SweepEntry(1, 16, 512, 8, 8),
    SweepEntry(2, 16, 1024, 16, 16),
    SweepEntry(3, 8, 512, 8, 8),
    SweepEntry(4, 8, 768, 12, 12),
    SweepEntry(5, 8, 1024, 16, 16),
    SweepEntry(6, 4, 512, 8, 8),
    SweepEntry(7, 4, 768, 12, 12),
    SweepEntry(8, 4, 1024, 16, 16),
)


def sweep_by_name(name: str) -> SweepEntry:
    for entry in SWEEP_CONFIGS:
        if entry.name == name:
            return entry
    raise KeyError(f"unknown sweep config {name!r}")


# Standard ViT size presets beyond the reference's sweep (ViT paper table 1
# naming). vit_l_16 is the serving stretch target (BASELINE.json config 5:
# "dynamic-batched worker with ViT-L/16"). Unlike the sweep rows — which
# pin intermediate_size=3072 regardless of width, mirroring the reference's
# ViTConfig instantiation (reference model/CE/classes.py:228) — these use
# the paper's 4*hidden MLP widths.
VIT_PRESETS = {
    "vit_b_16": dict(patch_size=16, hidden_size=768, num_hidden_layers=12,
                     num_attention_heads=12, intermediate_size=3072),
    "vit_l_16": dict(patch_size=16, hidden_size=1024, num_hidden_layers=24,
                     num_attention_heads=16, intermediate_size=4096),
    "vit_h_14": dict(patch_size=14, hidden_size=1280, num_hidden_layers=32,
                     num_attention_heads=16, intermediate_size=5120),
}


def vit_config_by_name(name: str, **overrides) -> ViTConfig:
    """ViTConfig from a sweep row name ("P16H768A12") or a named size
    preset ("vit_b_16" / "vit_l_16" / "vit_h_14")."""
    try:
        return sweep_by_name(name).vit_config(**overrides)
    except KeyError:
        pass
    if name in VIT_PRESETS:
        return ViTConfig(**{**VIT_PRESETS[name], **overrides})
    known = [e.name for e in SWEEP_CONFIGS] + sorted(VIT_PRESETS)
    raise KeyError(f"unknown ViT config {name!r}; known: {known}")
