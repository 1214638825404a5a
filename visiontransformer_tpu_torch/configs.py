"""Typed configuration objects of the ViT segmentation model.

A copy of the TPU package's ``configs.py`` (``ViTConfig``, ``ViTSegConfig``,
the 9-config sweep table, the named size presets, ``TrainConfig`` and the
CE/PAED training defaults) with the same field names and defaults;
``ViTSegConfig.dtype`` is a ``torch.dtype``. The mesh and parallelism
fields of ``TrainConfig`` mean what they mean there; the port's trainer
applies them over a torch.distributed job (``parallel/plan.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    # Per-block rematerialisation (training memory) and ToMe token merging
    # (opt-in serving speed, tokens merged per layer; models/vit.py).
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the TPU package's ``TrainConfig``).

    Defaults mirror the CE driver (reference model/CE/createViTmodel.py:57-77):
    Adam lr=1e-5, max_epochs=100, EarlyStopping(valid_loss, patience=3).
    ``batch_size`` is the optimizer batch and ``accumulate_grad_batches``
    the number of micro-batches it is split into: batch_size=16,
    accumulate=4 is the reference's schedule (loader batch 4, accumulate 4).
    The PAED binary trainer overrides (reference
    model/PAED/classes.py:536-548): AdamW lr=1e-4 + ReduceLROnPlateau
    (patience=30) monitoring val_IoU.
    """

    batch_size: int = 16
    learning_rate: float = 1e-5
    optimizer: str = "adam"  # "adam" | "adamw"
    weight_decay: float = 0.01  # torch AdamW default, used when optimizer="adamw"
    accumulate_grad_batches: int = 4
    remat: bool = False
    max_epochs: int = 100
    early_stopping_monitor: Optional[str] = "valid_loss"
    early_stopping_patience: int = 3
    early_stopping_mode: str = "min"
    plateau_patience: Optional[int] = None  # ReduceLROnPlateau patience, None = off
    plateau_monitor: str = "val_IoU"
    plateau_mode: str = "max"
    plateau_factor: float = 0.1  # torch ReduceLROnPlateau default
    seed: int = 42
    log_every_n_steps: int = 50
    checkpoint_dir: Optional[str] = None
    # Mesh, FSDP, sequence and pipeline parallelism (parallel/plan.py).
    mesh_shape: Optional[Tuple[int, ...]] = None
    fsdp: bool = False
    fsdp_min_size: Optional[int] = None
    seq_parallel: bool = False
    pipeline_stages: int = 1
    pipeline_microbatches: Optional[int] = None


CE_TRAIN_DEFAULTS = TrainConfig()

PAED_TRAIN_DEFAULTS = TrainConfig(
    learning_rate=1e-4,
    optimizer="adamw",
    early_stopping_monitor="val_loss",
    early_stopping_patience=6,  # reference model/PAED/ViTscript.py:70
    plateau_patience=30,
    plateau_monitor="val_IoU",
    plateau_mode="max",
)
