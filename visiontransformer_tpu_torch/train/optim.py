"""Optimizers and LR scheduling (the TPU package's ``train/optim.py``).

The reference's optimizer setups, as torch optimizers:
- CE:   Adam lr=1e-5 (reference model/CE/classes.py:296-297)
- PAED multiclass: Adam lr=1e-4 (reference model/PAED/classes.py:486-487)
- PAED binary: AdamW lr=1e-4 + ReduceLROnPlateau(patience=30) on val_IoU
  (reference model/PAED/classes.py:536-548)

torch's Adam/AdamW and optax's adam/adamw share update arithmetic at the
default betas and eps; AdamW's decoupled weight decay (default 1e-2) applies
to every parameter, as optax.adamw with no mask does.

``PlateauScheduler`` (torch ReduceLROnPlateau semantics: mode min/max,
relative threshold 1e-4, cooldown 0, factor 0.1) and ``EarlyStopping``
(Lightning's, min_delta 0) are host-side objects, copied; the trainer
applies a new LR with ``set_learning_rate``.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from visiontransformer_tpu_torch.configs import TrainConfig


def build_optimizer(cfg: TrainConfig,
                    params: Iterable[torch.nn.Parameter], *,
                    foreach: Optional[bool] = None
                    ) -> torch.optim.Optimizer:
    """Gradient accumulation is the trainer's (summed micro-batch
    gradients, scaled by 1/accum before the step), not the optimizer's.
    ``foreach``: torch's implementation flag (False where FSDP's sharded
    parameters and plain ones share the group, which the multi-tensor
    kernels refuse)."""
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate,
                                foreach=foreach)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=cfg.learning_rate,
                                 weight_decay=cfg.weight_decay,
                                 foreach=foreach)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer,
                      learning_rate: float) -> torch.optim.Optimizer:
    for group in optimizer.param_groups:
        group["lr"] = learning_rate
    return optimizer


class PlateauScheduler:
    """torch ReduceLROnPlateau: shrink LR by `factor` after `patience`
    epochs without `threshold`-relative improvement of the monitored metric."""

    def __init__(self, initial_lr: float, mode: str = "min",
                 factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.lr = initial_lr
        self.best: Optional[float] = None
        self.num_bad_epochs = 0

    def _is_better(self, current: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return current < self.best * (1.0 - self.threshold)
        return current > self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        """Feed one epoch's monitored value; returns the (possibly reduced) LR."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr


class EarlyStopping:
    """Lightning-style EarlyStopping(monitor, patience) with min_delta=0
    (reference model/CE/createViTmodel.py:65, model/PAED/ViTscript.py:70)."""

    def __init__(self, patience: int = 3, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.num_bad_epochs = 0

    def step(self, metric: float) -> bool:
        """Returns True when training should stop."""
        improved = (self.best is None
                    or (self.mode == "min" and metric < self.best)
                    or (self.mode == "max" and metric > self.best))
        if improved:
            self.best = metric
            self.num_bad_epochs = 0
            return False
        self.num_bad_epochs += 1
        return self.num_bad_epochs >= self.patience
