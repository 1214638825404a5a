"""Training state: the model, its optimizer and the optimizer-step count.

The TPU package's ``TrainState`` is an immutable pytree that flows through
a jitted step; here the step updates the model's parameters and the
optimizer's moments in place (no second copy of either) and returns the
same object.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module  # a model of any family (models/registry.py)
    optimizer: torch.optim.Optimizer
    step: int = 0
