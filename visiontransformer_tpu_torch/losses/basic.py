"""Cross-entropy / BCE / Dice losses matching torch arithmetic (the TPU
package's ``losses/basic.py``).

- ``cross_entropy_loss``: torch nn.CrossEntropyLoss over per-pixel class
  logits (reference model/CE/classes.py:268,280): mean over every pixel of
  -log softmax[target].
- ``binary_cross_entropy``: torch F.binary_cross_entropy *on probabilities*
  (reference model/PAED/classes.py:679), including torch's clamp of each log
  term at -100.
- ``dice_loss``: PAEDTrainer.dice_loss (reference model/PAED/classes.py:608-620):
  flatten everything, 1 - (2I + s)/(sum_p + sum_t + s). Under data
  parallelism (``data_group``) the sums are the global batch's.
"""

from __future__ import annotations

import torch

from visiontransformer_tpu_torch.parallel.launch import global_sum


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE. logits: (..., num_classes) float; targets: (...) int."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(log_probs, -1, targets.long().unsqueeze(-1))
    return nll.mean()


def binary_cross_entropy(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch F.binary_cross_entropy on probabilities, log terms clamped at
    -100 (torch's documented behavior for p=0 or p=1)."""
    probs, targets = probs.float(), targets.float()
    log_p = torch.clamp(torch.log(probs), min=-100.0)
    log_1p = torch.clamp(torch.log1p(-probs), min=-100.0)
    return -torch.mean(targets * log_p + (1.0 - targets) * log_1p)


def dice_loss(preds: torch.Tensor, targets: torch.Tensor,
              smooth: float = 1e-6, *, data_group=None) -> torch.Tensor:
    """Global (all pixels, all batch) soft Dice loss
    (reference model/PAED/classes.py:608-620); ``data_group``: sum over
    the data-parallel ranks' rows too."""
    preds = preds.float().reshape(-1)
    targets = targets.float().reshape(-1)
    inter = torch.sum(preds * targets)
    p_sum, t_sum = preds.sum(), targets.sum()
    if data_group is not None:
        inter, p_sum, t_sum = global_sum(torch.stack([inter, p_sum, t_sum]),
                                         data_group)
    return 1.0 - (2.0 * inter + smooth) / (p_sum + t_sum + smooth)
