"""smp-style multiclass segmentation metrics (the TPU package's
``metrics/segmentation.py:133-165``, reference model/CE/classes.py:145,
182-196), with its NaN conventions: a pooled IoU whose union is empty is
0/0 = NaN, as smp computes it without zero_division handling."""

from __future__ import annotations

from typing import Tuple

import torch


def multiclass_confusion_stats(pred: torch.Tensor, gt: torch.Tensor,
                               num_classes: int
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor, torch.Tensor]:
    """Per-image, per-class (tp, fp, fn, tn), matching
    smp.metrics.get_stats(mode='multiclass'). Shapes: (B, num_classes)."""
    classes = torch.arange(num_classes, device=pred.device)
    pred_oh = pred.unsqueeze(-1) == classes  # (B, H, W, C)
    gt_oh = gt.unsqueeze(-1) == classes
    axes = tuple(range(1, pred.dim()))
    tp = torch.sum(pred_oh & gt_oh, dim=axes)
    fp = torch.sum(pred_oh & ~gt_oh, dim=axes)
    fn = torch.sum(~pred_oh & gt_oh, dim=axes)
    tn = torch.sum(~pred_oh & ~gt_oh, dim=axes)
    return tp, fp, fn, tn


def smp_iou_micro(tp, fp, fn, tn) -> torch.Tensor:
    """smp.metrics.iou_score(reduction='micro'): pool everything then IoU."""
    tp_s, fp_s, fn_s = (x.sum().float() for x in (tp, fp, fn))
    return tp_s / (tp_s + fp_s + fn_s)


def smp_iou_micro_imagewise(tp, fp, fn, tn) -> torch.Tensor:
    """smp 'micro-imagewise': pool classes per image, IoU per image, mean."""
    tp_i, fp_i, fn_i = (x.sum(-1).float() for x in (tp, fp, fn))
    return torch.mean(tp_i / (tp_i + fp_i + fn_i))
