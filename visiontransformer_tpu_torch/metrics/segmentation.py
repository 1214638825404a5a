"""Segmentation metrics with the reference's conventions (the TPU
package's ``metrics/segmentation.py``):

1. The evaluation sweep's per-image metrics (reference
   model/CE/datasetTestViTmodel.py:188-227): accuracy as a percent of
   matching pixels, per-class IoU with NaN for an empty union then a
   nanmean, Dice with NaN where both masks lack the class. These take one
   (H, W) image or a batch (..., H, W) and reduce over the last two axes.
2. The binary PAED metrics (reference model/PAED/segmentation.py:38-86):
   accuracy, IoU and Dice with eps = 1e-6, over the whole tensor; precision
   and recall 0 where their denominator is 0.
3. The smp-style multiclass stats (reference model/CE/classes.py:145,
   182-196), with smp's NaN for a pooled IoU whose union is empty.
4. The pixel confusion matrix, whose scatter keeps the TPU package's
   index rules: a negative index counts from the end, one still out of
   range is dropped; and the PAED multiclass monitoring IoU
   (model/PAED/classes.py:430-447).
"""

from __future__ import annotations

from typing import Tuple

import torch


# ------------------------------------------------ sweep per-image metrics
def pixel_accuracy_percent(gt: torch.Tensor, pred: torch.Tensor
                           ) -> torch.Tensor:
    """100 · (1 − mismatches / pixels) per image (reference
    datasetTestViTmodel.py:193-196)."""
    mismatches = torch.sum(gt != pred, dim=(-2, -1))
    return 100.0 * (1.0 - mismatches / (gt.shape[-2] * gt.shape[-1]))


def _class_maps(gt: torch.Tensor, pred: torch.Tensor, num_classes: int):
    classes = torch.arange(num_classes, device=gt.device)[:, None, None]
    return gt[..., None, :, :] == classes, pred[..., None, :, :] == classes


def per_class_iou(gt: torch.Tensor, pred: torch.Tensor,
                  num_classes: int) -> torch.Tensor:
    """(..., C) IoU; NaN where the union is empty (reference
    datasetTestViTmodel.py:200-205)."""
    gt_bin, pred_bin = _class_maps(gt, pred, num_classes)
    inter = torch.sum(gt_bin & pred_bin, dim=(-2, -1)).float()
    union = torch.sum(gt_bin | pred_bin, dim=(-2, -1)).float()
    return torch.where(union == 0, torch.nan,
                       inter / torch.clamp(union, min=1.0))


def per_class_dice(gt: torch.Tensor, pred: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """(..., C) Dice; NaN where gt and pred both lack the class (reference
    datasetTestViTmodel.py:152-159)."""
    gt_bin, pred_bin = _class_maps(gt, pred, num_classes)
    inter = torch.sum(gt_bin & pred_bin, dim=(-2, -1)).float()
    size_sum = (torch.sum(gt_bin, dim=(-2, -1))
                + torch.sum(pred_bin, dim=(-2, -1))).float()
    return torch.where(size_sum == 0, torch.nan,
                       2.0 * inter / torch.clamp(size_sum, min=1.0))


def per_image_eval_metrics(gt: torch.Tensor, pred: torch.Tensor,
                           num_classes: int):
    """(accuracy %, mean IoU, mean Dice) per image: the three numeric
    columns of the reference's metrics CSV (datasetTestViTmodel.py:
    219-227)."""
    return (pixel_accuracy_percent(gt, pred),
            torch.nanmean(per_class_iou(gt, pred, num_classes), dim=-1),
            torch.nanmean(per_class_dice(gt, pred, num_classes), dim=-1))


# ---------------------------------------------------- binary PAED metrics
def pixel_accuracy_binary(gt: torch.Tensor, pred: torch.Tensor
                          ) -> torch.Tensor:
    """Fraction of matching pixels (reference segmentation.py:38-51)."""
    return torch.mean((gt.int() == pred.int()).float())


def iou_binary(gt: torch.Tensor, pred: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """(I + eps) / (U + eps) (reference segmentation.py:54-69)."""
    gt, pred = gt.bool(), pred.bool()
    inter = torch.sum(gt & pred).float()
    union = torch.sum(gt | pred).float()
    return (inter + eps) / (union + eps)


def dice_score_binary(gt: torch.Tensor, pred: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """(2I + eps) / (|gt| + |pred| + eps) (reference segmentation.py:
    72-86)."""
    gt, pred = gt.bool(), pred.bool()
    inter = torch.sum(gt & pred).float()
    total = torch.sum(gt).float() + torch.sum(pred).float()
    return (2.0 * inter + eps) / (total + eps)


def binary_stats(gt: torch.Tensor, pred: torch.Tensor):
    """Global tp/fp/fn/tn of binary masks, the basis of the reference's
    torchmetrics precision/recall (model/PAED/classes.py:688-689,
    task='binary', multidim_average='global')."""
    gt, pred = gt.bool(), pred.bool()
    return (torch.sum(pred & gt), torch.sum(pred & ~gt),
            torch.sum(~pred & gt), torch.sum(~pred & ~gt))


def _ratio_or_zero(num: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    denom = denom.float()
    return torch.where(denom == 0, 0.0, num / torch.clamp(denom, min=1.0))


def precision_binary(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    tp, fp, _, _ = binary_stats(gt, pred)
    return _ratio_or_zero(tp, tp + fp)


def recall_binary(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    tp, _, fn, _ = binary_stats(gt, pred)
    return _ratio_or_zero(tp, tp + fn)


# ------------------------------------------------ smp multiclass metrics
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


# --------------------------------------------- confusion, monitoring IoU
def scatter_count(index: torch.Tensor, size: int) -> torch.Tensor:
    """(size,) int64 counts of ``index``'s values under the TPU package's
    scatter rules (``zeros(size).at[index].add(1)``): a negative index
    counts from the end, and one still outside [0, size) is dropped."""
    index = index.reshape(-1).long()
    index = torch.where(index < 0, index + size, index)
    keep = (index >= 0) & (index < size)
    return torch.bincount(index[keep], minlength=size)


def pixel_confusion_matrix(gt: torch.Tensor, pred: torch.Tensor,
                           num_classes: int) -> torch.Tensor:
    """(C, C) pixel counts M[i, j] of GT class i predicted as j."""
    index = gt.long().reshape(-1) * num_classes + pred.long().reshape(-1)
    return scatter_count(index, num_classes * num_classes).reshape(
        num_classes, num_classes)


def soft_iou_score(preds: torch.Tensor, targets: torch.Tensor,
                   num_classes: int = 17) -> torch.Tensor:
    """Mean over classes of the batch-mean smoothed IoU, the reference's
    LightningViTModel.iou_score: per class (I + 1e-6) / (clip(union, 0,
    1).sum() + 1e-6)."""
    classes = torch.arange(num_classes, device=preds.device)
    preds_oh = (preds[..., None] == classes).float()  # (B, H, W, C)
    targets_oh = (targets[..., None] == classes).float()
    inter = torch.sum(preds_oh * targets_oh, dim=(1, 2))  # (B, C)
    union = torch.sum(torch.clamp(preds_oh + targets_oh, 0.0, 1.0),
                      dim=(1, 2))
    return torch.mean(torch.mean((inter + 1e-6) / (union + 1e-6), dim=0))
