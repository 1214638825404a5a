"""Loss/metric definitions of the training tasks (the TPU package's
``train/tasks.py``).

Each task is a function (model, batch, cfg, generator, deterministic,
attn_impl) -> (loss, metrics dict of 0-dim tensors), mirroring the
Lightning modules of the reference:

- ``ce_loss_fn``              ↔ LightningViTModel (CE)
  (reference model/CE/classes.py:264-297)
- ``smp_multiclass_loss_fn``  ↔ StructuralDamageModel
  (reference model/CE/classes.py:133-198)
- ``paed_multiclass_loss_fn`` ↔ LightningViTModel (PAED flavor)
  (reference model/PAED/classes.py:415-487)
- ``paed_anchored_loss_fn``   CE + the multiclass PAED term (the TPU
  package's own variant)
- ``paed_binary_loss_fn``     ↔ PAEDTrainer._forward_step_paed
  (reference model/PAED/classes.py:664-701)

The tasks take a model of any family (``models/registry.py``) and call
its forward: ``vitseg_apply`` for vitseg, the family's apply for a conv
family, which takes and ignores the dropout and attention arguments (the
TPU package's ``del deterministic, rng``). Batches are dicts of NHWC tensors on the model's device. The binary task
takes binary masks and makes its SDF targets on that device
(``losses/sdf.py``); the reference computes them with scipy in its
dataloader workers (model/PAED/classes.py:69). The metric dicts carry the
TPU package's keys.

Under data parallelism each rank holds its rows of the batch, and
``data_group`` is the group of the data ranks: sums over the batch that a
loss or metric divides (smp_multiclass's tp/fp/fn/tn, paed_anchored's hard
IoU, paed_binary's dice, |PAED| and counts) are then reduced over it
(``parallel/launch.py:global_sum``), so every rank computes the global
batch's value, as the TPU package's mesh computes it over the global
array; a mean over rows needs no reduction here (the trainer averages
those over the ranks).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from visiontransformer_tpu_torch.losses.basic import cross_entropy_loss
from visiontransformer_tpu_torch.losses.paed import (
    paed_binary_total_loss,
    paed_loss_multiclass_soft,
)
from visiontransformer_tpu_torch.losses.sdf import compute_sdf_batch
from visiontransformer_tpu_torch.metrics.segmentation import (
    dice_score_binary,
    iou_binary,
    multiclass_confusion_stats,
    pixel_accuracy_binary,
    precision_binary,
    recall_binary,
    smp_iou_micro,
    smp_iou_micro_imagewise,
    soft_iou_score,
)
from visiontransformer_tpu_torch.ops.resize import resize_nearest_torch
from visiontransformer_tpu_torch.parallel.launch import global_sum


def _resize_target(y: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest-resize integer/binary targets to the model input size:
    torch F.interpolate(mode='nearest') semantics
    (reference model/CE/classes.py:273-274)."""
    return resize_nearest_torch(y, (size, size))


def ce_loss_fn(model, batch, cfg, *,
               generator: Optional[torch.Generator] = None,
               deterministic: bool = False, attn_impl: str = "auto",
               data_group=None):
    """Multiclass CE training step body. batch: images (B,H,W,3) float,
    masks (B,Hm,Wm) int class indices."""
    images, masks = batch["image"], batch["mask"]
    target = _resize_target(masks, images.shape[1])
    logits = model(images, attn_impl=attn_impl,
                   deterministic=deterministic, generator=generator)
    loss = cross_entropy_loss(logits, target)
    return loss, {"loss": loss}


def smp_multiclass_loss_fn(model, batch, cfg, *,
                           generator: Optional[torch.Generator] = None,
                           deterministic: bool = False,
                           attn_impl: str = "auto", data_group=None):
    """CE loss + smp-style aggregate metrics, the StructuralDamageModel
    training contract (reference model/CE/classes.py:133-198): per-step
    tp/fp/fn/tn -> micro / micro-imagewise IoU, accuracy, recall, F1."""
    images, masks = batch["image"], batch["mask"]
    target = _resize_target(masks, images.shape[1])
    logits = model(images, attn_impl=attn_impl,
                   deterministic=deterministic, generator=generator)
    loss = cross_entropy_loss(logits, target)
    preds = torch.argmax(logits, dim=-1)
    tp, fp, fn, tn = multiclass_confusion_stats(preds, target,
                                                cfg.num_classes)
    tp_s, fp_s, fn_s, tn_s = global_sum(torch.stack(
        [x.sum().float() for x in (tp, fp, fn, tn)]), data_group)
    zero = torch.zeros((), device=loss.device)
    accuracy = (tp_s + tn_s) / (tp_s + fp_s + fn_s + tn_s)
    recall = torch.where(tp_s + fn_s > 0,
                         tp_s / torch.clamp(tp_s + fn_s, min=1), zero)
    precision = torch.where(tp_s + fp_s > 0,
                            tp_s / torch.clamp(tp_s + fp_s, min=1), zero)
    f1 = torch.where(precision + recall > 0,
                     2 * precision * recall
                     / torch.clamp(precision + recall, min=1e-12), zero)
    return loss, {
        "loss": loss,
        "per_image_iou": smp_iou_micro_imagewise(tp, fp, fn, tn),
        "dataset_iou": (smp_iou_micro(tp, fp, fn, tn) if data_group is None
                        else tp_s / (tp_s + fp_s + fn_s)),
        "accuracy": accuracy,
        "recall": recall,
        "f1_score": f1,
    }


def _softmax_and_one_hot(model, batch, cfg, generator, deterministic,
                         attn_impl):
    images, masks = batch["image"], batch["mask"]
    target = _resize_target(masks, images.shape[1])
    logits = model(images, attn_impl=attn_impl,
                   deterministic=deterministic, generator=generator)
    probs = torch.softmax(logits, dim=-1)
    one_hot = F.one_hot(target.long(), cfg.num_classes).float()
    return logits, target, probs, torch.argmax(probs, dim=-1), one_hot


def paed_multiclass_loss_fn(model, batch, cfg, *,
                            generator: Optional[torch.Generator] = None,
                            deterministic: bool = False,
                            attn_impl: str = "auto", data_group=None):
    """Multiclass PAED flavor: softmax probabilities against the one-hot
    target under the Gaussian-smoothed PAED loss, plus the monitoring IoU
    (reference model/PAED/classes.py:448-467)."""
    _, target, probs, preds, one_hot = _softmax_and_one_hot(
        model, batch, cfg, generator, deterministic, attn_impl)
    loss = paed_loss_multiclass_soft(one_hot, probs)
    return loss, {"loss": loss,
                  "iou": soft_iou_score(preds, target, cfg.num_classes)}


def paed_anchored_loss_fn(model, batch, cfg, *,
                          generator: Optional[torch.Generator] = None,
                          deterministic: bool = False,
                          attn_impl: str = "auto", data_group=None):
    """CE-anchored multiclass PAED: loss = CE + paed_multiclass_soft. The
    reference's pure-PAED multiclass objective collapses (blurred-space
    match at chance argmax accuracy), so the TPU package anchors it with
    the CE flavor's loss and monitors the soft IoU beside a hard argmax
    mean IoU."""
    logits, target, probs, preds, one_hot = _softmax_and_one_hot(
        model, batch, cfg, generator, deterministic, attn_impl)
    ce = cross_entropy_loss(logits, target)
    paed = paed_loss_multiclass_soft(one_hot, probs)
    loss = ce + paed
    tp, fp, fn, _ = multiclass_confusion_stats(preds, target,
                                               cfg.num_classes)
    union = tp + fp + fn
    ious = torch.where(union > 0, tp / torch.clamp(union, min=1), 0.0).sum()
    present = (union > 0).sum()
    if data_group is not None:
        ious, present = global_sum(torch.stack([ious, present.float()]),
                                   data_group)
    hard_iou = ious / torch.clamp(present, min=1)
    return loss, {"loss": loss, "ce": ce, "paed": paed,
                  "iou": soft_iou_score(preds, target, cfg.num_classes),
                  "hard_iou": hard_iou}


def paed_binary_loss_fn(model, batch, cfg, *,
                        generator: Optional[torch.Generator] = None,
                        deterministic: bool = False,
                        attn_impl: str = "auto", data_group=None):
    """Binary crack task: BCE + 0.1·dice + 5·|paed| with SDF targets made
    on the model's device. batch: images (B,H,W,3), masks (B,H,W) binary
    float; the model has one output class."""
    images, masks = batch["image"], batch["mask"]
    masks = _resize_target(masks, images.shape[1])
    # Targets: no graph (the reference detaches them too,
    # model/PAED/classes.py:569-570).
    sdf_ext, sdf_int = compute_sdf_batch(masks > 0.5)
    logits = model(images, attn_impl=attn_impl,
                   deterministic=deterministic, generator=generator)
    preds = torch.sigmoid(logits)  # (B, H, W, 1)
    loss, parts = paed_binary_total_loss(preds, masks[..., None].float(),
                                         sdf_ext, sdf_int,
                                         data_group=data_group)
    bin_preds = (preds > 0.5).int()[..., 0]
    gt = masks.int()
    metrics = {
        "loss": loss,
        "bce": parts["bce"],
        "dice_loss": parts["dice"],
        "paed": parts["paed"],
        "acc": pixel_accuracy_binary(gt, bin_preds),
    }
    if data_group is None:
        metrics.update(IoU=iou_binary(gt, bin_preds),
                       dice=dice_score_binary(gt, bin_preds),
                       precision=precision_binary(gt, bin_preds),
                       recall=recall_binary(gt, bin_preds))
    else:
        metrics.update(_binary_metrics_global(gt, bin_preds, data_group))
    return loss, metrics


def _binary_metrics_global(gt: torch.Tensor, pred: torch.Tensor,
                           data_group) -> dict:
    """IoU, dice, precision and recall of ``metrics/segmentation.py`` from
    the global batch's pixel counts."""
    g, p = gt.bool(), pred.bool()
    inter, union, n_gt, n_pred, fp, fn = global_sum(torch.stack([
        torch.sum(g & p), torch.sum(g | p), torch.sum(g), torch.sum(p),
        torch.sum(p & ~g), torch.sum(~p & g)]).float(), data_group)
    eps = 1e-6

    def ratio_or_zero(num, denom):
        return torch.where(denom == 0, 0.0, num / torch.clamp(denom, min=1.0))

    return {"IoU": (inter + eps) / (union + eps),
            "dice": (2.0 * inter + eps) / (n_gt + n_pred + eps),
            "precision": ratio_or_zero(inter, inter + fp),
            "recall": ratio_or_zero(inter, inter + fn)}


TASKS = {
    "ce": ce_loss_fn,
    "smp_multiclass": smp_multiclass_loss_fn,
    "paed_multiclass": paed_multiclass_loss_fn,
    "paed_anchored": paed_anchored_loss_fn,
    "paed_binary": paed_binary_loss_fn,
}


def get_task(name: str):
    try:
        return TASKS[name]
    except KeyError:
        raise KeyError(f"unknown task {name!r}; known: "
                       f"{sorted(TASKS)}") from None

