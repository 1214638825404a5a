"""Loss/metric definitions of the training tasks (the TPU package's
``train/tasks.py``).

Each task is a function (model, batch, cfg, generator, deterministic,
attn_impl) -> (loss, metrics dict of 0-dim tensors), mirroring the
Lightning modules of the reference:

- ``ce_loss_fn``              ↔ LightningViTModel (CE)
  (reference model/CE/classes.py:264-297)
- ``smp_multiclass_loss_fn``  ↔ StructuralDamageModel
  (reference model/CE/classes.py:133-198)

The three PAED tasks (``paed_multiclass``, ``paed_anchored``,
``paed_binary``) need the PAED losses, the on-device EDT and the binary
metrics, which are not ported yet (ROADMAP §1 item 7); asking for one
raises. Batches are dicts of NHWC tensors on the model's device.
"""

from __future__ import annotations

from typing import Optional

import torch

from visiontransformer_tpu_torch.losses.basic import cross_entropy_loss
from visiontransformer_tpu_torch.metrics.segmentation import (
    multiclass_confusion_stats,
    smp_iou_micro,
    smp_iou_micro_imagewise,
)
from visiontransformer_tpu_torch.models.vitseg import vitseg_apply
from visiontransformer_tpu_torch.ops.resize import resize_nearest_torch

PAED_TASKS = ("paed_multiclass", "paed_anchored", "paed_binary")


def _resize_target(y: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest-resize integer/binary targets to the model input size:
    torch F.interpolate(mode='nearest') semantics
    (reference model/CE/classes.py:273-274)."""
    return resize_nearest_torch(y, (size, size))


def ce_loss_fn(model, batch, cfg, *,
               generator: Optional[torch.Generator] = None,
               deterministic: bool = False, attn_impl: str = "auto"):
    """Multiclass CE training step body. batch: images (B,H,W,3) float,
    masks (B,Hm,Wm) int class indices."""
    images, masks = batch["image"], batch["mask"]
    target = _resize_target(masks, images.shape[1])
    logits = vitseg_apply(model, images, attn_impl=attn_impl,
                          deterministic=deterministic, generator=generator)
    loss = cross_entropy_loss(logits, target)
    return loss, {"loss": loss}


def smp_multiclass_loss_fn(model, batch, cfg, *,
                           generator: Optional[torch.Generator] = None,
                           deterministic: bool = False,
                           attn_impl: str = "auto"):
    """CE loss + smp-style aggregate metrics, the StructuralDamageModel
    training contract (reference model/CE/classes.py:133-198): per-step
    tp/fp/fn/tn -> micro / micro-imagewise IoU, accuracy, recall, F1."""
    images, masks = batch["image"], batch["mask"]
    target = _resize_target(masks, images.shape[1])
    logits = vitseg_apply(model, images, attn_impl=attn_impl,
                          deterministic=deterministic, generator=generator)
    loss = cross_entropy_loss(logits, target)
    preds = torch.argmax(logits, dim=-1)
    tp, fp, fn, tn = multiclass_confusion_stats(preds, target,
                                                cfg.num_classes)
    tp_s, fp_s, fn_s, tn_s = (x.sum().float() for x in (tp, fp, fn, tn))
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
        "dataset_iou": smp_iou_micro(tp, fp, fn, tn),
        "accuracy": accuracy,
        "recall": recall,
        "f1_score": f1,
    }


TASKS = {
    "ce": ce_loss_fn,
    "smp_multiclass": smp_multiclass_loss_fn,
}


def get_task(name: str):
    if name in PAED_TASKS:
        raise NotImplementedError(
            f"task {name!r} is not ported yet: the PAED losses, EDT and "
            f"binary metrics are ROADMAP §1 item 7")
    try:
        return TASKS[name]
    except KeyError:
        raise KeyError(f"unknown task {name!r}; known: "
                       f"{sorted(TASKS) + list(PAED_TASKS)}") from None
