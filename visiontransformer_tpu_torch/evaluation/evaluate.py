"""Evaluation sweep over the 9 model configurations (the TPU package's
``evaluation/evaluate.py``; reference model/CE/datasetTestViTmodel.py and
its PAED mirror ViTscriptTest.py).

Per image it records accuracy, mean IoU, mean Dice, the inference time and
the GT / predicted / missing / false-positive class sets, one CSV per model
in the reference's schema (datasetTestViTmodel.py:166-172), byte for byte
the TPU package's, so the reference's aggregation reads it; beside it, the
pixel confusion matrix as ``<name>_pixel_confusion.npy``. The forward runs
under ``torch.no_grad`` (the inference attention kernel on the card), and
the metrics are computed on the model's device for the whole batch.

As in the TPU package, the sweep instantiates the config it reports (the
reference's PAED sweep pins one config for all 9 rows,
ViTscriptTest.py:126) and a checkpoint is a plain restore, not the
reference's fit-to-max-epochs trick (datasetTestViTmodel.py:131-137). A
checkpoint is the port's ``epoch=N-step=M`` directory under
``<checkpoint_root>/<name>/`` (a TPU-package Orbax checkpoint goes through
``convert-orbax`` first, ``ckpt/orbax_read.py``).
"""

from __future__ import annotations

import csv
import dataclasses
import os
import time
from typing import Iterable, List, Optional, Union

import numpy as np
import torch

from visiontransformer_tpu_torch.configs import (
    SWEEP_CONFIGS,
    SweepEntry,
    ViTSegConfig,
)
from visiontransformer_tpu_torch.data.pipeline import batch_iterator
from visiontransformer_tpu_torch.device import resolve_device
from visiontransformer_tpu_torch.metrics.segmentation import (
    per_image_eval_metrics,
    pixel_confusion_matrix,
    scatter_count,
)
from visiontransformer_tpu_torch.models.vitseg import ViTSeg, vitseg_apply
from visiontransformer_tpu_torch.ops.resize import resize_nearest_pil

CSV_HEADER = [
    "Model_ID", "Model_Name", "Patch_Size", "Hidden_Size", "Layers", "Heads",
    "Batch_Num", "Image_Idx",
    "Accuracy", "Mean_IoU", "Mean_Dice", "Inference_Time",
    "GT_Classes", "Pred_Classes", "Missing_Classes", "False_Positive_Classes",
]


def class_presence(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, num_classes) bool: which classes occur in each image of (B, H,
    W) ``x``, under the TPU package's scatter rules (a negative class
    counts from the end, one still out of range is dropped)."""
    b = x.shape[0]
    index = x.reshape(b, -1).long()
    index = torch.where(index < 0, index + num_classes, index)
    index = torch.where((index >= 0) & (index < num_classes), index,
                        num_classes)   # one spare bin per image, cut below
    offsets = torch.arange(b, device=x.device)[:, None] * (num_classes + 1)
    counts = scatter_count(index + offsets, b * (num_classes + 1))
    return counts.reshape(b, num_classes + 1)[:, :num_classes] > 0


def _make_eval_fn(cfg: ViTSegConfig):
    """The sweep's batch function: forward, then argmax (or, for the
    binary PAED models, sigmoid > 0.5 with classes {0, 1}), the ground
    truth brought to the prediction grid with PIL-NEAREST indices (the
    reference resizes it with PIL, datasetTestViTmodel.py:191), the
    per-image metrics, the class sets and the batch's confusion matrix."""
    binary = cfg.num_classes == 1
    num_classes = 2 if binary else cfg.num_classes
    size = cfg.vit.image_size

    @torch.no_grad()
    def eval_batch(model: ViTSeg, images: torch.Tensor, masks: torch.Tensor):
        logits = vitseg_apply(model, images)
        if binary:
            preds = (torch.sigmoid(logits[..., 0]) > 0.5).int()
        else:
            preds = torch.argmax(logits, dim=-1).int()
        gt = resize_nearest_pil(masks, (size, size)).int()
        acc, miou, mdice = per_image_eval_metrics(gt, preds, num_classes)
        return preds, (acc, miou, mdice, class_presence(gt, num_classes),
                       class_presence(preds, num_classes)), \
            pixel_confusion_matrix(gt, preds, num_classes)

    return eval_batch


def evaluate_model(model: ViTSeg, cfg: ViTSegConfig, entry: SweepEntry,
                   dataset, *, output_dir: str, batch_size: int = 4,
                   num_batches: int = 125,
                   save_visualizations: bool = False,
                   class_names: Optional[List[str]] = None,
                   rgb_to_class: Optional[dict] = None) -> str:
    """Evaluate one config over ``num_batches`` batches on the model's
    device; returns the CSV path. Inference_Time is the batch's seconds
    per image up to the predictions' readback to the host.
    save_visualizations: the 5-panel PNG of every image of batches 0-25
    (``visualize.save_eval_panels``, drawn with ``class_names`` and the
    classdict's colours ``rgb_to_class``), as the TPU package writes them;
    it needs matplotlib."""
    device = next(model.parameters()).device
    model_dir = os.path.join(output_dir, entry.name)
    os.makedirs(model_dir, exist_ok=True)
    csv_path = os.path.join(model_dir, f"{entry.name}_metrics.csv")

    eval_batch = _make_eval_fn(cfg)
    confusion = None
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(CSV_HEADER)
        for batch_num, batch in enumerate(
                batch_iterator(dataset, batch_size, drop_last=False)):
            if batch_num >= num_batches:
                break
            images = torch.from_numpy(batch["image"]).to(device)
            masks = torch.from_numpy(batch["mask"]).to(device)

            t0 = time.perf_counter()
            preds, (acc, miou, mdice, gt_present, pred_present), cm = (
                eval_batch(model, images, masks))
            cm = cm.cpu().numpy().astype(np.int64)
            confusion = cm if confusion is None else confusion + cm
            preds = preds.cpu().numpy()  # the full readback ends the timing
            avg_time = (time.perf_counter() - t0) / images.shape[0]

            acc, miou, mdice, gt_present, pred_present = (
                t.cpu().numpy() for t in (acc, miou, mdice, gt_present,
                                          pred_present))
            for idx in range(images.shape[0]):
                gt_cls = np.flatnonzero(gt_present[idx]).tolist()
                pr_cls = np.flatnonzero(pred_present[idx]).tolist()
                missing = sorted(set(gt_cls) - set(pr_cls))
                false_pos = sorted(set(pr_cls) - set(gt_cls))
                writer.writerow([
                    entry.id, entry.name, entry.patch_size, entry.hidden_size,
                    entry.hidden_layers, entry.attention_heads,
                    batch_num, idx,
                    float(acc[idx]), float(miou[idx]), float(mdice[idx]),
                    avg_time,
                    "|".join(map(str, gt_cls)),
                    "|".join(map(str, pr_cls)),
                    "|".join(map(str, missing)),
                    "|".join(map(str, false_pos)),
                ])

            if save_visualizations and batch_num <= 25:
                from visiontransformer_tpu_torch.evaluation.visualize import (
                    save_eval_panels,
                )
                save_eval_panels(
                    model_dir, entry.name, batch_num, batch["image"],
                    batch["mask"], preds, class_names=class_names,
                    rgb_to_class=rgb_to_class)

    if confusion is not None:
        np.save(os.path.join(model_dir, f"{entry.name}_pixel_confusion.npy"),
                confusion)
    return csv_path


def sweep_model(entry: SweepEntry, *, num_classes: int,
                checkpoint_root: Optional[str] = None,
                compute_dtype: str = "bfloat16", image_size: int = 224,
                device: Optional[Union[str, torch.device]] = None):
    """(cfg, model) of one sweep entry in eval mode on ``device`` (None
    means CUDA): weights from ``init_vitseg_`` with a generator seeded with
    ``entry.id``, then the latest checkpoint under
    ``<checkpoint_root>/<entry.name>/`` when there is one."""
    from visiontransformer_tpu_torch.ckpt.io import (
        get_latest_checkpoint,
        restore_checkpoint,
    )
    from visiontransformer_tpu_torch.models.registry import init_vitseg_

    dev = resolve_device(device)
    cfg = entry.seg_config(num_classes=num_classes,
                           compute_dtype=compute_dtype)
    cfg = dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, image_size=image_size))
    model = init_vitseg_(ViTSeg(cfg), torch.Generator().manual_seed(entry.id))
    latest = (get_latest_checkpoint(os.path.join(checkpoint_root, entry.name))
              if checkpoint_root else None)
    if latest:
        restore_checkpoint(latest, {"params": model.state_dict()})
    return cfg, model.to(dev).eval()


def run_sweep(dataset, *, output_dir: str, num_classes: int,
              checkpoint_root: Optional[str] = None,
              entries: Iterable[SweepEntry] = SWEEP_CONFIGS,
              batch_size: int = 4, num_batches: int = 125,
              compute_dtype: str = "bfloat16", image_size: int = 224,
              device: Optional[Union[str, torch.device]] = None,
              **eval_kwargs) -> List[str]:
    """The 9-config sweep (or ``entries``): each entry's model from
    ``sweep_model``, evaluated by ``evaluate_model``; returns the CSV
    paths."""
    paths = []
    for entry in entries:
        cfg, model = sweep_model(entry, num_classes=num_classes,
                                 checkpoint_root=checkpoint_root,
                                 compute_dtype=compute_dtype,
                                 image_size=image_size, device=device)
        paths.append(evaluate_model(model, cfg, entry, dataset,
                                    output_dir=output_dir,
                                    batch_size=batch_size,
                                    num_batches=num_batches, **eval_kwargs))
        del model
    return paths
