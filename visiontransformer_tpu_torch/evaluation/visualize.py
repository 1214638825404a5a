"""Evaluation visualizations (a copy of the TPU package's
``evaluation/visualize.py``).

Rebuilds the reference's matplotlib reporting surface:
- 5-panel per-image figures — input / colored GT with legend / colored
  prediction with legend / mismatch highlight with error stats / predicted
  regions with per-class bounding boxes
  (reference model/CE/datasetTestViTmodel.py:229-335);
- training-curve plots from the CSV logs
  (reference model/CE/datasetTestViTmodel.py:337-358);
- 4-panel single-image demo composite (reference model/CE/testViTModel.py:146-196).

matplotlib and pandas are imported by the functions that draw, never when
the module is imported: the palettes serve masks on hosts without them.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from visiontransformer_tpu_torch.ops.morphology import bounding_boxes_np


def pyplot():
    """matplotlib.pyplot on the Agg backend (files only, no display)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def class_color_table(rgb_to_class: Optional[Dict[Tuple[int, int, int], int]],
                      num_classes: int) -> np.ndarray:
    """(num_classes, 3) uint8 palette from a classdict, or a deterministic
    fallback palette when none is given."""
    table = np.zeros((num_classes, 3), dtype=np.uint8)
    if rgb_to_class:
        for rgb, idx in rgb_to_class.items():
            if idx < num_classes:
                table[idx] = rgb
    else:
        rng = np.random.default_rng(0)
        table[:] = rng.integers(0, 255, (num_classes, 3))
        table[0] = 0
    return table


def colorize(mask: np.ndarray, color_table: np.ndarray) -> np.ndarray:
    return color_table[np.clip(mask, 0, len(color_table) - 1)]


def _legend(ax, classes, color_table, class_names):
    plt = pyplot()
    for i, cls in enumerate(classes):
        name = class_names[cls] if class_names and cls < len(class_names) else str(cls)
        color = color_table[cls] / 255.0
        y = 0.98 - i * 0.05
        ax.add_patch(plt.Rectangle((0.01, y - 0.02), 0.03, 0.025,
                                   transform=ax.transAxes, color=color,
                                   clip_on=False))
        ax.text(0.05, y, f"{cls}: {name}", transform=ax.transAxes,
                fontsize=8, va="top", ha="left", color="white",
                bbox=dict(facecolor="black", alpha=0.5, pad=1,
                          edgecolor="none"))


def draw_boxes(ax, pred: np.ndarray, color_table: np.ndarray,
               class_names: Optional[Sequence[str]],
               skip_background: bool = True) -> None:
    """Connected-component bounding boxes per predicted class."""
    plt = pyplot()
    for cls in np.unique(pred):
        if skip_background and cls == 0:
            continue
        color = color_table[cls] / 255.0
        for (y0, x0, y1, x1) in bounding_boxes_np(pred == cls):
            ax.add_patch(plt.Rectangle((x0, y0), x1 - x0 + 1, y1 - y0 + 1,
                                       edgecolor=color, facecolor="none",
                                       linewidth=2))
            label = (class_names[cls] if class_names and cls < len(class_names)
                     else str(cls))
            ax.text(x0, y0 - 3, label, color=color, fontsize=8, weight="bold",
                    bbox=dict(facecolor="black", alpha=0.5, pad=1,
                              edgecolor="none"))


def save_eval_panels(output_dir: str, model_name: str, batch_num: int,
                     images: np.ndarray, gt_masks: np.ndarray,
                     preds: np.ndarray, *,
                     class_names: Optional[Sequence[str]] = None,
                     rgb_to_class: Optional[dict] = None) -> None:
    """One 5-panel PNG per image in the batch."""
    from matplotlib.colors import ListedColormap
    from PIL import Image

    plt = pyplot()
    num_classes = int(max(preds.max(), gt_masks.max())) + 1
    table = class_color_table(rgb_to_class, max(num_classes, 17))
    size = preds.shape[-1]

    for idx in range(images.shape[0]):
        fig, (ax1, ax2, ax3, ax4, ax5) = plt.subplots(1, 5, figsize=(20, 6))
        fig.suptitle(f"Model: {model_name} - Batch {batch_num} - Image {idx}",
                     fontsize=14)

        ax1.imshow(np.clip(images[idx], 0, 1))
        ax1.set_title("Image")

        gt = gt_masks[idx].astype(np.int32)
        ax2.imshow(colorize(gt, table))
        ax2.set_title("Ground truth")
        _legend(ax2, np.unique(gt), table, class_names)

        pred = preds[idx]
        ax3.imshow(colorize(pred, table))
        ax3.set_title("Prediction")
        _legend(ax3, np.unique(pred), table, class_names)

        gt_resized = np.asarray(Image.fromarray(gt.astype(np.uint8)).resize(
            (size, size), Image.NEAREST))
        mismatch = (gt_resized != pred)
        ax4.imshow(mismatch.astype(float),
                   cmap=ListedColormap(["white", "red"]), interpolation="none")
        acc = 100.0 * (1 - mismatch.mean())
        ax4.set_title("Mismatch Highlight")
        ax4.text(0.5, -0.08, f"Errors: {int(mismatch.sum())} ({acc:.1f}%)",
                 transform=ax4.transAxes, ha="center", fontsize=8,
                 color="blue",
                 bbox=dict(facecolor="white", alpha=0.8, pad=2,
                           edgecolor="none"))

        ax5.imshow(np.clip(images[idx], 0, 1))
        ax5.set_title("Predicted Regions with Boxes")
        draw_boxes(ax5, pred, table, class_names)

        for ax in (ax1, ax2, ax3, ax4, ax5):
            ax.axis("off")
        fig.tight_layout(rect=[0, 0, 1, 0.95])
        fig.savefig(os.path.join(
            output_dir, f"result_batch{batch_num}_img{idx}.png"),
            bbox_inches="tight")
        plt.close(fig)


def save_training_curves(metrics_csv: str, output_path: str,
                         model_name: str) -> bool:
    """Plot per-epoch train/valid curves from a CSVLogger metrics.csv."""
    import pandas as pd

    if not os.path.exists(metrics_csv):
        return False
    df = pd.read_csv(metrics_csv)
    per_epoch = df.groupby("epoch").mean(numeric_only=True)

    plt = pyplot()
    fig, ax = plt.subplots(figsize=(10, 5))
    fig.suptitle(f"Model: {model_name}", fontsize=14)
    for col in per_epoch.columns:
        if col.endswith("loss") or col.endswith("iou") or col.endswith("IoU"):
            ax.plot(per_epoch.index, per_epoch[col], label=col)
    ax.set_xlabel("Epochs")
    ax.set_ylabel("Values")
    ax.set_title("Training and Validation Metrics")
    ax.legend(loc="upper right")
    fig.savefig(output_path)
    plt.close(fig)
    return True
