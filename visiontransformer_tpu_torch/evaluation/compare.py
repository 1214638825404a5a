"""Cross-model comparison reports.

Rebuilds the reference's compareModels.py capability
(reference model/CE/compareModels.py): aggregate every
``<out>/<model>/<model>_metrics.csv`` into per-model means, horizontal-bar
charts of accuracy/IoU/Dice/time, class-detection summaries (how often each
class is missed / falsely predicted) and a set-level class "confusion"
matrix per model (GT class present vs predicted class present per image).

A copy of the TPU package's ``evaluation/compare.py``; pandas and
matplotlib are imported by the functions that use them.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from visiontransformer_tpu_torch.evaluation.visualize import pyplot


def _parse_classes(cell) -> List[int]:
    import pandas as pd

    if pd.isna(cell) or cell == "":
        return []
    return [int(c) for c in str(cell).split("|")]


def load_metrics(output_dir: str) -> Dict[str, pd.DataFrame]:
    """{model_name: dataframe} for every committed sweep CSV."""
    import pandas as pd

    out = {}
    for name in sorted(os.listdir(output_dir)):
        path = os.path.join(output_dir, name, f"{name}_metrics.csv")
        if os.path.exists(path):
            out[name] = pd.read_csv(path)
    return out


def aggregate_metrics(output_dir: str) -> pd.DataFrame:
    """Per-model means of Accuracy / Mean_IoU / Mean_Dice / Inference_Time
    (NaN-excluded, like the reference's df.mean, compareModels.py:44-47)."""
    import pandas as pd

    rows = []
    for name, df in load_metrics(output_dir).items():
        rows.append({
            "model": name,
            "accuracy": df["Accuracy"].mean(),
            "mean_iou": df["Mean_IoU"].mean(),
            "mean_dice": df["Mean_Dice"].mean(),
            "inference_time": df["Inference_Time"].mean(),
            "images": len(df),
        })
    return pd.DataFrame(rows).set_index("model")


def plot_summary(output_dir: str, save_path: str) -> pd.DataFrame:
    """Horizontal-bar chart of the four aggregate metrics per model."""
    summary = aggregate_metrics(output_dir)
    plt = pyplot()
    fig, axes = plt.subplots(1, 4, figsize=(22, 0.5 * len(summary) + 3))
    for ax, col, title in zip(
            axes,
            ["accuracy", "mean_iou", "mean_dice", "inference_time"],
            ["Accuracy (%)", "Mean IoU", "Mean Dice", "Inference time (s/img)"]):
        ax.barh(summary.index, summary[col])
        ax.set_title(title)
        ax.invert_yaxis()
    fig.tight_layout()
    fig.savefig(save_path)
    plt.close(fig)
    return summary


def class_detection_summary(df: pd.DataFrame,
                            num_classes: int = 17) -> pd.DataFrame:
    """Per class: images where present in GT, detected, missed, false-pos."""
    import pandas as pd

    present = np.zeros(num_classes, np.int64)
    missed = np.zeros(num_classes, np.int64)
    false_pos = np.zeros(num_classes, np.int64)
    for _, row in df.iterrows():
        gt = set(_parse_classes(row["GT_Classes"]))
        for c in gt:
            if c < num_classes:
                present[c] += 1
        for c in _parse_classes(row["Missing_Classes"]):
            if c < num_classes:
                missed[c] += 1
        for c in _parse_classes(row["False_Positive_Classes"]):
            if c < num_classes:
                false_pos[c] += 1
    return pd.DataFrame({
        "present": present,
        "detected": present - missed,
        "missed": missed,
        "false_positive": false_pos,
    })


def class_confusion_matrix(df: pd.DataFrame,
                           num_classes: int = 17) -> np.ndarray:
    """Set-level confusion: M[i, j] counts images where class i is in the GT
    set and class j is in the predicted set (the reference's notion of a
    20x20 'confusion' summary, compareModels.py:133-178)."""
    m = np.zeros((num_classes, num_classes), np.int64)
    for _, row in df.iterrows():
        gt = [c for c in _parse_classes(row["GT_Classes"]) if c < num_classes]
        pred = [c for c in _parse_classes(row["Pred_Classes"])
                if c < num_classes]
        for i in gt:
            for j in pred:
                m[i, j] += 1
    return m


def plot_confusion_matrices(output_dir: str, save_dir: str,
                            num_classes: int = 17,
                            class_names: Optional[Sequence[str]] = None
                            ) -> None:
    plt = pyplot()
    os.makedirs(save_dir, exist_ok=True)
    for name, df in load_metrics(output_dir).items():
        m = class_confusion_matrix(df, num_classes)
        fig, ax = plt.subplots(figsize=(8, 7))
        im = ax.imshow(m, cmap="viridis")
        ax.set_title(f"{name}: GT-present vs predicted-present")
        ax.set_xlabel("predicted class")
        ax.set_ylabel("GT class")
        if class_names:
            ax.set_xticks(range(num_classes),
                          class_names[:num_classes], rotation=90, fontsize=6)
            ax.set_yticks(range(num_classes),
                          class_names[:num_classes], fontsize=6)
        fig.colorbar(im)
        fig.tight_layout()
        fig.savefig(os.path.join(save_dir, f"{name}_confusion.png"))
        plt.close(fig)
