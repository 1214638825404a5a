"""Single-image inference demo (the TPU package's ``evaluation/demo.py``).

The reference's closest analog of the serving path is the single-image script
(reference model/CE/testViTModel.py): load image → resize 224 → forward →
argmax → colorize via classdict → connected-component bounding boxes →
4-panel composite. ``predict_image`` is that contract as a function. Its
forward is ``vitseg_apply``'s logits, then the argmax, as the TPU package's
(not the serving epilogue): on the card the attention runs in the port's
inference kernel, one launch a layer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from visiontransformer_tpu_torch.configs import ViTSegConfig
from visiontransformer_tpu_torch.evaluation.visualize import (
    class_color_table,
    colorize,
    draw_boxes,
    pyplot,
)
from visiontransformer_tpu_torch.models.vitseg import ViTSeg, vitseg_apply
from visiontransformer_tpu_torch.ops.morphology import bounding_boxes_np


def load_image(path: str, size: int = 224) -> np.ndarray:
    img = Image.open(path).convert("RGB").resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def make_predict_fn(cfg: ViTSegConfig):
    """(model, images NHWC) -> argmax masks (B, H, W) int32, without a
    graph."""

    @torch.no_grad()
    def predict(model: ViTSeg, images: torch.Tensor) -> torch.Tensor:
        logits = vitseg_apply(model, images)
        return torch.argmax(logits, dim=-1).int()

    return predict


def predict_image(model: ViTSeg, cfg: ViTSegConfig, image: np.ndarray, *,
                  class_names: Optional[Sequence[str]] = None,
                  rgb_to_class: Optional[dict] = None,
                  predict_fn=None) -> Dict:
    """image: (H, W, 3) float32 in [0,1], run on the model's device.
    Returns mask, colorized mask, detected classes and per-class bounding
    boxes (background skipped, reference testViTModel.py:171-185)."""
    if predict_fn is None:
        predict_fn = make_predict_fn(cfg)
    device = next(model.parameters()).device
    images = torch.from_numpy(np.ascontiguousarray(image[None])).to(device)
    mask = predict_fn(model, images).cpu().numpy()[0]

    table = class_color_table(rgb_to_class, cfg.num_classes)
    detections: List[Dict] = []
    for cls in np.unique(mask):
        if cls == 0:
            continue
        name = (class_names[cls] if class_names and cls < len(class_names)
                else str(cls))
        for box in bounding_boxes_np(mask == cls):
            detections.append({"class_id": int(cls), "class_name": name,
                               "box_yxyx": [int(v) for v in box]})
    return {
        "mask": mask,
        "mask_rgb": colorize(mask, table),
        "classes": [int(c) for c in np.unique(mask)],
        "detections": detections,
    }


def render_demo_composite(image: np.ndarray, result: Dict, save_path: str, *,
                          class_names: Optional[Sequence[str]] = None,
                          rgb_to_class: Optional[dict] = None,
                          title: str = "") -> None:
    """4-panel composite: original / prediction / overlay / boxes."""
    plt = pyplot()

    table = class_color_table(rgb_to_class, int(result["mask"].max()) + 1)
    fig, (ax1, ax2, ax3, ax4) = plt.subplots(1, 4, figsize=(16, 5))
    if title:
        fig.suptitle(title)
    ax1.imshow(np.clip(image, 0, 1)); ax1.set_title("Image")
    ax2.imshow(result["mask_rgb"]); ax2.set_title("Prediction")
    ax3.imshow(np.clip(image, 0, 1))
    ax3.imshow(result["mask_rgb"], alpha=0.5); ax3.set_title("Overlay")
    ax4.imshow(np.clip(image, 0, 1)); ax4.set_title("Boxes")
    draw_boxes(ax4, result["mask"], table, class_names)
    for ax in (ax1, ax2, ax3, ax4):
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
