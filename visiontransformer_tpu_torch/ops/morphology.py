"""Morphology utilities: skeletonization and connected components (a copy
of the TPU package's ``ops/morphology.py``).

- ``skeletonize_np``: Zhang-Suen thinning in numpy. Replaces the reference's
  `skimage.morphology.skeletonize` host round-trip
  (reference model/PAED/segmentation.py:89-111). Kept host-side on purpose:
  the reference path is likewise non-differentiable and host-bound, and the
  loop count is data-dependent (dynamic shapes are hostile to XLA).
- ``connected_components_np`` / ``bounding_boxes_np``: two-pass union-find
  labeling with 4-connectivity + per-region boxes, matching
  `scipy.ndimage.label` defaults as used by the eval/serving path
  (reference model/CE/datasetTestViTmodel.py:27-35, testViTModel.py:34-42).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _neighbours(padded: np.ndarray):
    """P2..P9 clockwise from north, for the interior view of a padded image."""
    p2 = padded[0:-2, 1:-1]
    p3 = padded[0:-2, 2:]
    p4 = padded[1:-1, 2:]
    p5 = padded[2:, 2:]
    p6 = padded[2:, 1:-1]
    p7 = padded[2:, 0:-2]
    p8 = padded[1:-1, 0:-2]
    p9 = padded[0:-2, 0:-2]
    return p2, p3, p4, p5, p6, p7, p8, p9


def skeletonize_np(mask: np.ndarray, max_iters: int = 10000) -> np.ndarray:
    """Zhang-Suen thinning of a binary (H, W) mask to a 1-px skeleton."""
    img = (np.asarray(mask) > 0).astype(np.uint8)

    for _ in range(max_iters):
        changed = False
        for step in (0, 1):
            padded = np.pad(img, 1)
            p2, p3, p4, p5, p6, p7, p8, p9 = _neighbours(padded)
            ring = np.stack([p2, p3, p4, p5, p6, p7, p8, p9, p2], axis=0)
            # A = number of 0->1 transitions around the ring.
            a = np.sum((ring[:-1] == 0) & (ring[1:] == 1), axis=0)
            # B = number of nonzero neighbours.
            b = np.sum(ring[:-1], axis=0)
            if step == 0:
                cond = (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
            else:
                cond = (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
            delete = (img == 1) & (a == 1) & (b >= 2) & (b <= 6) & cond
            if delete.any():
                img[delete] = 0
                changed = True
        if not changed:
            break
    return img.astype(bool)


def connected_components_np(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """4-connected labeling of a binary mask (scipy.ndimage.label default
    structure). Returns (labels int32 array, num_features)."""
    mask = np.asarray(mask) > 0
    h, w = mask.shape
    labels = np.zeros((h, w), dtype=np.int32)
    parent: List[int] = [0]  # union-find; parent[0] unused sentinel

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    next_label = 1
    for i in range(h):
        row = mask[i]
        for j in range(w):
            if not row[j]:
                continue
            up = labels[i - 1, j] if i > 0 else 0
            left = labels[i, j - 1] if j > 0 else 0
            if up == 0 and left == 0:
                parent.append(next_label)
                labels[i, j] = next_label
                next_label += 1
            elif up != 0 and left != 0:
                ru, rl = find(up), find(left)
                labels[i, j] = min(ru, rl)
                if ru != rl:
                    parent[max(ru, rl)] = min(ru, rl)
            else:
                labels[i, j] = up or left

    # Flatten labels to consecutive ids.
    remap = {}
    count = 0
    flat = labels.reshape(-1)
    roots = np.empty_like(flat)
    for idx, lab in enumerate(flat):
        if lab == 0:
            roots[idx] = 0
            continue
        r = find(int(lab))
        if r not in remap:
            count += 1
            remap[r] = count
        roots[idx] = remap[r]
    return roots.reshape(h, w), count


def bounding_boxes_np(binary_mask: np.ndarray) -> List[Tuple[int, int, int, int]]:
    """Per-connected-region (y_min, x_min, y_max, x_max) boxes
    (reference model/CE/datasetTestViTmodel.py:27-35).

    Dispatch order: first-party C++ (native/vitseg_native.cpp) when built,
    then scipy, then the pure-Python union-find."""
    from visiontransformer_tpu_torch import native
    if native.available():
        return native.bounding_boxes(binary_mask)
    try:
        from scipy.ndimage import label as scipy_label
        labeled, num = scipy_label(np.asarray(binary_mask) > 0)
    except ImportError:  # pragma: no cover - scipy is present in this image
        labeled, num = connected_components_np(binary_mask)
    boxes = []
    for region in range(1, num + 1):
        coords = np.argwhere(labeled == region)
        y_min, x_min = coords.min(axis=0)
        y_max, x_max = coords.max(axis=0)
        boxes.append((int(y_min), int(x_min), int(y_max), int(x_max)))
    return boxes
