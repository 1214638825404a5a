"""Synthetic structural-damage dataset generator.

The reference's dataset (VisionChallenge Attachments, referenced at
model/CE/createViTmodel.py:22-33) is not shipped in either repo. For tests,
benchmarks, and runnable training demos this generates deterministic
image/mask pairs with the same on-disk shape the loaders expect: an
``image_png/`` dir of RGB photos and a ``mask_png/`` dir of grayscale masks
whose pixel values are drawn from a configurable class palette (multiclass),
or {0, 255} crack masks (binary).
"""

from __future__ import annotations

import csv
import os
from typing import Sequence

import numpy as np
from PIL import Image

# 17 classes, mirroring the reference's class count
# (reference model/PAED/classes.py:418 hardcodes 17).
DEFAULT_CLASS_VALUES = tuple(range(0, 17 * 15, 15))  # grayscale values 0..240


def _blob_mask(rng: np.random.Generator, size: int, n_blobs: int) -> np.ndarray:
    """Union of random filled ellipses — stand-ins for damage regions."""
    yy, xx = np.mgrid[0:size, 0:size]
    mask = np.zeros((size, size), dtype=bool)
    for _ in range(n_blobs):
        cy, cx = rng.integers(0, size, 2)
        ry, rx = rng.integers(size // 16, size // 4, 2)
        angle = rng.uniform(0, np.pi)
        ys, xs = yy - cy, xx - cx
        yr = ys * np.cos(angle) + xs * np.sin(angle)
        xr = -ys * np.sin(angle) + xs * np.cos(angle)
        mask |= (yr / ry) ** 2 + (xr / rx) ** 2 <= 1.0
    return mask


def _crack_mask(rng: np.random.Generator, size: int,
                half_width: int = 1) -> np.ndarray:
    """Random-walk polyline dilated to (2·half_width+1) px — a synthetic
    crack."""
    mask = np.zeros((size, size), dtype=bool)
    y = rng.integers(size // 4, 3 * size // 4)
    x = 0
    while 0 <= x < size:
        y = int(np.clip(y + rng.integers(-2, 3), half_width,
                        size - 1 - half_width))
        mask[y - half_width:y + half_width + 1, x] = True
        x += 1
    return mask


def generate_multiclass(root: str, n_samples: int = 16, image_size: int = 512,
                        class_values: Sequence[int] = DEFAULT_CLASS_VALUES,
                        seed: int = 0) -> str:
    """Write image_png/ + mask_png/ + calss_names_colors.csv under `root`.
    (The csv filename typo is the reference's, kept for drop-in parity.)"""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "image_png")
    mask_dir = os.path.join(root, "mask_png")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)

    for i in range(n_samples):
        mask = np.zeros((image_size, image_size), dtype=np.uint8)
        mask[:] = class_values[0]
        for value in rng.choice(class_values[1:], size=4, replace=False):
            region = _blob_mask(rng, image_size, n_blobs=2)
            mask[region] = value
        image = np.stack([
            (mask.astype(np.float32) / 255.0 * 180 + rng.normal(40, 12, mask.shape))
            for _ in range(3)
        ], axis=-1).clip(0, 255).astype(np.uint8)
        Image.fromarray(image).save(os.path.join(img_dir, f"img_{i:04d}.png"))
        Image.fromarray(mask).save(os.path.join(mask_dir, f"img_{i:04d}.png"))

    with open(os.path.join(root, "calss_names_colors.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["name", "r", "g", "b"])
        for idx, v in enumerate(class_values):
            writer.writerow([f"class_{idx}", v, v, v])
    return root


def generate_binary(root: str, n_samples: int = 16, image_size: int = 224,
                    seed: int = 0, crack_half_width: int = 1) -> str:
    """Write image_png/ + mask_png/ crack pairs ({0,255} masks) under root."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "image_png")
    mask_dir = os.path.join(root, "mask_png")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)

    for i in range(n_samples):
        crack = _crack_mask(rng, image_size, crack_half_width)
        mask = (crack * 255).astype(np.uint8)
        base = rng.normal(128, 20, (image_size, image_size, 3))
        base[crack] -= 80
        image = base.clip(0, 255).astype(np.uint8)
        Image.fromarray(image).save(os.path.join(img_dir, f"crack_{i:04d}.png"))
        Image.fromarray(mask).save(os.path.join(mask_dir, f"crack_{i:04d}.png"))
    return root
