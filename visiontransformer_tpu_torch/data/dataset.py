"""Dataset loaders for the structural-damage data.

Reimplements both `StructuralDamageDataset` variants:

- ``CESegmentationDataset`` (reference model/CE/classes.py:23-103): paired
  image/mask dirs; scans all masks once to build the grayscale-value →
  class-index map; images resized to `image_size` (PIL bilinear, as
  torchvision Resize does), masks resized to 256×256 PIL-NEAREST then
  remapped. Returns HWC float32 images in [0,1] and int32 index masks —
  numpy, channel-last (TPU layout), no torch.
- ``PAEDBinaryDataset`` (reference model/PAED/classes.py:36-89): masks resized
  to 224×224 NEAREST and binarized at >127. Unlike the reference — which
  computes two scipy EDTs per sample in dataloader workers (classes.py:69) —
  SDF targets are NOT computed here: the train pipeline computes them
  on-device with the XLA EDT (losses/sdf.py), removing the host bottleneck.

The value→class remap is a single numpy take() through a 256-entry LUT
instead of the reference's per-pixel `np.vectorize(dict.get)`
(classes.py:81) — same result, ~1000× less Python.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image


def _list_pairs(image_dir: str, mask_dir: str,
                subset: Optional[Sequence[str]] = None):
    images = sorted(os.listdir(image_dir))
    masks = sorted(os.listdir(mask_dir))
    if len(images) != len(masks):
        raise ValueError("Number of images and masks must be equal!")
    if subset is not None:
        keep = set(subset)
        pairs = [(im, mk) for im, mk in zip(images, masks) if im in keep]
        images = [p[0] for p in pairs]
        masks = [p[1] for p in pairs]
    return images, masks


def _load_image(path: str, size: int) -> np.ndarray:
    """RGB image -> (H, W, 3) float32 in [0,1]; PIL bilinear resize (what
    torchvision Resize+ToTensor produce in the reference transform,
    reference model/CE/createViTmodel.py:46-49)."""
    img = Image.open(path).convert("RGB").resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


class _SampleCache:
    """Opt-in decoded-sample cache shared by the dataset classes.

    The reference (torchvision-style datasets) re-decodes and re-resizes
    every image every epoch; with TPU step times in the low hundreds of ms
    that host work dominates the epoch on weak hosts. Caching the fully
    preprocessed (image, mask) pair makes epochs ≥2 decode-free at
    ~0.7 MB/sample (224², fp32 + int mask) — opt-in so the default memory
    profile matches the reference."""

    def __init__(self, enabled: bool):
        self._store = {} if enabled else None

    def get_or(self, idx, compute):
        if self._store is None:
            return compute()
        hit = self._store.get(idx)
        if hit is None:
            hit = compute()
            self._store[idx] = hit
        return hit


class CESegmentationDataset:
    """Multiclass (17-way) segmentation pairs."""

    def __init__(self, image_dir: str, mask_dir: str, *, image_size: int = 224,
                 mask_size: int = 256,
                 subset: Optional[Sequence[str]] = None,
                 cache: bool = False):
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.image_size = image_size
        self.mask_size = mask_size
        self.images, self.masks = _list_pairs(image_dir, mask_dir, subset)
        self._lut: Optional[np.ndarray] = None
        self.unique_values: Optional[np.ndarray] = None
        self._cache = _SampleCache(cache)

    def build_class_mapping(self) -> None:
        """Scan all masks for their unique grayscale values
        (reference model/CE/classes.py:43-53)."""
        values = set()
        for mask_file in self.masks:
            mask = np.asarray(Image.open(
                os.path.join(self.mask_dir, mask_file)).convert("L"))
            values.update(np.unique(mask).tolist())
        self.unique_values = np.array(sorted(values), dtype=np.int64)
        lut = np.zeros(256, dtype=np.int32)
        for i, v in enumerate(self.unique_values):
            lut[v] = i
        self._lut = lut

    @property
    def num_classes(self) -> int:
        if self.unique_values is None:
            self.build_class_mapping()
        return int(len(self.unique_values))

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._lut is None:
            self.build_class_mapping()

        def compute():
            image = _load_image(
                os.path.join(self.image_dir, self.images[idx]),
                self.image_size)
            mask = np.asarray(Image.open(
                os.path.join(self.mask_dir, self.masks[idx])).convert("L"))
            # PIL-exact nearest resize + LUT remap via the C++ runtime when
            # built (visiontransformer_tpu_torch/native.py), numpy/PIL otherwise.
            from visiontransformer_tpu_torch import native
            mask = native.resize_nearest_pil_u8(
                mask, (self.mask_size, self.mask_size))
            return image, native.remap_u8(mask, self._lut).astype(np.int32)

        return self._cache.get_or(idx, compute)


class PAEDBinaryDataset:
    """Binary crack-segmentation pairs (SDFs computed downstream on-device)."""

    def __init__(self, image_dir: str, mask_dir: str, *, image_size: int = 224,
                 subset: Optional[Sequence[str]] = None,
                 cache: bool = False):
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.image_size = image_size
        self.images, self.masks = _list_pairs(image_dir, mask_dir, subset)
        self._cache = _SampleCache(cache)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        def compute():
            image = _load_image(
                os.path.join(self.image_dir, self.images[idx]),
                self.image_size)
            mask = Image.open(
                os.path.join(self.mask_dir, self.masks[idx])).convert("L")
            mask = mask.resize((self.image_size, self.image_size),
                               Image.NEAREST)
            return image, (np.asarray(mask, np.uint8) > 127).astype(
                np.float32)

        return self._cache.get_or(idx, compute)
