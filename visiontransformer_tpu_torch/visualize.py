"""Mask palettes: a copy of the TPU package's
``evaluation/visualize.py:class_color_table`` and ``colorize``."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


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
