"""Class-dictionary CSV loading.

Reimplements `load_classdict` / `convertBW` / `assign_closest_class`
(reference model/CE/functions.py:12-40, duplicated at model/PAED/functions.py)
— including the tab-vs-comma sniffing on the first line (functions.py:14) —
without the pandas dependency.

CSV schema: columns ``name, r, g, b`` (the reference's
calss_names_colors.csv).
"""

from __future__ import annotations

import csv
from typing import Dict, List, Tuple

RGB = Tuple[int, int, int]


def load_classdict(csv_path: str) -> Tuple[Dict[RGB, int], List[str]]:
    """Returns ({(r, g, b): class_index}, [class names]) in file order."""
    with open(csv_path, newline="") as f:
        first_line = f.readline()
        delimiter = "\t" if "\t" in first_line else ","
        f.seek(0)
        reader = csv.DictReader(f, delimiter=delimiter)
        class_dict: Dict[RGB, int] = {}
        class_names: List[str] = []
        for idx, row in enumerate(reader):
            rgb = (int(row["r"]), int(row["g"]), int(row["b"]))
            class_dict[rgb] = idx
            class_names.append(row["name"])
    return class_dict, class_names


def convert_bw(rgb_to_class: Dict[RGB, int]) -> Dict[int, float]:
    """Class index -> mean grayscale value (reference functions.py:23-28)."""
    return {cls: float(sum(rgb) / 3.0) for rgb, cls in rgb_to_class.items()}


def assign_closest_class(value: float, bw_dict: Dict[int, float]) -> int:
    """Nearest-grayscale class assignment (reference functions.py:30-40).
    Ties break toward the earlier-seen class, like the reference's `<` scan."""
    closest, best = None, float("inf")
    for cls, bw_value in bw_dict.items():
        diff = abs(value - bw_value)
        if diff < best:
            best, closest = diff, cls
    return closest
