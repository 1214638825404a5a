"""CSV metrics logger.

Produces the same on-disk shape as Lightning's CSVLogger as used by the
reference (`CSVLogger("logs/", name="vit-model")`, reference
model/CE/createViTmodel.py:66): ``<root>/<name>/version_N/metrics.csv`` with
auto-incremented version directories and one row per logged step/epoch, so
the reference's training-curve tooling (datasetTestViTmodel.py:337-358 reads
metrics.csv and groups by 'epoch') works unchanged against our logs.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional


class CSVLogger:
    def __init__(self, root: str, name: str = "vit-model",
                 version: Optional[int] = None):
        base = os.path.join(root, name)
        os.makedirs(base, exist_ok=True)
        if version is None:
            existing = [int(d.split("_", 1)[1]) for d in os.listdir(base)
                        if d.startswith("version_")
                        and d.split("_", 1)[1].isdigit()]
            version = max(existing) + 1 if existing else 0
        self.version = version
        self.log_dir = os.path.join(base, f"version_{version}")
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, "metrics.csv")
        self._rows = []
        self._fields = ["epoch", "step"]

    def log(self, metrics: Dict[str, float], *, epoch: int, step: int) -> None:
        row = {"epoch": epoch, "step": step}
        for k, v in metrics.items():
            row[k] = float(v)
            if k not in self._fields:
                self._fields.append(k)
        self._rows.append(row)
        self._flush()

    def _flush(self) -> None:
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fields)
            writer.writeheader()
            writer.writerows(self._rows)
