"""Signed-distance-field targets for the PAED loss (the TPU package's
``losses/sdf.py``).

``compute_sdf_batch`` matches the reference's ``compute_sdf``
(model/PAED/segmentation.py:6-34): the exterior EDT (background to
boundary) and the interior EDT (foreground to boundary), each divided by
its max when that is positive. It runs on the masks' device
(``ops/edt.py``) and builds no graph: SDFs are targets.
"""

from __future__ import annotations

from typing import Tuple

import torch

from visiontransformer_tpu_torch.ops.edt import edt


def _normalise(x: torch.Tensor) -> torch.Tensor:
    m = torch.amax(x, dim=(-2, -1), keepdim=True)
    return torch.where(m > 0, x / torch.clamp(m, min=1e-30), x)


@torch.no_grad()
def compute_sdf_batch(mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask: (..., H, W) binary, one image or a batch (the TPU package's
    ``compute_sdf`` and its vmap ``compute_sdf_batch`` in one). Returns
    (sdf_ext, sdf_int), fp32 in [0, 1], each normalised per image."""
    mask = mask.bool()
    return _normalise(edt(~mask)), _normalise(edt(mask))

