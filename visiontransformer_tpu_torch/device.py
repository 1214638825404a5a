"""Device choice for the port's entry points.

The port runs on the card: ``device=None`` means ``"cuda"``, and asking for
CUDA on a host without it raises instead of falling back to the CPU. The
CPU runs only when a caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; the port runs on the GPU "
            "by default (pass device='cpu' to run on the host explicitly)")
    return dev
