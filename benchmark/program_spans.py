"""What the port's own spans (``visiontransformer_tpu_torch/utils/spans.py``)
recorded in the run's process, for the per-layer readers. A program
without that module, or whose run recorded no such span, gives None."""

from __future__ import annotations

import statistics
from typing import Optional


def median_ms(name: str) -> Optional[float]:
    """The median duration, in ms, of the ``name`` spans in the ring."""
    try:
        from visiontransformer_tpu_torch.utils import spans
    except ImportError:
        return None
    times = [s.end_ns - s.start_ns for s in spans.finished()
             if s.name == name]
    if not times:
        return None
    return statistics.median(times) / 1e6
