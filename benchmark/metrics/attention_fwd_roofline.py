"""Attention's share of its roofline in serving, in %: over the calls the
model makes into ``multi_head_attention`` (``models/vit.py``) in the
traced slice, each call's least time (``counts.attention_fwd_counts``: Q,
K, V read and O written once, 4·BH·N²·d operations, at the bf16 peak and
the card's bandwidth) over the device time of the kernels launched inside
the call's ``bench.attention`` range."""

from benchmark import counts


def read(outcome):
    shape = outcome.layer.get("attention_shape")
    if outcome.trace is None or shape is None:
        return None
    times = [t for t in outcome.trace.ranges.get("bench.attention", [])
             if t > 0]
    if not times:
        return None
    bh, n, d, elem = shape
    n_bytes, n_ops = counts.attention_fwd_counts(bh, n, d, elem)
    least = counts.least_seconds(outcome.peaks, n_bytes, n_ops, "bf16")
    return 100.0 * least * len(times) / sum(times)
