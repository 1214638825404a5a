"""Attention's share of its roofline in the SAM serving cell, in %: over
the port's ``sam.attention.window`` and ``sam.attention.global`` ranges in
the traced slice (``models/sam.py``: the attention core alone, q, k, v and
the decomposed bias in, its output out, whatever implements it), the sum
of each call's least time at its shape (``counts_sam.attention_fwd_counts``:
Q, K, V and O once and the bias's rel_h and rel_w once; 4·BH·N²·d
operations, at the bf16 peak and the card's bandwidth) over the device
time of the kernels launched inside those ranges. A program without the
ranges gives nothing to read."""

from benchmark import counts, counts_sam


def read(outcome):
    shapes = outcome.layer.get("attention_shapes")
    if outcome.trace is None or not shapes:
        return None
    least = spent = 0.0
    for name, (bh, n, d, kh, kw) in shapes.items():
        times = [t for t in outcome.trace.ranges.get(name, []) if t > 0]
        n_bytes, n_ops = counts_sam.attention_fwd_counts(bh, n, d, kh, kw)
        least += counts.least_seconds(outcome.peaks, n_bytes, n_ops,
                                      "bf16") * len(times)
        spent += sum(times)
    if not spent:
        return None
    return 100.0 * least / spent
