"""Attention's share of its roofline in the SegFormer-B5 serving cell, in
%: over the port's ``mit.attention.<stage>`` ranges in the traced slice
(``models/mit.py``: the attention core alone, q, k, v in and its output
out, whatever implements it), the sum of each call's least time at its
stage's shape (``counts_segformer.attention_fwd_counts``: Q and O at Nq
rows, K and V at Nk, each once; 4·BH·Nq·Nk·d operations, at the bf16 peak
and the card's bandwidth) over the device time of the kernels launched
inside those ranges. A program without the ranges gives nothing to read."""

from benchmark import counts, counts_segformer


def read(outcome):
    shapes = outcome.layer.get("attention_shapes")
    if outcome.trace is None or not shapes:
        return None
    least = spent = 0.0
    for name, (bh, n_q, n_k, d) in shapes.items():
        times = [t for t in outcome.trace.ranges.get(name, []) if t > 0]
        n_bytes, n_ops = counts_segformer.attention_fwd_counts(bh, n_q, n_k,
                                                               d)
        least += counts.least_seconds(outcome.peaks, n_bytes, n_ops,
                                      "bf16") * len(times)
        spent += sum(times)
    if not spent:
        return None
    return 100.0 * least / spent
