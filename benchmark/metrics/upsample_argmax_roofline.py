"""The epilogue's share of its roofline in serving, in %: over the model's
``upsample_argmax`` calls (``models/vitseg.py``) in the traced slice, each
call's least time (``counts.upsample_argmax_counts``: logits read, masks
written, the tap tables; operations at the fp32 peak) over the device
time of the kernels launched inside its ``bench.epilogue`` range."""

from benchmark import counts


def read(outcome):
    shape = outcome.layer.get("epilogue_shape")
    if outcome.trace is None or shape is None:
        return None
    times = [t for t in outcome.trace.ranges.get("bench.epilogue", [])
             if t > 0]
    if not times:
        return None
    (b, h, w, c), (out_h, out_w), in_bytes, out_bytes = shape
    n_bytes, n_ops = counts.upsample_argmax_counts(
        b, h, w, c, out_h, out_w, in_bytes, out_bytes)
    least = counts.least_seconds(outcome.peaks, n_bytes, n_ops, "fp32")
    return 100.0 * least * len(times) / sum(times)
