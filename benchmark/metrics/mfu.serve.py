"""Model FLOP utilisation of serving, in %: the forward's operations
(``counts.vitseg_forward_flops``) times the masks returned in the traced
run's window outside the profiler's stay (its slice and its stop), over
those seconds of the host clock times the card's bf16 peak. The profiled
slice, which slows the host's launches, is left out."""


def read(outcome):
    seconds = outcome.layer.get("untraced_s")
    masks = outcome.layer.get("untraced_masks")
    if not seconds or not masks:
        return None
    return 100.0 * masks * outcome.layer["flops_per_mask"] / (
        seconds * outcome.peaks["bf16"])
