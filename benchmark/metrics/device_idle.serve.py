"""The device's idle share of the traced slice, in %: 1 − the union of
the intervals in which a kernel, copy or memset ran (``trace.py``) over
the slice's length."""


def read(outcome):
    if outcome.trace is None or not outcome.trace.window_s:
        return None
    return 100.0 * (1.0 - outcome.trace.busy_s / outcome.trace.window_s)
