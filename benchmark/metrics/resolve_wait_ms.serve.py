"""Host ms a batch waits for its masks: the median of the port's
``serve.resolve`` spans (``_PendingMasks.resolve``: the wait on the copy's
event and the host view of the masks)."""

from benchmark import program_spans


def read(outcome):
    return program_spans.median_ms("serve.resolve")
