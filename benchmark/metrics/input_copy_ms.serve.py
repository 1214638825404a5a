"""Host ms a batch spends getting its images onto the device: the median
of the port's ``serve.input`` spans (``ModelRunner``: the copy of the
uint8 batch, ``from_numpy``, ``.to(device)`` and the /255). A blocking
copy from pageable memory also waits for the stream's earlier work, so
that wait is inside it."""

from benchmark import program_spans


def read(outcome):
    return program_spans.median_ms("serve.input")
