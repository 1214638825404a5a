"""Host ms a batch spends issuing the forward's launches: the median of
the port's ``serve.forward`` spans (``ModelRunner``: ``vitseg_predict``,
which returns once its kernels are queued)."""

from benchmark import program_spans


def read(outcome):
    return program_spans.median_ms("serve.forward")
