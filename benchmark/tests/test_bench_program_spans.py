"""The per-layer readers of the port's own spans (``program_spans.py``):
each reads its span's median in a tiny traced run, and gives None where
the program recorded none or has no spans module (an older checkout of
the port)."""

import statistics
import sys

import pytest

from benchmark import harness
from benchmark.tests.test_bench_drivers import SERVE, _run

READERS = {"input_copy_ms.serve": "serve.input",
           "launch_ms.serve": "serve.forward",
           "resolve_wait_ms.serve": "serve.resolve"}


@pytest.fixture
def spans():
    from visiontransformer_tpu_torch.utils import spans
    spans.reset()
    yield spans
    spans.reset()


def test_readers_read_a_traced_run(spans):
    line = _run("serve_b16_bulk", SERVE, trace=True, seconds=1.5)
    assert line["correct"], line["checks"]
    ring = spans.finished()
    for metric, name in READERS.items():
        want = statistics.median(s.end_ns - s.start_ns for s in ring
                                 if s.name == name) / 1e6
        assert line["metrics"][metric] == {"value": want, "unit": "ms"}
        assert want > 0
    # The per-layer metrics are the traced run's: none in an untraced one.
    line = _run("serve_b16_bulk", SERVE, seconds=1.0)
    assert not set(READERS) & set(line["metrics"])


@pytest.mark.parametrize("metric,name", READERS.items())
def test_readers_without_spans(spans, monkeypatch, metric, name):
    read = harness.load_reader(metric)
    assert read(harness.Outcome()) is None
    with spans.span("serve.other"):
        pass
    assert read(harness.Outcome()) is None
    for _ in range(3):
        with spans.span(name):
            pass
    times = [s.end_ns - s.start_ns for s in spans.finished()
             if s.name == name]
    assert read(harness.Outcome()) == statistics.median(times) / 1e6
    import visiontransformer_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "visiontransformer_tpu_torch.utils.spans",
                        None)
    assert read(harness.Outcome()) is None
