"""Spans and counters: where the port's host time goes, on the profiler's
clock when a profiler runs.

- ``span(name, batch=None)``: a context manager. On exit the span itself
  is appended to a bounded in-memory ring (the newest ``RING`` spans; the
  oldest drop out) with its name, start and end on
  ``time.perf_counter_ns()``, its id, the id of the span open around it on
  the same thread (``parent``, None at the top), its batch id (the one
  given, else the enclosing span's) and the thread's ident. While a torch
  profiler session is active it also opens a profiler range of its name,
  so the device trace names host time by the program's spans.
- ``ranged(name)``: the profiler range alone, while a profiler is active;
  otherwise one flag check and nothing recorded. For sites a forward
  passes many times (the model's layers).

The range is ``torch._C._profiler._RecordFunctionFast``, the one
``torch.compile``'s generated code opens: the same host range in the
trace as ``torch.profiler.record_function``, at about a tenth of its cost
under a profiler, and without a device-side mirror. A
``record_function`` costs about 10 us even with no profiler running.
- ``count(name, n=1)`` / ``counters()``: named counters (kernel launches
  under each kernel's name, calls on a card that took a kernel's plain
  code, ``layer_norm_plain``; biased linears by path, ``linear_epilogue``
  and ``linear_plain``; the serving path's batches, rows and jobs).
- ``finished()``: the ring's spans, oldest first; ``reset()`` empties the
  ring and the counters.
- ``next_batch()``: a fresh batch id, which the spans of one batch share.

All of it is safe across threads. No range enters a program that
``torch.export`` traces: the check is skipped while it exports.

Names: ``serve.*`` (``serve/worker.py:ModelRunner``), ``worker.*``
(``InferenceWorker``), ``vit.*``, ``vitseg.*``, ``mit.*`` and
``segformer.*`` (``models/``); PERF.md lists each with what reads it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

RING = 65536

_ring: collections.deque = collections.deque(maxlen=RING)
_counters: Dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()
_span_ids = itertools.count(1)
_batch_ids = itertools.count(1)
_OFF = contextlib.nullcontext()


def _profiling() -> bool:
    # A plain module flag, set while a torch profiler session is active.
    return (_autograd_profiler._is_profiler_enabled
            and not torch.compiler.is_exporting())


def ranged(name: str):
    """A ``record_function(name)`` range while a profiler is active, else a
    context that does nothing."""
    if not _profiling():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


class span:
    """A timed region of the host, recorded in the ring on exit (module
    docstring). The attributes are those of the record."""

    __slots__ = ("name", "batch", "id", "parent", "thread", "start_ns",
                 "end_ns", "_range")

    def __init__(self, name: str, batch: Optional[int] = None):
        self.name, self.batch = name, batch

    def __enter__(self) -> "span":
        # The range opens first and closes last, so that a device trace
        # finds the host outside it only for the call itself.
        self._range = None
        if _profiling():
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        outer = stack[-1] if stack else None
        self.parent = None if outer is None else outer.id
        if self.batch is None and outer is not None:
            self.batch = outer.batch
        self.id = next(_span_ids)
        self.thread = threading.get_ident()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        _local.stack.pop()
        with _lock:
            _ring.append(self)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "batch": self.batch, "thread": self.thread,
                "start_ns": self.start_ns, "end_ns": self.end_ns}


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    with _lock:
        return dict(_counters)


def finished() -> List[span]:
    """The spans in the ring, in the order they ended."""
    with _lock:
        return list(_ring)


def reset() -> None:
    with _lock:
        _ring.clear()
        _counters.clear()


def next_batch() -> int:
    return next(_batch_ids)
