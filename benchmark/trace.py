"""The reduction of a profiled slice to device numbers.

- busy: the union of the intervals in which a kernel, copy or memset ran
  on the device, clipped to the slice (the ``bench.slice`` range); an
  interval counted once however many streams overlap in it.
- ranges: for each ``record_function`` range the harness opened around a
  call into a layer (``bench.<layer>``), the device time of the kernels
  launched inside it, found through the profiler's link from each kernel
  to the operator that launched it, never through a kernel's name.
- breakdown: the device operations that took the most time, and the
  longest idle gaps, each named by the innermost host range open at the
  gap's start.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


class Reduced:
    def __init__(self, window_s: float, busy_s: float,
                 ranges: Dict[str, List[float]], device_ops, idle_gaps):
        self.window_s, self.busy_s = window_s, busy_s
        self.ranges = ranges          # name -> device seconds of each call
        self.device_ops = device_ops  # [[name, seconds]], at most 10
        self.idle_gaps = idle_gaps    # [[name, seconds]], at most 10


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint, sorted intervals covering the same points."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def gaps(busy: List[Tuple[float, float]], lo: float, hi: float):
    """The idle intervals of [lo, hi] between the busy ones."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def _host_name(cpu_events, t: float) -> str:
    """The innermost host range or operator open at time t (us), with the
    harness range around it: "bench.resolve>cudaEventSynchronize"."""
    open_ = [e for e in cpu_events
             if e.time_range.start <= t < e.time_range.end
             and e.name != "bench.slice"]
    if not open_:
        return "host: outside any range"
    inner = min(open_, key=lambda e: e.time_range.end - e.time_range.start)
    bench = [e for e in open_ if e.name.startswith("bench.")]
    if bench:
        outer = min(bench, key=lambda e: e.time_range.end
                    - e.time_range.start)
        if outer is not inner:
            return f"{outer.name}>{inner.name}"[:160]
    return inner.name[:160]


def reduce(prof, range_names=()) -> Reduced:
    """Reduce a stopped ``torch.profiler.profile`` of one slice."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    marks = [e for e in events if e.name == "bench.slice"]
    if not marks:
        raise RuntimeError("the trace holds no bench.slice range")
    lo, hi = marks[0].time_range.start, marks[0].time_range.end
    # The profiler mirrors each host range onto the device's timeline as a
    # user annotation: those are not device work.
    device = [e for e in events if e.device_type == cuda
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith("bench.")]
    cpu = [e for e in events if e.device_type != cuda and not e.is_async]
    busy = union(clip([(e.time_range.start, e.time_range.end)
                       for e in device], lo, hi))
    busy_us = sum(b - a for a, b in busy)
    ranges: Dict[str, List[float]] = {name: [] for name in range_names}
    for e in cpu:
        if e.name in ranges and lo <= e.time_range.start <= hi:
            ranges[e.name].append(e.device_time_total / 1e6)
    by_name: Dict[str, float] = {}
    for e in device:
        if lo <= e.time_range.start <= hi:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e6
    device_ops = [[name[:160], s] for name, s in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:10]]
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:10]
    idle_gaps = [[_host_name(cpu, a), (b - a) / 1e6] for a, b in idle]
    return Reduced((hi - lo) / 1e6, busy_us / 1e6, ranges, device_ops,
                   idle_gaps)
