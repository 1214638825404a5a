"""What every cell shares: finding its parts by name, the run's context,
the traced slice, the checks and the result line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration, found in
``benchmark/configs/<config>.json``, and a traffic mix, found in
``benchmark/traffic/<traffic>.json``. The mix names the driver that runs it
(``benchmark/drivers/<driver>.py``) and holds its parameters; the limits
of the cell's correctness checks are in ``benchmark/limits/<cell>.json``;
each per-layer metric is read by ``benchmark/metrics/<metric>.py``. Adding
any of them takes new files and entries only.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
REPO_ROOT = BENCH_DIR.parent
SPEC_FILE = REPO_ROOT / "BENCHMARK.json"

# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "visiontransformer_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file of the benchmark by path, as ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bench_spec(path: Path = SPEC_FILE) -> dict:
    return load_json(path)


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[c['name'] for c in spec['workloads']]}")


def load_config(name: str, root: Path = BENCH_DIR) -> dict:
    return load_json(root / "configs" / f"{name}.json")


def load_traffic(name: str, root: Path = BENCH_DIR) -> dict:
    return load_json(root / "traffic" / f"{name}.json")


def load_limits(cell: str, root: Path = BENCH_DIR) -> dict:
    return load_json(root / "limits" / f"{cell}.json")


def load_driver(name: str, root: Path = BENCH_DIR):
    return load_module(root / "drivers" / f"{name}.py",
                       f"bench_driver_{name}")


def load_reader(name: str, root: Path = BENCH_DIR):
    """The ``read(outcome)`` function of a per-layer metric."""
    safe = name.replace(".", "_").replace("-", "_")
    return load_module(root / "metrics" / f"{name}.py",
                       f"bench_metric_{safe}").read


def cell_metrics(spec: dict, cell: str, key: str) -> List[dict]:
    """The cell's metrics of ``key`` ("end_to_end" or "per_layer"): those
    listing it, and those that list no cells but move a metric it
    reports."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if key == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def forbidden_loaded() -> List[str]:
    """Modules loaded in this process whose top-level name is forbidden,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def set_cache_dirs(root: Path = REPO_ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a cell's first run in a checkout builds. The port builds its CUDA
    libraries into ``visiontransformer_tpu_torch/_build/`` itself."""
    cache = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def quantile(values, q: float) -> Optional[float]:
    """The q-quantile of ``values`` by linear interpolation between order
    statistics (numpy's default), or None for no values."""
    vals = sorted(values)
    if not vals:
        return None
    pos = (len(vals) - 1) * q
    lo = math.floor(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def spread(values) -> float:
    """Inter-quartile distance over the median, with Python's
    ``statistics.quantiles(values, n=4)`` quartiles."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)


def per_second(times, t_start: float, t_stop: float, each: int = 1):
    """Work done in each whole second of a window, from the times each
    unit of ``each`` finished: the window's steadiness, for its run's
    standard error."""
    n = max(1, int(t_stop - t_start))
    counts = [0] * n
    for t in times:
        counts[min(n - 1, max(0, int(t - t_start)))] += each
    return counts


class Context:
    """One run of one cell: its parts, its seed and clocks, and the
    record of what it measured."""

    def __init__(self, *, cell: dict, config: dict, traffic: dict,
                 limits: dict, seed: int, seconds: float, trace: bool,
                 device, t0: float, tmpdir: str):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.limits = limits
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t0, self.tmpdir = device, t0, tmpdir
        self.setup_s: Optional[float] = None
        self.checks: Dict[str, dict] = {}

    def setup_done(self) -> None:
        """Set-up ends where the first timed request or step begins."""
        self.setup_s = time.perf_counter() - self.t0

    def check(self, name: str, value: float) -> bool:
        """Hold a compared number to its limit (``limits/<cell>.json``);
        a number that is not finite fails."""
        limit = self.limits[name]
        ok = math.isfinite(value) and value <= limit
        self.checks[name] = {"value": value, "limit": limit, "ok": ok}
        return ok


class Outcome:
    """What a driver hands back: the counts, the end-to-end values, the
    layers' records for the per-layer readers and the device trace."""

    def __init__(self):
        self.attempted = 0
        self.failed = 0
        self.end_to_end: Dict[str, float] = {}
        self.layer: Dict[str, object] = {}
        self.trace = None               # trace.Reduced of the traced slice
        self.memory_peak_bytes = 0
        self.device_name = ""
        self.peaks: dict = {}


class Slice:
    """The traced slice of a window: torch.profiler over ``seconds`` of
    host time starting ``start_after`` seconds into the window. ``poll``
    is called by the driver's loop; it starts and stops the profiler. With
    tracing off it does nothing."""

    def __init__(self, enabled: bool, start_after: float, seconds: float):
        self.enabled = enabled
        self.start_after, self.seconds = start_after, seconds
        self.prof = None
        self.window0 = None
        self.t_start = self.t_stop = self.t_resumed = None
        self._range = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t_stop is None

    def prepare(self) -> None:
        """In set-up: one empty profile, so that the profiler's first start
        (loading and initialising its tracer) falls outside the window."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            pass

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._range = torch.profiler.record_function("bench.slice")
        self._range.__enter__()
        self.t_start = time.perf_counter()

    def _stop(self) -> None:
        """End the slice, then stop the profiler (its stop waits for the
        device, after the slice)."""
        self.t_stop = time.perf_counter()
        self._range.__exit__(None, None, None)
        self.prof.stop()
        self.t_resumed = time.perf_counter()

    def poll(self, now: float) -> None:
        if (not self.enabled or self.window0 is None
                or self.t_stop is not None):
            return
        if self.prof is None:
            if now - self.window0 >= self.start_after:
                self._start()
        elif now - self.t_start >= self.seconds:
            self._stop()

    def begin(self, now: float) -> None:
        self.window0 = now
        self.poll(now)

    def close(self) -> None:
        """At the window's end: stop a slice still open (the window was
        shorter than the slice asked for)."""
        if self.prof is not None and self.t_stop is None:
            self._stop()

    def untraced(self, t: float) -> bool:
        """Whether t falls outside the profiler's whole stay: its slice and
        the stop that follows it."""
        return (self.t_start is None or t < self.t_start
                or (self.t_resumed is not None and t > self.t_resumed))

    def untraced_seconds(self, t_end: float) -> float:
        """The seconds from the window's start to ``t_end`` outside the
        profiler's whole stay."""
        if self.t_start is None:
            return t_end - self.window0
        after = t_end - self.t_resumed if self.t_resumed is not None else 0.0
        return self.t_start - self.window0 + max(0.0, after)

    @property
    def length(self) -> Optional[float]:
        if self.t_start is None or self.t_stop is None:
            return None
        return self.t_stop - self.t_start


@contextlib.contextmanager
def tracing_range(name: str, on: bool):
    """A ``record_function`` range when tracing, else nothing."""
    if not on:
        yield
        return
    import torch
    with torch.profiler.record_function(name):
        yield


def run_tmpdir() -> tempfile.TemporaryDirectory:
    """A scratch directory under TMPDIR, removed at the end of the run."""
    return tempfile.TemporaryDirectory(prefix="bench-")


# The drivers run on the card; the CPU tests drive the same code at a tiny
# size, where these do nothing (run.py itself refuses a host without a
# card).
def device_name(device) -> str:
    import torch
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


def synchronize(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free_cache(device) -> None:
    import gc

    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reset_peak(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> int:
    import torch
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))
