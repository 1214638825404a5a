"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is found by name in
``BENCHMARK.json``; its configuration, traffic mix, driver, limits and
per-layer readers by the names it gives (``benchmark/harness.py``). The
run sets up the program from the seed, measures for ``--seconds``, checks
what the timed path produced against the plain reference
(``benchmark/reference/``), and prints as its last line one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number
beside its limit. The checks are also the last lines of standard error.

It exits non-zero, printing no result, on a host without the CUDA cards
the cell asks for, and when a JAX module or the JAX package has been
loaded into its process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark import harness  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 2


def result_line(ctx, outcome, spec: dict) -> dict:
    """The contract's object, ``checks`` last."""
    cell = ctx.cell["name"]
    metrics = {}
    if ctx.trace:
        for m in harness.cell_metrics(spec, cell, "per_layer"):
            value = harness.load_reader(m["name"])(outcome)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # A driver reports its end-to-end values under its own names; a
        # cell that keeps one apart under another name reads it through
        # that name's reader (``benchmark/metrics/<metric>.py``).
        values = dict(outcome.end_to_end, setup_s=ctx.setup_s)
        for m in harness.cell_metrics(spec, cell, "end_to_end"):
            value = values.get(m["name"])
            if value is None:
                value = harness.load_reader(m["name"])(outcome)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": outcome.device_name,
              "count": ctx.cell["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": bool(ctx.checks) and all(
                c["ok"] for c in ctx.checks.values())
            and outcome.failed == 0,
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if ctx.trace and outcome.trace is not None:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = {"device_ops": outcome.trace.device_ops,
                             "idle_gaps": outcome.trace.idle_gaps}
    line["checks"] = {name: {"value": c["value"], "limit": c["limit"]}
                      for name, c in ctx.checks.items()}
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    spec = harness.bench_spec()
    cell = harness.find_cell(spec, args.workload)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device: the benchmark measures the card and "
                     "has no CPU fallback")
    if torch.cuda.device_count() < cell["chips"]:
        return _fail(f"{args.workload} needs {cell['chips']} CUDA devices, "
                     f"the host has {torch.cuda.device_count()}")
    traffic = harness.load_traffic(cell["traffic"])
    driver = harness.load_driver(traffic["driver"])
    with harness.run_tmpdir() as tmpdir:
        ctx = harness.Context(
            cell=cell, config=harness.load_config(cell["config"]),
            traffic=traffic, limits=harness.load_limits(cell["name"]),
            seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
            device=torch.device("cuda", 0), t0=T0, tmpdir=tmpdir)
        outcome = driver.run(ctx)
    loaded = harness.forbidden_loaded()
    if loaded:
        return _fail(f"forbidden modules loaded in the run's process: "
                     f"{loaded}")
    line = result_line(ctx, outcome, spec)
    for name, c in ctx.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})"
              f"{'' if c['ok'] else ' FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
