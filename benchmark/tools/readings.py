"""The readings a cell's limits are set from, in one process on the card.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 12 \
        --controls 3 --seconds 3 [--base <first seed>] [--out <file>]

For each of ``--seeds`` seeds, a run of the cell's driver with a short
window and every compared number read without a limit (the program's
readings); then, for ``--controls`` seeds, the driver's ``control``: the
reference computed in the precision below the configuration's, in the
program's place (the control's readings). One JSON line a reading.
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark import harness  # noqa: E402


class _NoLimits(dict):
    def __missing__(self, key):
        return float("inf")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--base", type=int, default=3_000_000_000)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.bench_spec()
    cell = harness.find_cell(spec, args.workload)
    traffic = harness.load_traffic(cell["traffic"])
    driver = harness.load_driver(traffic["driver"])
    config = harness.load_config(cell["config"])
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, values, extra=None):
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "seed": seed, **values, **(extra or {})})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def context(seed, tmpdir):
        return harness.Context(
            cell=cell, config=config, traffic=traffic, limits=_NoLimits(),
            seed=seed, seconds=args.seconds, trace=False,
            device=torch.device("cuda", 0), t0=time.perf_counter(),
            tmpdir=tmpdir)

    for i in range(args.seeds):
        seed = args.base + 7919 * i
        with harness.run_tmpdir() as tmpdir:
            ctx = context(seed, tmpdir)
            outcome = driver.run(ctx)
        emit("program", seed, {k: c["value"] for k, c in ctx.checks.items()},
             {"failed": outcome.failed, "attempted": outcome.attempted})
    for i in range(args.controls):
        seed = args.base + 104729 * (i + 1)
        with harness.run_tmpdir() as tmpdir:
            emit("control", seed, driver.control(context(seed, tmpdir)))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
