"""The spread of a cell's end-to-end metrics, from which its bounds are set.

    python3 benchmark/tools/sets.py --workload <cell> --seeds a,b,c,d,e,f \
        --sets 2 --seconds <run_seconds> [--out <file>]

Runs ``benchmark/run.py`` as its own process once, with a short window,
to build (not counted), then ``--sets`` sets of one run a seed, the same
seeds in every set, each run a new process as the check makes them. For each metric it prints the
values of each set, each set's median and spread (the distance between
the first and third quartiles of ``statistics.quantiles(values, n=4)``,
over the median), the spread without each set's run farthest from its
median, and the second set's median over the first's. One JSON line a run,
then one a metric.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark import harness  # noqa: E402


def run_once(workload: str, seed: int, seconds: float) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "benchmark", "run.py"),
         "--workload", workload, "--seed", str(seed), "--seconds",
         str(seconds), "--trace", "0"],
        cwd=_ROOT, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode or not lines:
        return {"seed": seed, "rc": proc.returncode,
                "stderr": proc.stderr[-2000:]}
    # The window's work second by second, as the driver prints it: whether
    # a run's rate wanders inside it or sits at its own level.
    seconds_line = [ln for ln in proc.stderr.splitlines()
                    if " in each second of the window: " in ln]
    per_second = (json.loads(seconds_line[-1].split(": ", 1)[1])
                  if seconds_line else None)
    return dict(json.loads(lines[-1]), seed=seed, rc=0,
                per_second=per_second)


def trimmed(values):
    """The values without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--build-seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(dict(obj, workload=args.workload))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    emit(dict(run_once(args.workload, seeds[0], args.build_seconds),
              set="build"))
    runs = []
    for k in range(args.sets):
        for seed in seeds:
            r = dict(run_once(args.workload, seed, args.seconds), set=k)
            runs.append(r)
            emit({key: r.get(key) for key in ("set", "seed", "rc", "correct",
                                              "metrics", "checks", "stderr",
                                              "per_second")
                  if key in r})
    spec = harness.bench_spec()
    for m in harness.cell_metrics(spec, args.workload, "end_to_end"):
        name = m["name"]
        per_set = [[r["metrics"][name]["value"] for r in runs
                    if r.get("set") == k and r.get("rc") == 0]
                   for k in range(args.sets)]
        if any(len(v) < 4 for v in per_set):
            emit({"metric": name, "error": "too few runs", "values": per_set})
            continue
        emit({"metric": name, "values": per_set,
              "medians": [statistics.median(v) for v in per_set],
              "spreads": [harness.spread(v) for v in per_set],
              "trimmed_spreads": [harness.spread(trimmed(v))
                                  for v in per_set],
              "all_spread": harness.spread([x for v in per_set for x in v]),
              "second_over_first": statistics.median(per_set[-1])
              / statistics.median(per_set[0])})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
