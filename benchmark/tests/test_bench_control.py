"""On the card: the control, the reference computed in the precision below
the configuration's and put in the program's place, goes through the run's
own check (``ctx.check``) and result line, and must come out as not
correct under each cell's limits, at the cell's own widths (a smaller
batch and sample where the cell's would not fit a test run). Skips
without a card; ``benchmark/tools/readings.py`` reads the same controls
at the cells' full size."""

import sys
import tempfile
import time

import pytest

from benchmark import harness
from benchmark import run as run_mod

CELLS = {
    "serve_b16_bulk": dict(check_batches=1),
    "serve_p4_bulk": dict(batch=8, check_batches=1),
}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(card, cell):
    spec = harness.bench_spec()
    w = harness.find_cell(spec, cell)
    traffic = dict(harness.load_traffic(w["traffic"]), **CELLS[cell])
    driver = harness.load_driver(traffic["driver"])
    with tempfile.TemporaryDirectory() as tmp:
        ctx = harness.Context(
            cell=w, config=harness.load_config(w["config"]),
            traffic=traffic, limits=harness.load_limits(cell),
            seed=2 ** 31 + 17, seconds=1.0, trace=False, device=card,
            t0=time.perf_counter(), tmpdir=tmp)
        readings = driver.control(ctx)
    # The control has no window: its line is read as a traced run's, whose
    # readers find nothing to read, and carries only the checks.
    ctx.trace = True
    outcome = harness.Outcome()
    outcome.attempted = 1
    line = run_mod.result_line(ctx, outcome, spec)
    print(cell, line["checks"], file=sys.stderr)
    assert set(line["checks"]) == set(readings)
    assert not line["correct"], line["checks"]
