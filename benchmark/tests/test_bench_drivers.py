"""Each traffic driver's whole run on the CPU at a tiny size: the window,
the traced slice, the per-layer readers and the check against the
reference; then the same run with the timed path broken underneath, once
for each fault the cell can have, where ``correct`` must come out false.
The look for a card is run.py's and is skipped here (``tiny.context``)."""

import numpy as np
import pytest
import torch

from benchmark import harness, run as run_mod
from benchmark.tests import tiny


def _run(cell, traffic_overrides, *, trace=False, seconds=2.0):
    import tempfile
    spec = harness.bench_spec()
    w = harness.find_cell(spec, cell)
    cfg = tiny.config(w["config"])
    traffic = dict(harness.load_traffic(w["traffic"]), **traffic_overrides)
    driver = harness.load_driver(traffic["driver"])
    with tempfile.TemporaryDirectory() as tmp:
        ctx = tiny.context(cfg, traffic, tmp, trace=trace, seconds=seconds,
                           limits=harness.load_limits(cell), name=cell)
        ctx.cell = w
        outcome = driver.run(ctx)
    return run_mod.result_line(ctx, outcome, spec)


SERVE = dict(batch=4, pool=16, warm_batches=2, check_batches=2,
             trace_start_s=0.3, trace_slice_s=0.5)


@pytest.mark.parametrize("cell,over,trace", [
    ("serve_b16_bulk", SERVE, False), ("serve_b16_bulk", SERVE, True),
    ("serve_p4_bulk", SERVE, False), ("serve_p4_bulk", SERVE, True)])
def test_driver_runs_and_is_correct(cell, over, trace):
    line = _run(cell, over, trace=trace, seconds=2.5)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    names = {m["name"] for m in harness.cell_metrics(
        harness.bench_spec(), cell, "per_layer" if trace else "end_to_end")}
    got = set(line["metrics"])
    if trace:
        # On the CPU no device time is attributed: the rooflines stay out.
        assert got <= names and got, (got, names)
        assert "busy_s" in line["device"] and "breakdown" in line
    else:
        assert got == names


# ------------------------------------------------------------- the faults
@pytest.fixture
def restore():
    undo = []
    yield undo.append
    for obj, name, value in reversed(undo):
        setattr(obj, name, value)


def _patch(restore, obj, name, value):
    restore((obj, name, getattr(obj, name)))
    setattr(obj, name, value)


def _alter_mask(mask: np.ndarray, classes: int = 17) -> np.ndarray:
    mask = mask.copy()
    mask[..., :8, :8] = (mask[..., :8, :8] + 1) % classes
    return mask


def test_serve_altered_masks_fail(restore):
    from visiontransformer_tpu_torch.serve import worker
    resolve = worker._PendingMasks.resolve
    _patch(restore, worker._PendingMasks, "resolve",
           lambda self: _alter_mask(resolve(self)))
    assert not _run("serve_b16_bulk", SERVE)["correct"]


def test_serve_half_batch_left_out_fails(restore):
    from visiontransformer_tpu_torch.serve import worker
    forward = worker.ModelRunner._forward

    def half(self, model, images, device):
        n = len(images) // 2
        masks = forward(self, model, images[:n], device)
        return torch.cat([masks, torch.zeros_like(masks)])
    _patch(restore, worker.ModelRunner, "_forward", half)
    assert not _run("serve_b16_bulk", SERVE)["correct"]
