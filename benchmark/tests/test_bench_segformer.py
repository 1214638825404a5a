"""The SegFormer serving cell's own parts on the CPU: its counts worked by
hand, its weights under HF's names as the port reads them, the reference
held to the port at a tiny size, the driver's whole run at a tiny size
(the window, the traced slice, the readers, the check) and the same run
with the served masks altered or a fault planted in the attention core,
where ``correct`` must come out false; on the card, the control and the
planted faults against the cell's limit."""

import copy
import math
import sys
import tempfile
import time

import pytest
import torch

from benchmark import counts_segformer, harness
from benchmark import run as run_mod
from benchmark import weights_segformer
from benchmark.reference import segformer as ref
from benchmark.tests import tiny

CELL = "serve_segformer_b5_bulk8"
# MiT-B0's geometry (the smallest preset the port matches by geometry) and
# its published decoder width, at a 64 x 64 crop.
B0 = dict(hidden_sizes=[32, 64, 160, 256], depths=[2, 2, 2, 2],
          decoder_hidden_size=256)
# The slice opens with the window, so that its first batch, whose CPU
# forward runs inside the dispatch, lies inside it however slow the host.
SERVE = dict(batch=2, pool=8, warm_batches=1, check_batches=2,
             trace_start_s=0.0, trace_slice_s=1.0, reference_block=1)


def tiny_config(**hf):
    cfg = copy.deepcopy(harness.load_config("segformer_b5_1024"))
    cfg["hf_config"].update(B0, **hf)
    cfg.update(crop_size=64, port_config_name="mit_b0")
    return cfg


def test_counts_by_hand():
    cfg = harness.load_config("segformer_b5_1024")
    hf = cfg["hf_config"]
    assert counts_segformer.stage_grids(hf, 1024) == [256, 128, 64, 32]
    shapes = counts_segformer.attention_shapes(hf, 1024, 8)
    assert shapes == {"mit.attention.1": (8, 65536, 1024, 64),
                      "mit.attention.2": (16, 16384, 1024, 64),
                      "mit.attention.3": (40, 4096, 1024, 64),
                      "mit.attention.4": (64, 1024, 1024, 64)}
    # Stage 1 at batch 8: Q and O 8·65,536·64, K and V 8·1,024·64, bf16.
    n_bytes, n_ops = counts_segformer.attention_fwd_counts(8, 65536, 1024,
                                                           64)
    assert n_bytes == 2 * 8 * (65536 + 1024) * 64 * 2
    assert n_ops == 4 * 8 * 65536 * 1024 * 64
    # Q.K^T and P.V of one image over the 52 blocks: 324.27 GFLOP.
    per_image = counts_segformer.attention_shapes(hf, 1024, 1)
    attention = sum(d * counts_segformer.attention_fwd_counts(*s)[1]
                    for d, s in zip(hf["depths"], per_image.values()))
    assert attention == 4 * 64 * 1024 * (65536 * 3 + 16384 * 2 * 6
                                         + 4096 * 5 * 40 + 1024 * 8 * 3)
    # Stage 4 alone (one block, 32² tokens, C = 512, no reduction):
    # q, k, v, proj 4·2·N·C², attention 4·N²·C, fc1 + fc2 2·2·N·C·4C,
    # depthwise 2·N·4C·9.
    n, c = 1024, 512
    block4 = 8 * n * c * c + 4 * n * n * c + 16 * n * c * c + 72 * n * c
    total = counts_segformer.forward_flops(cfg)
    assert math.isclose(total, 1.122097954816e12, rel_tol=1e-12)
    deeper = copy.deepcopy(cfg)
    deeper["hf_config"]["depths"] = [3, 6, 40, 4]
    assert counts_segformer.forward_flops(deeper) - total == block4
    # The decoder's fuse, 4 x 768 -> 768 at 256²: 309 GFLOP.
    assert 2 * 65536 * 3072 * 768 == 309237645312


def test_weights_load_in_the_port_by_hf_names(tmp_path):
    from visiontransformer_tpu_torch.ckpt.hf_dir import read_hf_segformer

    cfg = tiny_config()
    w = weights_segformer.make_weights(cfg, 2 ** 31 + 99, "cpu")
    assert all(torch.equal(v, v.bfloat16().float()) for v in w.values())
    assert (w["decode_head.batch_norm.running_var"] > 0).all()
    path = weights_segformer.write_hf_dir(str(tmp_path / "hf"), cfg, w)
    info, state = read_hf_segformer(path)
    assert info == {"encoder_name": "mit_b0", "num_labels": 19,
                    "decoder_hidden_size": 256}
    assert set(state) == set(w) | {
        "decode_head.batch_norm.num_batches_tracked"}
    again = weights_segformer.make_weights(cfg, 2 ** 31 + 99, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


def test_reference_matches_the_port_at_fp32(tmp_path):
    """The port's fp32 forward on the same HF directory: logits within
    1e-4 (fp32 sums in other orders over 8 blocks and the decoder; the
    logits are ~0.1)."""
    from visiontransformer_tpu_torch.models.registry import resolve_model

    cfg = tiny_config()
    w = weights_segformer.make_weights(cfg, 7, "cpu")
    path = weights_segformer.write_hf_dir(str(tmp_path / "hf"), cfg, w)
    _, model = resolve_model("segformer", "mit_b0", num_classes=19,
                             input_size=64, compute_dtype="float32",
                             checkpoint_path=path, device="cpu")
    images = torch.randint(0, 256, (2, 64, 64, 3),
                           generator=torch.Generator().manual_seed(3),
                           dtype=torch.uint8)
    with torch.no_grad():
        got = model(images.float() / 255.0)
        want = ref.logits(w, images, cfg)
    assert got.shape == want.shape == (2, 64, 64, 19)
    assert float((got - want).abs().max()) < 1e-4
    assert float(ref.served_gaps(w, images, got.argmax(-1), cfg).max()) \
        < 1e-4


def _run(trace=False, seconds=2.0, cfg=None):
    spec = harness.bench_spec()
    w = harness.find_cell(spec, CELL)
    traffic = dict(harness.load_traffic(w["traffic"]), **SERVE)
    driver = harness.load_driver(traffic["driver"])
    with tempfile.TemporaryDirectory() as tmp:
        ctx = tiny.context(cfg or tiny_config(), traffic, tmp, trace=trace,
                           seconds=seconds, limits=harness.load_limits(CELL),
                           name=CELL)
        ctx.cell = w
        outcome = driver.run(ctx)
    return run_mod.result_line(ctx, outcome, spec), outcome


@pytest.mark.parametrize("trace", [False, True])
def test_driver_runs_and_is_correct(trace):
    line, outcome = _run(trace=trace, seconds=2.5)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    names = {m["name"] for m in harness.cell_metrics(
        harness.bench_spec(), CELL, "per_layer" if trace else "end_to_end")}
    got = set(line["metrics"])
    if trace:
        # On the CPU no device time is attributed: the roofline stays out.
        assert got <= names and got, (got, names)
        assert "sf.attention_fwd_roofline" not in got
        assert set(outcome.trace.ranges) == set(
            counts_segformer.ATTENTION_RANGES)
        assert all(outcome.trace.ranges.values())  # each stage's calls
    else:
        assert got == names


def test_altered_masks_fail(monkeypatch):
    from visiontransformer_tpu_torch.serve import worker
    resolve = worker._PendingMasks.resolve

    def altered(self):
        mask = resolve(self).copy()
        mask[..., :8, :8] = (mask[..., :8, :8] + 1) % 19
        return mask
    monkeypatch.setattr(worker._PendingMasks, "resolve", altered)
    line, _ = _run()
    assert not line["correct"]


# Faults planted in the served path's attention core (``models/mit.py``:
# q, k, v in, its output out, whatever implements it): the logit scale
# dropped, as a kernel that forgot it would compute; every key weighted
# alike, as a kernel that returned mean(V) would.
ATTENTION_FAULTS = {
    "unscaled": lambda q, k, v, impl, core: core(
        q * math.sqrt(q.shape[-1]), k, v, impl),
    "uniform": lambda q, k, v, impl, core: v.mean(-2, keepdim=True).expand(
        *q.shape[:-1], v.shape[-1]),
}


def plant_attention_fault(monkeypatch, fault):
    from visiontransformer_tpu_torch.models import mit

    core = mit._attention
    monkeypatch.setattr(mit, "_attention", lambda q, k, v, impl:
                        ATTENTION_FAULTS[fault](q, k, v, impl, core))


@pytest.mark.parametrize("fault", sorted(ATTENTION_FAULTS))
def test_attention_fault_fails(monkeypatch, fault):
    """At B5's depth and widths on a 64² crop: at B0's two blocks a stage
    either fault moves the masks too little to read (a gap of 0.005)."""
    plant_attention_fault(monkeypatch, fault)
    cfg = copy.deepcopy(harness.load_config("segformer_b5_1024"))
    cfg["crop_size"] = 64
    line, _ = _run(cfg=cfg)
    assert not line["correct"], line["checks"]


def test_roofline_reader_sums_every_stage():
    from benchmark.trace import Reduced

    reader = harness.load_reader("sf.attention_fwd_roofline")
    outcome = harness.Outcome()
    outcome.peaks = {"bytes": 1e12, "bf16": 1e15, "fp32": 1e13}
    outcome.layer["attention_shapes"] = {
        "mit.attention.1": (1, 1000, 10, 64),
        "mit.attention.2": (2, 100, 100, 64)}
    assert reader(outcome) is None          # no trace
    outcome.trace = Reduced(1.0, 0.5, {"mit.attention.1": [],
                                       "mit.attention.2": []}, [], [])
    assert reader(outcome) is None          # a program without the ranges
    outcome.trace.ranges = {"mit.attention.1": [1e-6, 1e-6],
                            "mit.attention.2": [4e-6]}
    least1 = max(2 * 1010 * 64 * 2 / 1e12, 4 * 1000 * 10 * 64 / 1e15)
    least2 = max(2 * 2 * 200 * 64 * 2 / 1e12, 4 * 2 * 100 * 100 * 64 / 1e15)
    assert math.isclose(reader(outcome),
                        100 * (2 * least1 + least2) / 6e-6)


@pytest.mark.card
def test_control_is_not_correct(card):
    """The fp8 control at the cell's widths, on one batch of the cell."""
    spec = harness.bench_spec()
    w = harness.find_cell(spec, CELL)
    traffic = dict(harness.load_traffic(w["traffic"]), check_batches=1)
    driver = harness.load_driver(traffic["driver"])
    with tempfile.TemporaryDirectory() as tmp:
        ctx = harness.Context(
            cell=w, config=harness.load_config(w["config"]),
            traffic=traffic, limits=harness.load_limits(CELL),
            seed=2 ** 31 + 17, seconds=1.0, trace=False, device=card,
            t0=time.perf_counter(), tmpdir=tmp)
        readings = driver.control(ctx)
    ctx.trace = True
    outcome = harness.Outcome()
    outcome.attempted = 1
    line = run_mod.result_line(ctx, outcome, spec)
    print(CELL, line["checks"], readings, file=sys.stderr)
    assert not line["correct"], line["checks"]


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(ATTENTION_FAULTS))
def test_attention_fault_is_not_correct(card, monkeypatch, fault):
    """A fault in the attention core at the cell's widths and crop, on
    one batch of the cell through its own check."""
    plant_attention_fault(monkeypatch, fault)
    spec = harness.bench_spec()
    w = harness.find_cell(spec, CELL)
    traffic = dict(harness.load_traffic(w["traffic"]), check_batches=1,
                   trace_start_s=0.0, trace_slice_s=0.0)
    driver = harness.load_driver(traffic["driver"])
    with tempfile.TemporaryDirectory() as tmp:
        ctx = harness.Context(
            cell=w, config=harness.load_config(w["config"]),
            traffic=traffic, limits=harness.load_limits(CELL),
            seed=2 ** 31 + 29, seconds=1.0, trace=False, device=card,
            t0=time.perf_counter(), tmpdir=tmp)
        outcome = driver.run(ctx)
    line = run_mod.result_line(ctx, outcome, spec)
    print(CELL, fault, line["checks"], file=sys.stderr)
    assert not line["correct"], line["checks"]


def test_reference_is_plain():
    """The new reference imports neither JAX nor the port (the guard of
    ``test_bench_guard.py`` walks every file; this names the new one)."""
    import ast
    import os

    path = os.path.join(harness.BENCH_DIR, "reference", "segformer.py")
    tree = ast.parse(open(path).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert names <= {"__future__", "math", "typing", "torch", "benchmark"}
