"""The SAM serving cell's own parts on the CPU: its counts worked by hand,
its weights under HF's names as the port reads them, its boxes, the
driver's whole run at a tiny size (the window, the traced slice, the
readers, the check) and the same run with the served masks altered, where
``correct`` must come out false; on the card, the fp8 control and five
faults planted in the served path against the cell's limit: the bias left
out, rel_h and rel_w swapped, the global blocks run windowed, the runner's
boxes dropped (the whole image's box instead) and rolled by one row."""

import math
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from benchmark import counts_sam, harness, weights_sam
from benchmark import run as run_mod
from benchmark.tests import tiny, tiny_sam

CELL = "serve_sam_h_bulk8"
# The slice opens with the window, so that its first batch, whose CPU
# forward runs inside the dispatch, lies inside it however slow the host.
SERVE = dict(batch=2, pool=8, warm_batches=1, check_batches=2,
             trace_start_s=0.0, trace_slice_s=1.0, reference_block=1,
             box_side_min=16, box_side_max=96)


@pytest.fixture
def tiny_preset(monkeypatch):
    from visiontransformer_tpu_torch.models import sam
    monkeypatch.setitem(sam.SAM_PRESETS, tiny_sam.SAM_TINY,
                        tiny_sam.SAM_TINY_GEOMETRY)


def test_counts_by_hand():
    cfg = harness.load_config("sam_vit_h_1024")
    hf = cfg["hf_config"]
    assert counts_sam.grid(hf) == 64
    shapes = counts_sam.attention_shapes(hf, 8)
    assert shapes == {"sam.attention.window": (3200, 196, 80, 14, 14),
                      "sam.attention.global": (128, 4096, 80, 64, 64)}
    # A global call at bucket 8: Q, K, V, O and the two bias terms in bf16,
    # 687 GFLOP (0.695 ms at 989 TFLOP/s).
    n_bytes, n_ops = counts_sam.attention_fwd_counts(128, 4096, 80, 64, 64)
    assert n_bytes == 128 * (4 * 4096 * 80 + 4096 * 128) * 2
    assert n_ops == 4 * 128 * 4096 ** 2 * 80
    # A windowed block (qkv and the output product on the 4,900 padded
    # tokens) and a global one, worked out term by term: 176.87 and 248.30
    # GFLOP.
    c, t, n = 1280, 4900, 4096
    windowed = (2 * t * c * 3 * c + 2 * t * c * c + 4 * t * 196 * c
                + 4 * t * 14 * c + 4 * n * c * 5120)
    global_ = (2 * n * c * 3 * c + 2 * n * c * c + 4 * n * n * c
               + 4 * n * 64 * c + 4 * n * c * 5120)
    assert round(windowed / 1e9, 2) == 176.87
    assert round(global_ / 1e9, 2) == 248.30
    total = counts_sam.forward_flops(cfg)
    assert math.isclose(total, 5.964691752960e12, rel_tol=1e-12)
    encoder = 28 * windowed + 4 * global_ + 2 * n * 768 * c + (
        2 * n * c * 256 + 2 * n * 256 * 256 * 9)
    assert 0 < total - encoder < 4e9                    # the decoder


def test_weights_load_in_the_port_by_hf_names(tiny_preset, tmp_path):
    from visiontransformer_tpu_torch.ckpt.hf_dir import SAM_UNUSED, read_hf_sam

    cfg = tiny_sam.sam_config()
    w = weights_sam.make_weights(cfg, 2 ** 31 + 99, "cpu")
    assert all(torch.equal(v, v.bfloat16().float()) for v in w.values())
    # Kernels at 1/sqrt(fan-in), the relative-position tables at
    # 1/sqrt(head dim).
    qkv = w["vision_encoder.layers.0.attn.qkv.weight"]
    assert 0.7 < float(qkv.std()) * 32 ** 0.5 < 1.3
    table = w["vision_encoder.layers.2.attn.rel_pos_h"]
    assert table.shape == (11, 16)
    assert 0.6 < float(table.std()) * 16 ** 0.5 < 1.4
    path = weights_sam.write_hf_dir(str(tmp_path / "hf"), cfg, w)
    name, scfg, state = read_hf_sam(path)
    assert name == tiny_sam.SAM_TINY and scfg.image_size == 96
    assert set(state) == {k for k in w if not k.startswith(SAM_UNUSED)}
    again = weights_sam.make_weights(cfg, 2 ** 31 + 99, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


def test_boxes_from_the_seed():
    driver = harness.load_driver("serve_bulk_sam")
    boxes = driver.box_pool(2 ** 31 + 5, 256, 1024, 128, 1024)
    again = driver.box_pool(2 ** 31 + 5, 256, 1024, 128, 1024)
    assert np.array_equal(boxes, again) and boxes.dtype == np.float32
    sides = boxes[:, 2:] - boxes[:, :2]
    assert sides.min() >= 128 and sides.max() <= 1024
    assert boxes[:, :2].min() >= 0 and boxes[:, 2:].max() <= 1024
    assert not np.array_equal(boxes, driver.box_pool(2 ** 31 + 6, 256, 1024,
                                                     128, 1024))


def _run(trace=False, seconds=2.0):
    spec = harness.bench_spec()
    w = harness.find_cell(spec, CELL)
    traffic = dict(harness.load_traffic(w["traffic"]), **SERVE)
    driver = harness.load_driver(traffic["driver"])
    with tempfile.TemporaryDirectory() as tmp:
        ctx = tiny.context(tiny_sam.sam_config(), traffic, tmp, trace=trace,
                           seconds=seconds, limits=harness.load_limits(CELL),
                           name=CELL)
        ctx.cell = w
        outcome = driver.run(ctx)
    return run_mod.result_line(ctx, outcome, spec), outcome


@pytest.mark.parametrize("trace", [False, True])
def test_driver_runs_and_is_correct(tiny_preset, trace):
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
        assert "sam.attention_fwd_roofline" not in got
        assert "upsample_argmax_roofline" not in got
        assert set(outcome.trace.ranges) == set(
            counts_sam.ATTENTION_RANGES + ("bench.epilogue",))
        assert all(outcome.trace.ranges.values())   # each kind of call
        # bf16 logits (0, m) in, uint8 masks out.
        assert outcome.layer["epilogue_shape"] == ((2, 24, 24, 2), (96, 96),
                                                   2, 1)
    else:
        assert got == names


def test_altered_masks_fail(tiny_preset, monkeypatch):
    from visiontransformer_tpu_torch.serve import worker
    resolve = worker._PendingMasks.resolve

    def altered(self):
        mask = resolve(self).copy()
        mask[...] = 1 - mask
        return mask
    monkeypatch.setattr(worker._PendingMasks, "resolve", altered)
    line, _ = _run()
    assert not line["correct"]


def test_roofline_reader_sums_both_kinds():
    from benchmark.trace import Reduced

    reader = harness.load_reader("sam.attention_fwd_roofline")
    outcome = harness.Outcome()
    outcome.peaks = {"bytes": 1e12, "bf16": 1e15, "fp32": 1e13}
    outcome.layer["attention_shapes"] = {
        "sam.attention.window": (10, 196, 80, 14, 14),
        "sam.attention.global": (2, 4096, 80, 64, 64)}
    assert reader(outcome) is None          # no trace
    outcome.trace = Reduced(1.0, 0.5, {"sam.attention.window": [],
                                       "sam.attention.global": []}, [], [])
    assert reader(outcome) is None          # a program without the ranges
    outcome.trace.ranges = {"sam.attention.window": [1e-4, 1e-4],
                            "sam.attention.global": [4e-3]}
    least_w = max(10 * (4 * 196 * 80 + 196 * 28) * 2 / 1e12,
                  4 * 10 * 196 ** 2 * 80 / 1e15)
    least_g = max(2 * (4 * 4096 * 80 + 4096 * 128) * 2 / 1e12,
                  4 * 2 * 4096 ** 2 * 80 / 1e15)
    assert math.isclose(reader(outcome),
                        100 * (2 * least_w + least_g) / 4.2e-3)


# Faults planted in the served path: in the encoder (``models/sam.py``),
# the bias left out of the attention core; rel_h and rel_w swapped (SAM's
# windows and grid are square, so the shapes still fit); the global blocks
# run windowed, their tables read at the window's offsets. In the runner
# (``serve/worker.py``), the boxes dropped on their way to the forward, so
# that it takes the whole image's box; the boxes rolled by one row within
# the bucket, so that each image takes its neighbour's.
def plant_fault(monkeypatch, fault):
    from visiontransformer_tpu_torch.models import sam
    from visiontransformer_tpu_torch.serve import worker

    core, block = sam._attention_core, sam._block_attention
    if fault == "boxes_dropped":
        forward = worker.ModelRunner._forward
        monkeypatch.setattr(
            worker.ModelRunner, "_forward",
            lambda self, f, images, device, boxes=None: forward(
                self, f, images, device))
    elif fault == "boxes_rolled":
        prompt_boxes = worker._prompt_boxes

        def rolled(boxes, n, size):
            out = prompt_boxes(boxes, n, size)
            return out if boxes is None else np.roll(out, 1, axis=0)
        monkeypatch.setattr(worker, "_prompt_boxes", rolled)
    elif fault == "no_bias":
        monkeypatch.setattr(sam, "_attention_core", lambda q, k, v, h, w, i:
                            core(q, k, v, torch.zeros_like(h),
                                 torch.zeros_like(w), i))
    elif fault == "swapped":
        monkeypatch.setattr(sam, "_attention_core", lambda q, k, v, h, w, i:
                            core(q, k, v, w, h, i))
    else:
        def windowed(layer, y, cfg, attn_impl):
            if layer.window_size:
                return block(layer, y, cfg, attn_impl)
            layer.window_size = cfg.window_size
            try:
                return block(layer, y, cfg, attn_impl)
            finally:
                layer.window_size = 0
        monkeypatch.setattr(sam, "_block_attention", windowed)


ENCODER_FAULTS = ("no_bias", "swapped", "global_windowed")
PROMPT_FAULTS = ("boxes_dropped", "boxes_rolled")
FAULTS = ENCODER_FAULTS + PROMPT_FAULTS


@pytest.mark.parametrize("fault", ENCODER_FAULTS)
def test_planted_faults_move_the_tiny_masks(tiny_preset, monkeypatch, fault):
    """Each fault changes the tiny model's mask logits by far more than
    fp32 rounding: the check's reading of it is not that of a sound run."""
    from visiontransformer_tpu_torch.models import sam
    from visiontransformer_tpu_torch.models.registry import resolve_model

    cfg = tiny_sam.sam_config()
    w = weights_sam.make_weights(cfg, 3, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = weights_sam.write_hf_dir(tmp + "/hf", cfg, w)
        _, model = resolve_model("sam", tiny_sam.SAM_TINY, num_classes=2,
                                 input_size=96, compute_dtype="float32",
                                 checkpoint_path=path, device="cpu")
    x = torch.rand(2, 96, 96, 3, generator=torch.Generator().manual_seed(1))
    boxes = torch.tensor([[4.0, 8.0, 80.0, 70.0]] * 2)
    with torch.no_grad():
        sound = sam.sam_mask_logits(model, x, boxes)
        plant_fault(monkeypatch, fault)
        faulty = sam.sam_mask_logits(model, x, boxes)
    assert float((faulty - sound).abs().max()) > 1e-2 * float(sound.std())


@pytest.mark.parametrize("fault", PROMPT_FAULTS)
def test_planted_prompt_faults_move_the_tiny_masks(tiny_preset, monkeypatch,
                                                   fault):
    """Each runner fault changes the tiny model's served masks, four
    images with boxes of the cell's kind in a bucket of 4: the check sees
    masks other than the sound runner's."""
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    cfg = tiny_sam.sam_config()
    w = weights_sam.make_weights(cfg, 3, "cpu")
    driver = harness.load_driver("serve_bulk_sam")
    images = np.random.default_rng(4).integers(0, 256, (4, 96, 96, 3),
                                               dtype=np.uint8)
    boxes = driver.box_pool(2 ** 31 + 3, 4, 96, 16, 96)
    with tempfile.TemporaryDirectory() as tmp:
        path = weights_sam.write_hf_dir(tmp + "/hf", cfg, w)
        runner = ModelRunner(
            {"model_family": "sam", "config_name": tiny_sam.SAM_TINY,
             "num_classes": 2, "input_size": 96, "checkpoint_path": path},
            compute_dtype="float32", buckets=(4,), device="cpu")
    sound = runner.dispatch(images, boxes=boxes).resolve()
    plant_fault(monkeypatch, fault)
    faulty = runner.dispatch(images, boxes=boxes).resolve()
    assert (sound != faulty).mean() > 0.01


def _card_ctx(card, traffic, tmp, seed):
    spec = harness.bench_spec()
    w = harness.find_cell(spec, CELL)
    return spec, harness.Context(
        cell=w, config=harness.load_config(w["config"]), traffic=traffic,
        limits=harness.load_limits(CELL), seed=seed, seconds=1.0,
        trace=False, device=card, t0=time.perf_counter(), tmpdir=tmp)


@pytest.mark.card
def test_control_is_not_correct(card):
    """The fp8 control at the cell's widths, on one batch of the cell."""
    traffic = dict(harness.load_traffic("bulk8_sam"), check_batches=1)
    driver = harness.load_driver(traffic["driver"])
    with tempfile.TemporaryDirectory() as tmp:
        spec, ctx = _card_ctx(card, traffic, tmp, 2 ** 31 + 17)
        readings = driver.control(ctx)
    ctx.trace = True
    outcome = harness.Outcome()
    outcome.attempted = 1
    line = run_mod.result_line(ctx, outcome, spec)
    print(CELL, "control", line["checks"], readings, file=sys.stderr)
    assert not line["correct"], line["checks"]


@pytest.mark.card
@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_is_not_correct(card, monkeypatch, fault):
    """A fault in the served path at the cell's widths, on one batch of the
    cell through its own check."""
    plant_fault(monkeypatch, fault)
    traffic = dict(harness.load_traffic("bulk8_sam"), check_batches=1,
                   trace_start_s=0.0, trace_slice_s=0.0)
    driver = harness.load_driver(traffic["driver"])
    with tempfile.TemporaryDirectory() as tmp:
        spec, ctx = _card_ctx(card, traffic, tmp, 2 ** 31 + 29)
        outcome = driver.run(ctx)
    line = run_mod.result_line(ctx, outcome, spec)
    print(CELL, fault, line["checks"], file=sys.stderr)
    assert not line["correct"], line["checks"]


def test_reference_is_plain():
    """The new reference imports neither JAX nor the port."""
    import ast
    import os

    path = os.path.join(harness.BENCH_DIR, "reference", "sam.py")
    tree = ast.parse(open(path).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert names <= {"__future__", "math", "typing", "torch", "benchmark"}
