"""Bulk serving: a closed loop of full buckets through the model runner.

Set-up: the weights from the seed (``benchmark/weights.py``) into a
checkpoint under the run's scratch directory, loaded by
``ModelRunner`` (the port's ``resolve_model``) with one bucket, the
traffic's batch; a pool of seeded uint8 images; the runner's own warm-up
of its bucket, then a few batches through the timed loop's pattern.

Window: ``ModelRunner.dispatch`` of the next ``batch`` images of the pool,
and ``resolve`` of the oldest batch whenever more than ``in_flight`` are
dispatched, as ``InferenceWorker._loop`` keeps them; at the window's end
the batches still in flight are resolved inside it. ``masks_per_s`` is
every mask returned to host memory over the whole window.

Check: a sample of the window's batches, drawn from the seed, against the
fp32 reference (``reference/vitseg.py``): the widest gap by which a
served class's reference logit lies below the reference's best.
"""

from __future__ import annotations

import collections
import os
import shutil
import sys
import time

import numpy as np

from benchmark import counts, harness, trace
from benchmark.reference import vitseg as ref
from benchmark.weights import make_weights

# Each stream of the run's randomness comes from the seed and its own
# constant, so the streams never coincide.
_POOL_STREAM = 0x5EED_1
_SAMPLE_STREAM = 0x5EED_2


def image_pool(seed: int, n: int, size: int, device) -> np.ndarray:
    """(n, size, size, 3) uint8 images from the seed, made on the device."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed ^ _POOL_STREAM)
    return torch.randint(0, 256, (n, size, size, 3), generator=gen,
                         device=device, dtype=torch.uint8).cpu().numpy()


def load_runner(ctx, weights_dir: str):
    """The port's runner with the seeded weights, through a checkpoint."""
    from visiontransformer_tpu_torch.ckpt.io import save_checkpoint
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    cfg = ctx.config
    weights = make_weights(cfg, ctx.seed, ctx.device)
    path = save_checkpoint(weights_dir, {"params": weights}, epoch=0,
                           step=0)
    del weights
    harness.free_cache(ctx.device)
    harness.reset_peak(ctx.device)
    row = {"model_family": "vitseg", "config_name": cfg["port_config_name"],
           "num_classes": cfg["num_classes"],
           "input_size": cfg["image_size"], "checkpoint_path": path}
    runner = ModelRunner(row, compute_dtype=cfg["compute_dtype"],
                         buckets=(ctx.traffic["batch"],), device=ctx.device)
    shutil.rmtree(weights_dir)
    return runner


def traced_layers(on: bool, record: dict):
    """While tracing, put a ``bench.<layer>`` range around the model's own
    calls into attention (``models/vit.py``) and the epilogue
    (``models/vitseg.py``), recording the shape of each; returns a function
    that takes them away again."""
    if not on:
        return lambda: None
    import torch
    from visiontransformer_tpu_torch.models import vit, vitseg

    attention, epilogue = vit.multi_head_attention, vitseg.upsample_argmax

    def attention_ranged(q, k, v, **kwargs):
        record["attention_shape"] = (q.shape[0] * q.shape[1], q.shape[2],
                                     q.shape[3], q.element_size())
        with torch.profiler.record_function("bench.attention"):
            return attention(q, k, v, **kwargs)

    def epilogue_ranged(x, size, **kwargs):
        out_dtype = kwargs.get("out_dtype")
        record["epilogue_shape"] = (
            tuple(x.shape), tuple(size), x.element_size(),
            1 if out_dtype is not None and out_dtype.itemsize == 1 else 4)
        with torch.profiler.record_function("bench.epilogue"):
            return epilogue(x, size, **kwargs)

    vit.multi_head_attention = attention_ranged
    vitseg.upsample_argmax = epilogue_ranged

    def restore():
        vit.multi_head_attention = attention
        vitseg.upsample_argmax = epilogue
    return restore


class Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from a seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.items, self.seen = size, [], 0
        self.rng = np.random.default_rng(seed)

    def offer(self, make):
        if len(self.items) < self.size:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = make()
        self.seen += 1


def window(ctx, runner, pool: np.ndarray, slice_: harness.Slice,
           reservoir: Reservoir, record: dict):
    """The measured loop; returns (masks returned, batches, seconds). A
    batch whose masks come back in another shape or type returns none."""
    tr = ctx.traffic
    batch, in_flight_max = tr["batch"], tr["in_flight"]
    n_pool = len(pool)
    in_flight = collections.deque()
    done = {"masks": 0, "untraced_masks": 0}
    finished = []

    def resolve_one():
        off, pending = in_flight.popleft()
        with harness.tracing_range("bench.resolve", ctx.trace):
            masks = pending.resolve()
        t = time.perf_counter()
        if (masks.shape != (batch,) + pool.shape[1:3]
                or masks.dtype != np.uint8):
            return
        done["masks"] += batch
        finished.append(t)
        if slice_.untraced(t):
            done["untraced_masks"] += batch
        reservoir.offer(lambda: (off, np.array(masks)))

    ordinal = 0
    t_start = time.perf_counter()
    slice_.begin(t_start)
    t_end = t_start + ctx.seconds
    while True:
        now = time.perf_counter()
        slice_.poll(now)
        if now >= t_end:
            break
        off = (ordinal * batch) % n_pool
        with harness.tracing_range("bench.dispatch", ctx.trace):
            pending = runner.dispatch(pool[off:off + batch])
        in_flight.append((off, pending))
        ordinal += 1
        while len(in_flight) > in_flight_max:
            resolve_one()
    while in_flight:
        resolve_one()
    t_stop = time.perf_counter()
    slice_.close()
    record["untraced_masks"] = done["untraced_masks"]
    record["untraced_s"] = slice_.untraced_seconds(t_stop)
    print(f"masks in each second of the window: "
          f"{harness.per_second(finished, t_start, t_stop, batch)}",
          file=sys.stderr)
    return done["masks"], ordinal, t_stop - t_start


def warm(runner, pool: np.ndarray, batch: int, n: int, in_flight: int):
    """``n`` batches through the timed loop's pattern."""
    pending = collections.deque()
    for i in range(n):
        off = (i * batch) % len(pool)
        pending.append(runner.dispatch(pool[off:off + batch]))
        while len(pending) > in_flight:
            pending.popleft().resolve()
    while pending:
        pending.popleft().resolve()


def run(ctx) -> harness.Outcome:
    cfg, tr = ctx.config, ctx.traffic
    out = harness.Outcome()
    out.device_name = harness.device_name(ctx.device)
    out.peaks = counts.peaks_for(out.device_name)
    runner = load_runner(ctx, os.path.join(ctx.tmpdir, "weights"))
    pool = image_pool(ctx.seed, tr["pool"], cfg["image_size"], ctx.device)
    runner.warmup()
    warm(runner, pool, tr["batch"], tr["warm_batches"], tr["in_flight"])
    harness.synchronize(ctx.device)
    record: dict = {}
    restore = traced_layers(ctx.trace, record)
    slice_ = harness.Slice(ctx.trace, tr["trace_start_s"],
                           tr["trace_slice_s"])
    slice_.prepare()
    reservoir = Reservoir(tr["check_batches"], ctx.seed ^ _SAMPLE_STREAM)
    ctx.setup_done()
    masks, batches, seconds = window(ctx, runner, pool, slice_,
                                     reservoir, record)
    restore()
    out.memory_peak_bytes = harness.memory_peak(ctx.device)
    out.attempted = batches * tr["batch"]
    out.failed = out.attempted - masks
    out.end_to_end["masks_per_s"] = masks / seconds
    if slice_.prof is not None:
        out.trace = trace.reduce(slice_.prof,
                                 ("bench.attention", "bench.epilogue"))
        record["slice_s"] = slice_.length
    out.layer.update(record)
    out.layer["flops_per_mask"] = counts.vitseg_forward_flops(cfg)
    del runner, slice_
    harness.free_cache(ctx.device)
    check(ctx, pool, reservoir.items)
    return out


def check(ctx, pool: np.ndarray, sample) -> None:
    """The widest logit gap of the sampled served masks."""
    import torch

    cfg = ctx.config
    w = ref.as_float32(make_weights(cfg, ctx.seed, ctx.device))
    batch = ctx.traffic["batch"]
    gaps = []
    for off, masks in sample:
        images = torch.from_numpy(pool[off:off + batch]).to(ctx.device)
        served = torch.from_numpy(masks).to(ctx.device)
        gaps.append(ref.served_gaps(w, images, served, cfg,
                                    block=ctx.traffic["reference_block"]))
    worst = float(torch.cat(gaps).max()) if gaps else float("inf")
    ctx.check("mask_gap_max", worst)


def control(ctx) -> dict:
    """The control's reading: the fp32 reference computed with fp8 (e4m3)
    operands, the nearest precision below the configuration's bf16, put in
    the program's place on batches of the cell's pool drawn from the seed;
    its masks go through the run's own check (``check``, then
    ``ctx.check``), as the program's served masks do."""
    import torch

    cfg, tr = ctx.config, ctx.traffic
    pool = image_pool(ctx.seed, tr["pool"], cfg["image_size"], ctx.device)
    w = ref.as_float32(make_weights(cfg, ctx.seed, ctx.device))
    rng = np.random.default_rng(ctx.seed ^ _SAMPLE_STREAM)
    n_offsets = len(pool) // tr["batch"]
    picks = rng.choice(n_offsets, size=min(tr["check_batches"], n_offsets),
                       replace=False)
    sample = []
    size = (cfg["image_size"], cfg["image_size"])
    for k in picks:
        off = int(k) * tr["batch"]
        images = torch.from_numpy(pool[off:off + tr["batch"]]).to(ctx.device)
        masks = ref.control_masks(w, images, cfg, size, ref.fp8_e4m3,
                                  block=tr["reference_block"])
        sample.append((off, masks.to(torch.uint8).cpu().numpy()))
    del w
    harness.free_cache(ctx.device)
    check(ctx, pool, sample)
    return {name: c["value"] for name, c in ctx.checks.items()}
