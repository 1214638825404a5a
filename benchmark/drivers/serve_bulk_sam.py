"""Bulk serving of SAM with a box prompt an image: ``serve_bulk``'s closed
loop of full buckets through ``ModelRunner``, on a sam row read from an HF
``save_pretrained`` directory, each image dispatched with its box.

Set-up: the weights from the seed under HF's names
(``benchmark/weights_sam.py``), written with the configuration's
``hf_config`` as ``config.json`` and ``pytorch_model.bin`` into the run's
scratch directory, which the port reads as ``register-model --family sam
--ckpt`` has it read (``resolve_model`` through ``ckpt/hf_dir.py``), with
one bucket, the traffic's batch; a pool of seeded uint8 images and one box
an image from the seed (``box_pool``); the runner's warm-up of its bucket,
then a few batches through the timed loop's pattern.

Window: ``serve_bulk.window``, two batches in flight as
``InferenceWorker._loop`` keeps them, over ``PromptedRunner``, which
passes each slice of the pool to ``ModelRunner.dispatch`` with the boxes
of the same rows; ``masks_per_s`` is every mask returned to host memory
over the whole window.

Traced: the device time of the port's own ranges around the attention core
(``sam.attention.window`` and ``sam.attention.global``,
``models/sam.py``), for ``sam.attention_fwd_roofline``, and of a
``bench.epilogue`` range around the masks forward's call of the epilogue
kernel (``SamMasks``), with its shape, for ``upsample_argmax_roofline``; a
program without them reads nothing there.

Check: a sample of the window's batches, drawn from the seed, against the
fp32 reference (``reference/sam.py``), computed an image at a time: the
largest |logit| of the reference where the served bit disagrees with its
sign.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from benchmark import counts, counts_sam, harness, trace
from benchmark import weights_sam as weights
from benchmark.drivers.serve_bulk import Reservoir, image_pool, warm, window
from benchmark.reference import sam as ref
from benchmark.reference.vitseg import fp8_e4m3

# The streams of the run's randomness: the seed and a constant of its own.
_SAMPLE_STREAM = 0x5EED_5A
_BOX_STREAM = 0x5EED_B0


def box_pool(seed: int, n: int, size: int, side_min: int,
             side_max: int) -> np.ndarray:
    """(n, 4) float32 boxes (x0, y0, x1, y1) from the seed: each side a
    whole number of pixels uniform in [side_min, side_max], placed
    uniformly inside the size x size image."""
    rng = np.random.default_rng(seed ^ _BOX_STREAM)
    sides = rng.integers(side_min, side_max + 1, size=(n, 2))
    x0 = rng.integers(0, size - sides[:, 0] + 1)
    y0 = rng.integers(0, size - sides[:, 1] + 1)
    return np.stack([x0, y0, x0 + sides[:, 0], y0 + sides[:, 1]],
                    axis=1).astype(np.float32)


class PromptedRunner:
    """The runner as ``serve_bulk.window`` and ``warm`` call it:
    ``dispatch(images)`` of a slice of the pool dispatches those images
    with the boxes of the same rows."""

    def __init__(self, runner, pool: np.ndarray, boxes: np.ndarray):
        self.runner, self.pool, self.boxes = runner, pool, boxes

    def dispatch(self, images: np.ndarray):
        off = (images.ctypes.data - self.pool.ctypes.data) // \
            self.pool.strides[0]
        if not (np.shares_memory(images, self.pool)
                and 0 <= off <= len(self.pool) - len(images)):
            raise ValueError("PromptedRunner.dispatch takes slices of its "
                             "pool")
        return self.runner.dispatch(images,
                                    boxes=self.boxes[off:off + len(images)])


def traced_epilogue(on: bool, record: dict):
    """While tracing, put a ``bench.epilogue`` range around SAM's call of
    the epilogue (``models/sam.py``), recording its shape as
    ``serve_bulk.traced_layers`` records vitseg's; returns a function that
    takes it away again."""
    if not on:
        return lambda: None
    import torch
    from visiontransformer_tpu_torch.models import sam

    epilogue = getattr(sam, "upsample_argmax", None)
    if epilogue is None:
        return lambda: None

    def epilogue_ranged(x, size, **kwargs):
        out_dtype = kwargs.get("out_dtype")
        record["epilogue_shape"] = (
            tuple(x.shape), tuple(size), x.element_size(),
            1 if out_dtype is not None and out_dtype.itemsize == 1 else 4)
        with torch.profiler.record_function("bench.epilogue"):
            return epilogue(x, size, **kwargs)

    sam.upsample_argmax = epilogue_ranged

    def restore():
        sam.upsample_argmax = epilogue
    return restore


def load_runner(ctx, hf_dir: str):
    """The port's runner on the seeded weights, through an HF directory. A
    program without the family raises before any weight is made."""
    from visiontransformer_tpu_torch.models.registry import get_model_family
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    cfg = ctx.config
    get_model_family(cfg["port_family"])
    weights.write_hf_dir(hf_dir, cfg,
                         weights.make_weights(cfg, ctx.seed, ctx.device))
    harness.free_cache(ctx.device)
    harness.reset_peak(ctx.device)
    row = {"model_family": cfg["port_family"],
           "config_name": cfg["port_config_name"], "num_classes": 2,
           "input_size": cfg["image_size"], "checkpoint_path": hf_dir}
    runner = ModelRunner(row, compute_dtype=cfg["compute_dtype"],
                         buckets=(ctx.traffic["batch"],), device=ctx.device)
    shutil.rmtree(hf_dir)
    return runner


def prompts(ctx):
    """The run's (images, boxes) pools."""
    cfg, tr = ctx.config, ctx.traffic
    pool = image_pool(ctx.seed, tr["pool"], cfg["image_size"], ctx.device)
    boxes = box_pool(ctx.seed, tr["pool"], cfg["image_size"],
                     tr["box_side_min"], tr["box_side_max"])
    return pool, boxes


def run(ctx) -> harness.Outcome:
    cfg, tr = ctx.config, ctx.traffic
    out = harness.Outcome()
    out.device_name = harness.device_name(ctx.device)
    out.peaks = counts.peaks_for(out.device_name)
    runner = load_runner(ctx, os.path.join(ctx.tmpdir, "hf"))
    pool, boxes = prompts(ctx)
    prompted = PromptedRunner(runner, pool, boxes)
    runner.warmup()
    warm(prompted, pool, tr["batch"], tr["warm_batches"], tr["in_flight"])
    harness.synchronize(ctx.device)
    record: dict = {}
    restore = traced_epilogue(ctx.trace, record)
    slice_ = harness.Slice(ctx.trace, tr["trace_start_s"],
                           tr["trace_slice_s"])
    slice_.prepare()
    reservoir = Reservoir(tr["check_batches"], ctx.seed ^ _SAMPLE_STREAM)
    ctx.setup_done()
    masks, batches, seconds = window(ctx, prompted, pool, slice_, reservoir,
                                     record)
    restore()
    out.memory_peak_bytes = harness.memory_peak(ctx.device)
    out.attempted = batches * tr["batch"]
    out.failed = out.attempted - masks
    out.end_to_end["masks_per_s"] = masks / seconds
    if slice_.prof is not None:
        out.trace = trace.reduce(slice_.prof, counts_sam.ATTENTION_RANGES
                                 + ("bench.epilogue",))
        record["slice_s"] = slice_.length
    out.layer.update(record)
    out.layer["flops_per_mask"] = counts_sam.forward_flops(cfg)
    out.layer["attention_shapes"] = counts_sam.attention_shapes(
        cfg["hf_config"], tr["batch"])
    del runner, prompted, slice_
    harness.free_cache(ctx.device)
    check(ctx, pool, boxes, reservoir.items)
    return out


def check(ctx, pool: np.ndarray, boxes: np.ndarray, sample) -> None:
    """The largest logit gap of the sampled served masks."""
    import torch

    cfg = ctx.config
    w = weights.make_weights(cfg, ctx.seed, ctx.device)
    batch = ctx.traffic["batch"]
    gaps = []
    for off, masks in sample:
        images = torch.from_numpy(pool[off:off + batch]).to(ctx.device)
        prompt = torch.from_numpy(boxes[off:off + batch]).to(ctx.device)
        served = torch.from_numpy(masks).to(ctx.device)
        gaps.append(ref.served_gaps(w, images, prompt, served, cfg,
                                    block=ctx.traffic["reference_block"]))
    worst = float(torch.cat(gaps).max()) if gaps else float("inf")
    ctx.check("mask_gap_max", worst)


def control(ctx) -> dict:
    """The control's reading: the fp32 reference computed with fp8 (e4m3)
    operands, the nearest precision below the configuration's bf16, put in
    the program's place on batches of the cell's pool drawn from the seed;
    its masks go through the run's own check (``check``), as the
    program's served masks do."""
    import torch

    tr = ctx.traffic
    pool, boxes = prompts(ctx)
    w = weights.make_weights(ctx.config, ctx.seed, ctx.device)
    rng = np.random.default_rng(ctx.seed ^ _SAMPLE_STREAM)
    n_offsets = len(pool) // tr["batch"]
    picks = rng.choice(n_offsets, size=min(tr["check_batches"], n_offsets),
                       replace=False)
    sample = []
    for k in picks:
        off = int(k) * tr["batch"]
        images = torch.from_numpy(pool[off:off + tr["batch"]]).to(ctx.device)
        prompt = torch.from_numpy(boxes[off:off + tr["batch"]]).to(
            ctx.device)
        masks = ref.control_masks(w, images, prompt, ctx.config, fp8_e4m3,
                                  block=tr["reference_block"])
        sample.append((off, masks.cpu().numpy()))
    del w
    harness.free_cache(ctx.device)
    check(ctx, pool, boxes, sample)
    return {name: c["value"] for name, c in ctx.checks.items()}
