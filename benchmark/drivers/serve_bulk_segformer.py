"""Bulk serving of SegFormer at its crop: ``serve_bulk``'s closed loop of
full buckets through ``ModelRunner``, on a segformer row read from an HF
``save_pretrained`` directory.

Set-up: the weights and BatchNorm statistics from the seed under HF's
names (``benchmark/weights_segformer.py``), written with the
configuration's ``hf_config`` as ``config.json`` and ``pytorch_model.bin``
into the run's scratch directory, which the port reads as
``register-model --family segformer --ckpt`` has it read (``resolve_model``
through ``ckpt/hf_dir.py``), with one bucket, the traffic's batch; then,
as ``serve_bulk``: a pool of seeded uint8 crops, the runner's warm-up of
its bucket, a few batches through the timed loop's pattern.

Window: ``serve_bulk.window``, two batches in flight as
``InferenceWorker._loop`` keeps them; ``masks_per_s`` is every mask
returned to host memory over the whole window.

Traced: the device time of the port's own ranges around each stage's
attention core (``mit.attention.1`` ... ``.4``, ``models/mit.py``), for
``sf.attention_fwd_roofline``; a program without them reads nothing there.

Check: a sample of the window's batches, drawn from the seed, against the
fp32 reference (``reference/segformer.py``), computed a block of images at
a time: the widest gap by which a served class's reference logit lies
below the reference's best.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from benchmark import counts, counts_segformer, harness, trace
from benchmark import weights_segformer as weights
from benchmark.drivers.serve_bulk import Reservoir, image_pool, warm, window
from benchmark.reference import segformer as ref
from benchmark.reference.vitseg import fp8_e4m3

# The sample's stream of the run's randomness: the seed and a constant of
# its own.
_SAMPLE_STREAM = 0x5EED_5F


def load_runner(ctx, hf_dir: str):
    """The port's runner on the seeded weights, through an HF directory."""
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    cfg = ctx.config
    weights.write_hf_dir(hf_dir, cfg,
                         weights.make_weights(cfg, ctx.seed, ctx.device))
    harness.free_cache(ctx.device)
    harness.reset_peak(ctx.device)
    row = {"model_family": cfg["port_family"],
           "config_name": cfg["port_config_name"],
           "num_classes": len(cfg["hf_config"]["id2label"]),
           "input_size": cfg["crop_size"], "checkpoint_path": hf_dir}
    runner = ModelRunner(row, compute_dtype=cfg["compute_dtype"],
                         buckets=(ctx.traffic["batch"],), device=ctx.device)
    shutil.rmtree(hf_dir)
    return runner


def run(ctx) -> harness.Outcome:
    cfg, tr = ctx.config, ctx.traffic
    out = harness.Outcome()
    out.device_name = harness.device_name(ctx.device)
    out.peaks = counts.peaks_for(out.device_name)
    runner = load_runner(ctx, os.path.join(ctx.tmpdir, "hf"))
    pool = image_pool(ctx.seed, tr["pool"], cfg["crop_size"], ctx.device)
    runner.warmup()
    warm(runner, pool, tr["batch"], tr["warm_batches"], tr["in_flight"])
    harness.synchronize(ctx.device)
    record: dict = {}
    slice_ = harness.Slice(ctx.trace, tr["trace_start_s"],
                           tr["trace_slice_s"])
    slice_.prepare()
    reservoir = Reservoir(tr["check_batches"], ctx.seed ^ _SAMPLE_STREAM)
    ctx.setup_done()
    masks, batches, seconds = window(ctx, runner, pool, slice_, reservoir,
                                     record)
    out.memory_peak_bytes = harness.memory_peak(ctx.device)
    out.attempted = batches * tr["batch"]
    out.failed = out.attempted - masks
    out.end_to_end["masks_per_s"] = masks / seconds
    if slice_.prof is not None:
        out.trace = trace.reduce(slice_.prof,
                                 counts_segformer.ATTENTION_RANGES)
        record["slice_s"] = slice_.length
    out.layer.update(record)
    out.layer["flops_per_mask"] = counts_segformer.forward_flops(cfg)
    out.layer["attention_shapes"] = counts_segformer.attention_shapes(
        cfg["hf_config"], cfg["crop_size"], tr["batch"])
    del runner, slice_
    harness.free_cache(ctx.device)
    check(ctx, pool, reservoir.items)
    return out


def check(ctx, pool: np.ndarray, sample) -> None:
    """The widest logit gap of the sampled served masks."""
    import torch

    cfg = ctx.config
    w = weights.make_weights(cfg, ctx.seed, ctx.device)
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
    its masks go through the run's own check (``check``), as the
    program's served masks do."""
    import torch

    cfg, tr = ctx.config, ctx.traffic
    pool = image_pool(ctx.seed, tr["pool"], cfg["crop_size"], ctx.device)
    w = weights.make_weights(cfg, ctx.seed, ctx.device)
    rng = np.random.default_rng(ctx.seed ^ _SAMPLE_STREAM)
    n_offsets = len(pool) // tr["batch"]
    picks = rng.choice(n_offsets, size=min(tr["check_batches"], n_offsets),
                       replace=False)
    sample = []
    size = (cfg["crop_size"], cfg["crop_size"])
    for k in picks:
        off = int(k) * tr["batch"]
        images = torch.from_numpy(pool[off:off + tr["batch"]]).to(ctx.device)
        masks = ref.control_masks(w, images, cfg, size, fp8_e4m3,
                                  block=tr["reference_block"])
        sample.append((off, masks.cpu().numpy()))
    del w
    harness.free_cache(ctx.device)
    check(ctx, pool, sample)
    return {name: c["value"] for name, c in ctx.checks.items()}
