"""Dynamic-batching GPU inference worker.

Replaces the reference's job dispatch — a daemon thread HTTP-POSTing each
image to an external model server, one request per image, job left PENDING
forever on failure (reference backend/core/views.py:91-114) — with an
in-process worker loop:

  claim PENDING jobs atomically (store.claim_pending_jobs)
    → group by vision model → decode + resize on host
    → pad the batch to a fixed bucket size (a small fixed set of shapes
      per model)
    → forward + fused upsample/argmax on the GPU (models/vitseg.py
      vitseg_predict)
    → colorized mask PNG + connected-component detections
    → DONE (or FAILED with error_message — a transition the reference
      defines but never exercises, SURVEY.md §5)

Bucketing: batch sizes pad up to the next of BUCKETS, so each model sees
only len(BUCKETS) input shapes.
"""

from __future__ import annotations

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

import torch

from visiontransformer_tpu_torch.device import resolve_device
from visiontransformer_tpu_torch.models.registry import resolve_model
from visiontransformer_tpu_torch.models.vitseg import vitseg_predict
from visiontransformer_tpu_torch.native import available as native_available
from visiontransformer_tpu_torch.native import detections as native_detections
from visiontransformer_tpu_torch.serve.store import JobStore
from visiontransformer_tpu_torch.visualize import class_color_table, colorize

BUCKETS = (1, 2, 4, 8, 16, 32)


class ModelRunner:
    """One loaded model on one device: weights + a bucketed forward.

    The forward is ``vitseg_predict`` at ``out_size = input_size``, the
    same function as the TPU runner's ``argmax(vitseg_apply(...))``: on a
    CUDA device it runs the flash-attention and fused upsample+argmax
    kernels. ``device=None`` means CUDA and raises without it."""

    def __init__(self, model_row: Dict, *, compute_dtype: str = "bfloat16",
                 buckets: Sequence[int] = BUCKETS, device=None):
        self.device = resolve_device(device)
        self.buckets = tuple(sorted(buckets))
        self.input_size = model_row["input_size"]
        self.family = model_row.get("model_family") or "vitseg"
        if int(model_row.get("token_merge_r") or 0) or model_row.get(
                "quantize"):
            raise ValueError("token merging and int8 quantization are not "
                             "ported yet")
        self.cfg, self.model = resolve_model(
            self.family, model_row["config_name"],
            num_classes=model_row["num_classes"],
            input_size=self.input_size, compute_dtype=compute_dtype,
            checkpoint_path=model_row.get("checkpoint_path") or "",
            device=self.device)
        self.color_table = class_color_table(None, self.cfg.num_classes)
        # uint8 in / uint8 out: the /255 runs on the device (uint8 -> fp32
        # then /255, as the TPU runner does); masks fit uint8 whenever
        # num_classes <= 256 (PNG palettes cap there anyway).
        self.mask_dtype = (torch.uint8 if self.cfg.num_classes <= 256
                           else torch.int32)

    @torch.inference_mode()
    def dispatch(self, images: np.ndarray):
        """(B, H, W, 3) uint8 -> in-flight masks handle (padded to a
        bucket). Call resolve() on the handle to get (B, H, W) class ids."""
        if images.dtype != np.uint8:
            # The forward divides by 255 on the device; a caller passing
            # pre-normalized [0,1] floats would get a second /255 and
            # near-black inputs with no error.
            raise TypeError(
                f"ModelRunner.dispatch expects uint8 images (0..255, the "
                f"/255 normalization runs on-device), got {images.dtype}")
        b = images.shape[0]
        bucket = next((s for s in self.buckets if s >= b), self.buckets[-1])
        if b < bucket:
            pad = np.zeros((bucket - b,) + images.shape[1:], images.dtype)
            images = np.concatenate([images, pad])
        x = torch.from_numpy(np.array(images, copy=True)).to(self.device)
        x = x.float() / 255.0
        masks = vitseg_predict(self.model, x,
                               out_size=(self.input_size, self.input_size))
        return _PendingMasks(masks.to(self.mask_dtype), b)

    def predict(self, images: np.ndarray) -> np.ndarray:
        return self.dispatch(images).resolve()

    def warmup(self) -> None:
        """Run every batch bucket once up front (kernel build, library
        autotuning and allocator growth happen here, not on live jobs)."""
        for bucket in self.buckets:
            dummy = np.zeros((bucket, self.input_size, self.input_size, 3),
                             np.uint8)
            self.predict(dummy)


class _PendingMasks:
    """Handle for an in-flight forward. On CUDA the masks copy to pinned
    host memory without blocking and an event marks the copy's end;
    resolve() waits for that event only, so a later batch can already be
    running on the device."""

    def __init__(self, masks: torch.Tensor, n: int):
        self._n = n
        self._event = None
        if masks.is_cuda:
            self._host = torch.empty(masks.shape, dtype=masks.dtype,
                                     pin_memory=True)
            self._host.copy_(masks, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = masks

    def resolve(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()[:self._n]


class InferenceWorker:
    def __init__(self, store: JobStore, *, poll_interval: float = 0.02,
                 max_batch: int = BUCKETS[-1], linger: float = 0.005,
                 compute_dtype: str = "bfloat16", warmup: bool = True,
                 io_threads: int = 8, buckets: Sequence[int] = BUCKETS,
                 device=None):
        # None means CUDA; raises on a host without it (device.py).
        self.device = resolve_device(device)
        self.warmup = warmup
        # Fewer buckets = fewer shapes to warm (faster cold start) at the
        # price of more batch padding; the full ladder minimizes padding.
        self.buckets = tuple(sorted(buckets))
        self.store = store
        self.poll_interval = poll_interval
        # Never claim more jobs than the largest bucket holds: a claim
        # above it would dispatch an unpadded, un-warmed shape.
        self.max_batch = min(max_batch, self.buckets[-1])
        # Dynamic-batching linger: when fewer than max_batch jobs are
        # pending, wait this long for more to arrive before dispatching a
        # partial bucket — classic latency/throughput knob.
        self.linger = linger
        self.compute_dtype = compute_dtype
        self._runners: Dict[int, ModelRunner] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Image decode and mask postprocess (PNG encode, connected
        # components) run on this pool, overlapping device compute — PIL and
        # zlib release the GIL for the heavy parts. The worker loop thread
        # only claims jobs and dispatches batches.
        self._io_pool = ThreadPoolExecutor(max_workers=io_threads,
                                           thread_name_prefix="worker-io")
        self._processed_lock = threading.Lock()
        self.processed = 0

    # ----------------------------------------------------------- lifecycle
    def preload_models(self) -> None:
        """Load + warm every registered model now (every bucket run once)
        instead of lazily on the first claimed batch, where a cold model
        would stall live jobs. Load failures are left for the per-job path
        to report."""
        for row in self.store.list_models():
            try:
                self._runner(row["id"])
            except Exception:
                pass

    def start(self, preload: bool = True) -> None:
        # Crash recovery: jobs a dead worker left PROCESSING go back to the
        # queue (any age — at startup no other worker can own them).
        self.store.requeue_stale_processing(older_than_s=0.0)
        if preload and self.warmup:
            native_available()  # builds the detections library if needed
            self.preload_models()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gpu-inference-worker")
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout)
        self._io_pool.shutdown(wait=True)

    MAX_IN_FLIGHT = 2  # batches dispatched before blocking on a readback

    def _loop(self) -> None:
        # Pipelined loop: dispatch up to MAX_IN_FLIGHT batches to the device
        # before blocking on the oldest readback, so device compute overlaps
        # host postprocessing.
        from collections import deque

        in_flight = deque()   # (runner, valid_jobs, pending_masks)
        post_futures = deque()  # postprocess work handed to the io pool

        def reap_posts(block: bool = False):
            while post_futures and (block or post_futures[0].done()):
                post_futures.popleft().result()

        def drain_one():
            runner, valid_jobs, pending = in_flight.popleft()
            try:
                masks = pending.resolve()
            except Exception as exc:
                for job in valid_jobs:
                    self.store.fail_job(job["id"], f"inference error: {exc}")
                return
            for job, mask in zip(valid_jobs, masks):
                post_futures.append(self._io_pool.submit(
                    self._finish_job_safe, runner, job, mask))
            reap_posts()

        while not self._stop.is_set():
            jobs = self.store.claim_pending_jobs(self.max_batch)
            if not jobs:
                while in_flight:
                    drain_one()
                reap_posts(block=True)
                self._stop.wait(self.poll_interval)
                continue
            if len(jobs) < self.max_batch and self.linger > 0:
                self._stop.wait(self.linger)
                jobs += self.store.claim_pending_jobs(
                    self.max_batch - len(jobs))
            for model_id, group in _group_by_model(jobs):
                entry = self._dispatch_group(model_id, group)
                if entry is not None:
                    in_flight.append(entry)
                while len(in_flight) > self.MAX_IN_FLIGHT:
                    drain_one()
        while in_flight:
            drain_one()
        reap_posts(block=True)

    def _finish_job_safe(self, runner: "ModelRunner", job: Dict,
                         mask: np.ndarray) -> None:
        try:
            self._finish_job(runner, job, mask)
        except Exception as exc:
            self.store.fail_job(job["id"], f"postprocess error: {exc}")

    # ------------------------------------------------------------- compute
    def _runner(self, model_id: int) -> ModelRunner:
        if model_id not in self._runners:
            row = self.store.get_model(model_id)
            if row is None:
                raise KeyError(f"unknown vision model {model_id}")
            runner = ModelRunner(row, compute_dtype=self.compute_dtype,
                                 buckets=self.buckets, device=self.device)
            if self.warmup:
                runner.warmup()
            self._runners[model_id] = runner
        return self._runners[model_id]

    def _dispatch_group(self, model_id: int, jobs: List[Dict]):
        """Decode + dispatch one batch; returns an in-flight entry or None."""
        try:
            runner = self._runner(model_id)
        except Exception as exc:  # model load failure fails the whole group
            for job in jobs:
                self.store.fail_job(job["id"], f"model load error: {exc}")
            return None

        def decode(job):
            img = Image.open(job["input_image"])
            # JPEG uploads decode at the nearest DCT-domain scale >= the
            # target (libjpeg "draft" mode) before the bilinear resize; a
            # no-op for PNG and other formats. uint8 out: normalization
            # happens on the device (ModelRunner.dispatch).
            img.draft("RGB", (runner.input_size, runner.input_size))
            img = img.convert("RGB").resize(
                (runner.input_size, runner.input_size), Image.BILINEAR)
            return np.asarray(img, np.uint8)

        # Decode the whole batch concurrently on the io pool (PIL releases
        # the GIL while decoding/resizing); failures fail only their job.
        images, valid_jobs = [], []
        futures = [self._io_pool.submit(decode, job) for job in jobs]
        for job, fut in zip(jobs, futures):
            try:
                images.append(fut.result())
                valid_jobs.append(job)
            except Exception as exc:
                self.store.fail_job(job["id"], f"image decode error: {exc}")

        if not valid_jobs:
            return None
        try:
            pending = runner.dispatch(np.stack(images))
        except Exception as exc:
            for job in valid_jobs:
                self.store.fail_job(job["id"], f"inference error: {exc}")
            return None
        return runner, valid_jobs, pending

    def _finish_job(self, runner: ModelRunner, job: Dict,
                    mask: np.ndarray) -> None:
        mask_dir = os.path.join(self.store.media_root, "masks")
        os.makedirs(mask_dir, exist_ok=True)
        mask_path = os.path.join(mask_dir, f"{job['id']}.png")
        # Indexed-palette PNG: one byte per pixel with the class palette in
        # the PLTE chunk — renders identically to the RGB colorize but skips
        # the H×W×3 expansion. compress_level=1: flat-colored masks are
        # already tiny at level 1. RGB above 256 classes (PNG palettes cap
        # at 256 entries). Keyed off color_table (num_classes rows).
        if len(runner.color_table) <= 256:
            img = Image.fromarray(mask.astype(np.uint8), mode="P")
            img.putpalette(runner.color_table.astype(np.uint8).tobytes())
            img.save(mask_path, compress_level=1)
        else:
            Image.fromarray(colorize(mask, runner.color_table)).save(
                mask_path, compress_level=1)

        # One-pass all-class connected components (native C++;
        # per-class fallback inside) — the per-class loop re-scanned the
        # mask once per present class.
        detections = [
            {"class_id": cls, "box_yxyx": [y0, x0, y1, x1]}
            for cls, y0, x0, y1, x1 in native_detections(mask)
        ]
        self.store.complete_job(job["id"], mask_path, json.dumps(detections))
        with self._processed_lock:
            self.processed += 1


def _group_by_model(jobs: Sequence[Dict]) -> List[Tuple[int, List[Dict]]]:
    groups: Dict[int, List[Dict]] = {}
    for job in jobs:
        groups.setdefault(job["vision_model"], []).append(job)
    return list(groups.items())
