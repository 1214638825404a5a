"""Dynamic-batching GPU inference worker.

Replaces the reference's job dispatch — a daemon thread HTTP-POSTing each
image to an external model server, one request per image, job left PENDING
forever on failure (reference backend/core/views.py:91-114) — with an
in-process worker loop:

  claim PENDING jobs atomically (store.claim_pending_jobs)
    → group by vision model → decode + resize on host
    → pad the batch to a fixed bucket size (a small fixed set of shapes
      per model)
    → the family's masks forward on the GPU (models/registry.py
      serving_forward)
    → colorized mask PNG + connected-component detections
    → DONE (or FAILED with error_message — a transition the reference
      defines but never exercises, SURVEY.md §5)

Bucketing: batch sizes pad up to the next of BUCKETS, so each model sees
only len(BUCKETS) input shapes.

Serving mesh: ``ModelRunner(mesh_shape=(dp,))`` splits each bucket's rows
over dp model replicas in this one process, one per device, each on its
own CUDA stream, and gathers their uint8 masks (the TPU runner shards the
batch over a dp mesh in one process too). Every bucket must divide by dp.

CUDA graphs: on a CUDA device a forward cut at its kernel calls (vitseg's
``models/vitseg.py:MasksForward``) is captured once a bucket and replica
(``_GraphedForward``) and replayed at every dispatch; kernels 1 and 5
launch eagerly between the replays.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

import torch

from visiontransformer_tpu_torch.device import resolve_device
from visiontransformer_tpu_torch.evaluation.visualize import (
    class_color_table,
    colorize,
)
from visiontransformer_tpu_torch.models.registry import (
    quantize_int8_,
    resolve_model,
    serving_forward,
)
from visiontransformer_tpu_torch.models.vitseg import set_token_merge_r
from visiontransformer_tpu_torch.native import available as native_available
from visiontransformer_tpu_torch.native import detections as native_detections
from visiontransformer_tpu_torch.serve.store import JobStore
from visiontransformer_tpu_torch.utils import spans

BUCKETS = (1, 2, 4, 8, 16, 32)


class ModelRunner:
    """One loaded model on one device: weights + a bucketed forward.

    The forward is the TPU runner's ``argmax(apply(images / 255))`` cast
    to the mask type (``models/registry.py:serving_forward``). For vitseg
    it is ``vitseg_predict``'s at ``out_size = input_size``: on a CUDA
    device it runs the flash-attention and fused upsample+argmax kernels.
    For a conv family it is the family's apply and ``torch.argmax`` (no
    kernel of the port's on that path, as no Pallas kernel is on the TPU
    runner's). Segformer is served the same
    way, eagerly, from the registry's presets or from an HF
    ``save_pretrained`` directory (``checkpoint_path``, read by
    ``ckpt/hf_dir.py``); on a CUDA device a MiT encoder's attention runs
    kernel 1 with a key count of its own, one launch a block
    (``models/mit.py``). SAM (``models/sam.py``) is served eagerly too, with
    one box prompt an image: ``dispatch(images, boxes=)``, the whole image
    where no boxes are given, masks {0, 1}. The row's opt-ins apply at
    load, as in the TPU runner:
    ``token_merge_r`` (ToMe merging, vitseg only) and ``quantize ==
    "int8"`` (W8A8: vitseg's encoder linears, the tree quantizer's linears
    and interior convs for every other family). ``device=None`` means
    CUDA and raises without it.

    mesh_shape=(dp,) (or (dp, 1)) serves over dp replicas on ``devices``
    (default cuda:0 ... cuda:dp-1, which the host must have; an explicit
    list may name a device twice, as the single-card check does): each
    bucket's rows split into dp contiguous parts, one a replica, and the
    masks gathered in row order. A 1-device mesh is plain placement.

    On a CUDA device a forward cut at its kernel calls (vitseg's) is served
    through CUDA graphs (``_GraphedForward``), one set a bucket and
    replica, captured at the bucket's first dispatch (``warmup``
    dispatches every bucket) after an eager pass of it, on one capture
    stream a replica and into one memory pool a replica; the masks are
    its eager forward's bit for bit. The CPU and the other families run
    the forward eagerly."""

    def __init__(self, model_row: Dict, *, compute_dtype: str = "bfloat16",
                 buckets: Sequence[int] = BUCKETS, device=None,
                 mesh_shape: Optional[Sequence[int]] = None,
                 devices: Optional[Sequence] = None):
        devices = _mesh_devices(mesh_shape, devices, device)
        if devices is not None:
            device = devices[0]
            dp = len(devices)
            if any(b % dp for b in buckets):
                raise ValueError(
                    f"every bucket size {tuple(sorted(buckets))} must be "
                    f"divisible by the data-parallel axis ({dp})")
        self.device = resolve_device(device)
        self.buckets = tuple(sorted(buckets))
        self.input_size = model_row["input_size"]
        self.cfg, self.model = resolve_model(
            model_row.get("model_family") or "vitseg",
            model_row["config_name"],
            num_classes=model_row["num_classes"],
            input_size=self.input_size, compute_dtype=compute_dtype,
            checkpoint_path=model_row.get("checkpoint_path") or "",
            device=self.device)
        merge_r = int(model_row.get("token_merge_r") or 0)
        if merge_r:
            # The row's ToMe opt-in (vitseg only; the store validates): the
            # same weights, tokens merged after every block.
            self.cfg = set_token_merge_r(self.model, merge_r)
        if model_row.get("quantize") == "int8":
            # The row's W8A8 opt-in, quantized once, here, in place.
            quantize_int8_(self.model)
        self.color_table = class_color_table(None, self.cfg.num_classes)
        # uint8 in / uint8 out: the /255 runs on the device (uint8 -> fp32
        # then /255, as the TPU runner does); masks fit uint8 whenever
        # num_classes <= 256 (PNG palettes cap there anyway), and the
        # epilogue kernel writes them in that type.
        self.mask_dtype = (torch.uint8 if self.cfg.num_classes <= 256
                           else torch.int32)
        # (device, masks forward, stream) of each replica: one without a mesh.
        forward = serving_forward(
            self.model, out_size=(self.input_size, self.input_size),
            mask_dtype=self.mask_dtype)
        self.replicas = [(self.device, forward, None)]
        # Whether the forward takes a box prompt an image (sam's).
        self.prompted = getattr(forward, "prompted", False)
        if devices is not None:
            self.replicas = [
                (d, forward if i == 0 else copy.deepcopy(forward).to(d),
                 torch.cuda.Stream(d) if d.type == "cuda" else None)
                for i, d in enumerate(resolve_device(d) for d in devices)]
        # CUDA graphs of the forward: chosen by what the runner observes,
        # the device type and the forward's cut.
        self.graphed = self.device.type == "cuda" and forward.cut
        self._graphs: Dict[Tuple[int, int], _GraphedForward] = {}
        # A capture stream and a graph memory pool a replica, by its forward.
        self._capture = {id(f): (torch.cuda.Stream(d),
                                 torch.cuda.graph_pool_handle())
                         for d, f, _ in self.replicas} if self.graphed else {}

    def _forward(self, forward, images: np.ndarray, device,
                 boxes: Optional[np.ndarray] = None) -> torch.Tensor:
        if self.graphed:
            return self._graphed(forward, images.shape, device)(images)
        with spans.span("serve.input"):
            x = torch.from_numpy(np.array(images, copy=True)).to(device)
            x = x.float() / 255.0
            if boxes is not None:
                boxes = torch.from_numpy(np.array(
                    boxes, dtype=np.float32)).to(device)
        with spans.span("serve.forward"):
            return forward(x) if boxes is None else forward(x, boxes)

    def _graphed(self, forward, shape, device) -> "_GraphedForward":
        """The graphs of a replica's ``forward`` at this input shape,
        captured on first use."""
        key = (id(forward), shape[0])
        if key not in self._graphs:
            self._graphs[key] = _GraphedForward(
                forward, shape, device, *self._capture[id(forward)])
            spans.count("serve.graph_captures")
        return self._graphs[key]

    def dispatch(self, images: np.ndarray, batch: Optional[int] = None,
                 boxes: Optional[np.ndarray] = None):
        """(B, H, W, 3) uint8 -> in-flight masks handle (padded to a
        bucket). Call resolve() on the handle to get (B, H, W) class ids.
        ``batch`` is the id the batch's spans carry (``utils/spans.py``),
        a fresh one if None. ``boxes``: (B, 4) box prompts (x0, y0, x1, y1)
        in the images' pixels, one an image, for a prompted family (sam;
        None: the whole image; padded rows take the whole image too); any
        other family refuses them."""
        if batch is None:
            batch = spans.next_batch()
        with spans.span("serve.dispatch", batch), torch.inference_mode():
            if images.dtype != np.uint8:
                # The forward divides by 255 on the device; a caller
                # passing pre-normalized [0,1] floats would get a second
                # /255 and near-black inputs with no error.
                raise TypeError(
                    f"ModelRunner.dispatch expects uint8 images (0..255, "
                    f"the /255 normalization runs on-device), got "
                    f"{images.dtype}")
            b = images.shape[0]
            if boxes is not None and not self.prompted:
                raise ValueError("ModelRunner.dispatch: boxes are a prompt "
                                 "of the sam family; this model takes none")
            if self.prompted:
                boxes = _prompt_boxes(boxes, b, images.shape[1:3])
            bucket = next((s for s in self.buckets if s >= b),
                          self.buckets[-1])
            if b < bucket:
                pad = np.zeros((bucket - b,) + images.shape[1:],
                               images.dtype)
                images = np.concatenate([images, pad])
                if boxes is not None:
                    boxes = np.concatenate([boxes, _prompt_boxes(
                        None, bucket - b, images.shape[1:3])])
            spans.count("serve.batches")
            spans.count("serve.rows", b)
            spans.count("serve.padded_rows", len(images) - b)
            if self.graphed:
                spans.count("serve.graphed_batches")
            parts = []
            per = len(images) // len(self.replicas)
            for i, (dev, forward, stream) in enumerate(self.replicas):
                rows = images[i * per:(i + 1) * per]
                prompts = (None if boxes is None
                           else boxes[i * per:(i + 1) * per])
                with (torch.cuda.stream(stream) if stream is not None
                      else contextlib.nullcontext()):
                    # Without a prompt, the call an unprompted forward has
                    # always had (the benchmark's planted faults wrap it).
                    parts.append(_to_host(
                        self._forward(forward, rows, dev) if prompts is None
                        else self._forward(forward, rows, dev,
                                           boxes=prompts)))
            return _PendingMasks(parts, b, batch)

    def predict(self, images: np.ndarray) -> np.ndarray:
        return self.dispatch(images).resolve()

    def warmup(self) -> None:
        """Run every batch bucket once up front (kernel build, library
        autotuning, allocator growth and the capture of the bucket's CUDA
        graphs happen here, not on live jobs)."""
        for bucket in self.buckets:
            dummy = np.zeros((bucket, self.input_size, self.input_size, 3),
                             np.uint8)
            self.predict(dummy)


class _GraphedForward:
    """One replica's masks forward at one input shape as CUDA graphs, one
    a segment of its ``MasksForward``.

    Capture: on the replica's capture stream, after the device is idle and
    one eager pass of the segments has settled the libraries' choices and
    the allocator there, each segment into the replica's memory pool.
    Segment i reads segment i-1's output tensors and the attention buffer;
    the first reads the static uint8 input. The pool may be shared by the
    replica's shapes: their replays run on one stream, one forward after
    another.

    Call: the images' ``np.array`` copy, the pageable copy into the static
    input (``serve.input``), then on the current stream each segment's
    replay, with kernel 1 launched eagerly between two replays into the
    attention buffer, and kernel 5 after the last (``serve.forward``).
    Kernels 1 and 5 stay outside the graphs, so that each launch keeps its
    call site: the ``vit.attention`` and ``vitseg.epilogue`` ranges, the
    launch counters, and any wrapper of the modules' names."""

    def __init__(self, segments, shape, device, stream: torch.cuda.Stream,
                 pool):
        self.segments = segments
        self.images = torch.zeros(shape, dtype=torch.uint8, device=device)
        self.graphs: List[torch.cuda.CUDAGraph] = []
        # (segment i's outputs, the attention buffer it feeds), i < last.
        self.steps = []
        replay = torch.cuda.current_stream(device)
        torch.cuda.synchronize(device)
        with torch.cuda.stream(stream):
            segments(self.images)
            inputs, flat = (self.images,), None
            for i in range(segments.count):
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    outputs = segments.segment(i, inputs)
                finally:
                    graph.capture_end()
                self.graphs.append(graph)
                if i + 1 < segments.count:
                    q = outputs[1][0]
                    if flat is None:
                        # Block 0's shape is the largest (merging only
                        # drops tokens): one buffer serves every block.
                        # It belongs to the stream that replays.
                        with torch.cuda.stream(replay):
                            flat = torch.empty(q.numel(), dtype=q.dtype,
                                               device=device)
                    attn = flat[:q.numel()].view(q.shape)
                    self.steps.append((outputs, attn))
                    inputs = outputs + (attn,)
            self.outputs = outputs
        torch.cuda.synchronize(device)

    def __call__(self, images: np.ndarray) -> torch.Tensor:
        with spans.span("serve.input"):
            self.images.copy_(torch.from_numpy(np.array(images, copy=True)))
        with spans.span("serve.forward"):
            for graph, (outputs, attn) in zip(self.graphs, self.steps):
                graph.replay()
                self.segments.attention(outputs, out=attn)
            self.graphs[-1].replay()
            return self.segments.epilogue(self.outputs)


def _prompt_boxes(boxes: Optional[np.ndarray], n: int,
                  size: Tuple[int, int]) -> np.ndarray:
    """(n, 4) float32 boxes: the given ones, checked, or the whole image
    (0, 0, W, H) for each of n rows."""
    if boxes is None:
        return np.tile(np.array([[0.0, 0.0, size[1], size[0]]], np.float32),
                       (n, 1))
    boxes = np.asarray(boxes, dtype=np.float32)
    if boxes.shape != (n, 4):
        raise ValueError(f"ModelRunner.dispatch: boxes must be ({n}, 4) "
                         f"(x0, y0, x1, y1), one an image; got "
                         f"{boxes.shape}")
    return boxes


def _mesh_devices(mesh_shape, devices, device) -> Optional[list]:
    """The replicas' devices of a serving mesh, or None without one."""
    if not mesh_shape:
        return None
    shape = tuple(mesh_shape)
    if len(shape) > 2 or (len(shape) == 2 and shape[1] != 1):
        raise ValueError(f"a serving mesh is (dp,) or (dp, 1); got {shape}")
    dp = shape[0]
    if devices is None:
        if dp == 1:
            return None
        kind = torch.device("cuda" if device is None else device).type
        if kind == "cuda" and dp > torch.cuda.device_count():
            raise ValueError(f"mesh shape {shape} != "
                             f"{torch.cuda.device_count()} devices")
        devices = ([torch.device("cpu")] * dp if kind == "cpu"
                   else [torch.device("cuda", i) for i in range(dp)])
    if len(devices) != dp:
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    return None if dp == 1 else [torch.device(d) for d in devices]


def _to_host(masks: torch.Tensor):
    """(host tensor, event or None): on CUDA the masks copy to pinned host
    memory without blocking, on the current stream, and an event marks the
    copy's end."""
    with spans.span("serve.output"):
        if not masks.is_cuda:
            return masks, None
        host = torch.empty(masks.shape, dtype=masks.dtype, pin_memory=True)
        host.copy_(masks, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event


class _PendingMasks:
    """Handle for an in-flight forward: one (host masks, event) pair a
    replica (``_to_host``). resolve() waits for those events only, so a
    later batch can already be running on the device."""

    def __init__(self, parts, n: int, batch: int):
        self._n = n
        self._parts = parts
        self.batch = batch

    def resolve(self) -> np.ndarray:
        with spans.span("serve.resolve", self.batch):
            for _, event in self._parts:
                if event is not None:
                    event.synchronize()
            hosts = [host for host, _ in self._parts]
            host = hosts[0] if len(hosts) == 1 else torch.cat(hosts)
            return host.numpy()[:self._n]


class InferenceWorker:
    def __init__(self, store: JobStore, *, poll_interval: float = 0.02,
                 max_batch: int = BUCKETS[-1], linger: float = 0.005,
                 compute_dtype: str = "bfloat16", warmup: bool = True,
                 io_threads: int = 8, buckets: Sequence[int] = BUCKETS,
                 device=None, mesh_shape: Optional[Sequence[int]] = None,
                 devices: Optional[Sequence] = None):
        # None means CUDA; raises on a host without it (device.py).
        self.device = resolve_device(device)
        # The serving mesh of every runner (ModelRunner's mesh_shape).
        self.mesh_shape, self.devices = mesh_shape, devices
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
                    self._finish_job_safe, runner, job, mask, pending.batch))
            reap_posts()

        while not self._stop.is_set():
            # The claim's batch id goes to the first batch it forms; a
            # claim of several models' jobs forms one batch a model.
            batch = spans.next_batch()
            with spans.span("worker.claim", batch):
                jobs = self.store.claim_pending_jobs(self.max_batch)
            if not jobs:
                while in_flight:
                    drain_one()
                reap_posts(block=True)
                self._stop.wait(self.poll_interval)
                continue
            if len(jobs) < self.max_batch and self.linger > 0:
                with spans.span("worker.linger", batch):
                    self._stop.wait(self.linger)
                    jobs += self.store.claim_pending_jobs(
                        self.max_batch - len(jobs))
            for i, (model_id, group) in enumerate(_group_by_model(jobs)):
                entry = self._dispatch_group(
                    model_id, group, batch if i == 0 else spans.next_batch())
                if entry is not None:
                    in_flight.append(entry)
                while len(in_flight) > self.MAX_IN_FLIGHT:
                    drain_one()
        while in_flight:
            drain_one()
        reap_posts(block=True)

    def _finish_job_safe(self, runner: "ModelRunner", job: Dict,
                         mask: np.ndarray, batch: int) -> None:
        try:
            with spans.span("worker.postprocess", batch):
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
                                 buckets=self.buckets, device=self.device,
                                 mesh_shape=self.mesh_shape,
                                 devices=self.devices)
            if self.warmup:
                runner.warmup()
            self._runners[model_id] = runner
        return self._runners[model_id]

    def _dispatch_group(self, model_id: int, jobs: List[Dict], batch: int):
        """Decode + dispatch one batch; returns an in-flight entry or None."""
        try:
            runner = self._runner(model_id)
        except Exception as exc:  # model load failure fails the whole group
            for job in jobs:
                self.store.fail_job(job["id"], f"model load error: {exc}")
            return None

        def decode(job):
            with spans.span("worker.decode", batch):
                img = Image.open(job["input_image"])
                # JPEG uploads decode at the nearest DCT-domain scale >=
                # the target (libjpeg "draft" mode) before the bilinear
                # resize; a no-op for PNG and other formats. uint8 out:
                # normalization happens on the device
                # (ModelRunner.dispatch).
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
            pending = runner.dispatch(np.stack(images), batch)
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
        spans.count("serve.jobs_done")


def _group_by_model(jobs: Sequence[Dict]) -> List[Tuple[int, List[Dict]]]:
    groups: Dict[int, List[Dict]] = {}
    for job in jobs:
        groups.setdefault(job["vision_model"], []).append(job)
    return list(groups.items())
