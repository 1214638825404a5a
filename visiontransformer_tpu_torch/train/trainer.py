"""Single-device trainer (the TPU package's ``train/trainer.py``).

One optimizer step: ``accumulate_grad_batches`` micro-batches, each with
its own dropout generator, gradients summed by autograd into ``.grad``,
scaled by 1/accum, then one Adam/AdamW step (the averaged-gradient
semantics of Lightning's accumulate_grad_batches, reference
createViTmodel.py:74). Evaluation runs under ``torch.no_grad``, so its
attention takes the inference kernel. ``fit`` mirrors the TPU package's:
shuffled ``batch_iterator`` with ``prefetch``, per-step and per-epoch CSV
logs with its column names, EarlyStopping and ReduceLROnPlateau on the
host between epochs, an ``epoch=N-step=M`` checkpoint after every epoch
(``ckpt/io.py``: the model's state dict, the optimizer's state dict, whose
param groups carry the plateau-lowered learning rate, and the step), and
resume from one with its Adam moments and step, so that the dropout seeds
and the epoch-seeded shuffle go on where they stopped. The schedules' own
state (the plateau's best value and bad-epoch count, EarlyStopping's) is
not saved: a resumed run trains at the restored learning rate until its
first monitored epoch, where a fresh ``PlateauScheduler`` sets
``learning_rate`` again, as the TPU package's does.

``model`` names the family (``models/registry.py``): vitseg, one of the
ten conv families or segformer, whose configs the trainer takes as the TPU
package's does. ``TrainConfig.remat`` turns on ``ViTConfig.remat`` (per-block
activation checkpointing, ``models/vit.py``) for vitseg and is ignored for
the other families, as the TPU package's trainer does. A
W8A8-quantized model (``ops/quant.py``) is refused: rounding has no
gradient, so it would learn nothing.

Inside a torch.distributed job (``parallel/launch.py``; ``train --mesh``
starts one), or with ``TrainConfig.mesh_shape`` or ``pipeline_stages``
set, the trainer lays the model out over the job's ranks
(``parallel/plan.py``): data parallelism with a DDP-style gradient
average, Megatron tensor parallelism, FSDP2, sequence parallelism and the
GPipe pipeline, with the TPU package's shape errors. Every rank builds the
same global batch and takes its rows; micro-batch i of data rank d draws
its dropout from ``fold_seed(fold_seed(seed, i), d)``; validation reduces
its counts over "data", so ``fit``'s metrics are the global batch's; only
rank 0 writes the CSV and tfevents logs and the profiler trace; every rank
takes part in a checkpoint, which rank 0 writes with the gathered full
state in the single-device format (stacked layers in pipeline mode) while
the others wait at a barrier; a resume reads the full state on every rank
and keeps each rank's part of it.

Beside the CSV log, each epoch's metrics go to a tfevents file in the
logger's directory at the same global step (``utils/tbevents.py``), as the
TPU package's trainer writes them. ``fit(profile_dir=)`` traces global
steps 2-5 of the first epoch with ``torch.profiler`` (CPU, and CUDA on
the card) into a Chrome trace ``*.pt.trace.json`` under ``profile_dir``,
each step a ``train_step_<n>`` range; where the epoch ends before step 6,
the trace stops and is written at the epoch's end (the TPU package's stays
open there). Only the last traced step waits for the card.
Metrics stay 0-dim device tensors until a log line or the epoch's mean
needs them, so a step does not wait for the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

from visiontransformer_tpu_torch.ckpt.convert import load_jax_params
from visiontransformer_tpu_torch.ckpt.io import (
    check_optimizer,
    get_latest_checkpoint,
    parse_epoch,
    restore_checkpoint,
    save_checkpoint,
)
from visiontransformer_tpu_torch.configs import TrainConfig
from visiontransformer_tpu_torch.data.pipeline import batch_iterator, prefetch
from visiontransformer_tpu_torch.device import resolve_device
from visiontransformer_tpu_torch.models.registry import get_model_family
from visiontransformer_tpu_torch.ops.quant import is_quantized
from visiontransformer_tpu_torch.parallel import launch
from visiontransformer_tpu_torch.parallel.plan import Plan, wants_plan
from visiontransformer_tpu_torch.train.optim import (
    EarlyStopping,
    PlateauScheduler,
    build_optimizer,
    set_learning_rate,
)
from visiontransformer_tpu_torch.train.state import TrainState
from visiontransformer_tpu_torch.train.tasks import get_task
from visiontransformer_tpu_torch.utils.csvlog import CSVLogger
from visiontransformer_tpu_torch.utils.tbevents import EventFileWriter

_MASK63 = (1 << 63) - 1


def fold_seed(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data), as jax.random.fold_in derives a
    key: the trainer's per-step and per-micro-batch dropout seeds."""
    x = (seed * 0x9E3779B97F4A7C15 + data + 1) & _MASK63
    x = ((x ^ (x >> 31)) * 0xBF58476D1CE4E5B9) & _MASK63
    return x ^ (x >> 29)


class Trainer:
    def __init__(self, seg_cfg, train_cfg: TrainConfig,
                 task: str = "ce", *, model: str = "vitseg",
                 device: Optional[Union[str, torch.device]] = None,
                 logger: Optional[CSVLogger] = None,
                 attn_impl: str = "auto", mesh=None):
        """seg_cfg: the config of ``model``'s family (ViTSegConfig for
        vitseg, e.g. UNetConfig for unet). device: None means CUDA (raises
        without it); inside a job, the rank's own device
        (``parallel/launch.py:device``). attn_impl: the
        attention implementation of every step ("auto" = the kernels on
        CUDA; the conv families have none). mesh: a ``DeviceMesh`` to train
        over (``parallel/multihost.py:pod_mesh``); by default the job's
        ranks in ``TrainConfig.mesh_shape``."""
        if model == "sam":
            raise ValueError("the sam family is served, not trained, by "
                             "the port (models/sam.py)")
        planned = wants_plan(train_cfg, mesh)
        self.device = (launch.device(device) if planned
                       else resolve_device(device))
        if train_cfg.batch_size % train_cfg.accumulate_grad_batches != 0:
            raise ValueError(
                f"batch_size={train_cfg.batch_size} must be divisible by "
                f"accumulate_grad_batches={train_cfg.accumulate_grad_batches} "
                f"(the step splits it into that many micro-batches)")
        self.model_family = get_model_family(model)
        self.plan = (Plan(seg_cfg, train_cfg, model, mesh,
                          device_type=self.device.type) if planned else None)
        if (train_cfg.remat and model == "vitseg"
                and hasattr(seg_cfg, "vit") and not seg_cfg.vit.remat):
            seg_cfg = dataclasses.replace(
                seg_cfg, vit=dataclasses.replace(seg_cfg.vit, remat=True))
        self.seg_cfg = seg_cfg
        self.train_cfg = train_cfg
        self.task_name = task
        self.task_fn = get_task(task)
        # Only the primary rank writes logs.
        self.logger = logger if launch.is_primary() else None
        self.attn_impl = attn_impl
        self._checked_model = None  # the model train_step last accepted
        self._tb_writer = None

    # ------------------------------------------------------------------ init
    def init_state(self, params=None) -> TrainState:
        """Random weights from the family's init with a generator seeded
        with ``TrainConfig.seed``, or ``params``, a TPU-package param tree
        with numpy leaves, through the weight bridge."""
        model = self.model_family.init(
            torch.Generator().manual_seed(self.train_cfg.seed), self.seg_cfg)
        if params is not None:
            load_jax_params(model, params)
        model.to(self.device).train()
        foreach = None
        if self.plan is not None:
            self.plan.build(model)
            foreach = self.plan.foreach(model)
        return TrainState(model=model, optimizer=build_optimizer(
            self.train_cfg, model.parameters(), foreach=foreach))

    # ----------------------------------------------------------------- steps
    def _place(self, batch) -> Dict[str, torch.Tensor]:
        """The batch on the trainer's device; host arrays go to the card
        through pinned memory without waiting for it."""
        if self.device.type != "cuda":
            return {k: torch.as_tensor(v).to(self.device)
                    for k, v in batch.items()}
        return {k: v.to(self.device) if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                .to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def train_step(self, state: TrainState, batch, seed: int):
        """One optimizer step over ``accumulate_grad_batches`` micro-batches;
        micro-batch i draws its dropout from a generator seeded with
        ``fold_seed(seed, i)``. Returns (state, mean metrics), the state
        updated in place."""
        if state.model is not self._checked_model:
            # Once per model, as the TPU trainer checks once before its
            # first compile.
            if is_quantized(state.model):
                raise ValueError(
                    "the model holds W8A8-quantized layers (kernel_q); "
                    "quantization is inference-only (round/clip has zero "
                    "gradient). Train the fp32 model and quantize it when "
                    "serving (ops/quant.py).")
            self._checked_model = state.model
        accum = self.train_cfg.accumulate_grad_batches
        total = len(batch["image"])
        if total % accum:
            raise ValueError(
                f"batch size {total} is not divisible by "
                f"accumulate_grad_batches={accum}; the trailing "
                f"{total % accum} samples would be silently dropped")
        micro = total // accum
        plan = self.plan
        state.optimizer.zero_grad(set_to_none=True)
        metric_list = []
        for i in range(accum):
            part = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
            micro_seed = fold_seed(seed, i)
            if plan is not None:
                part = plan.local_rows(part)
                if plan.dp > 1:
                    micro_seed = fold_seed(micro_seed, plan.data_rank)
            generator = torch.Generator(device=self.device).manual_seed(
                micro_seed)
            loss, metrics = self.task_fn(
                state.model, self._place(part), self.seg_cfg,
                generator=generator, deterministic=False,
                attn_impl=self.attn_impl, **self._reduce_kwargs())
            loss.backward()
            metric_list.append({k: v.detach() for k, v in metrics.items()})
        if plan is not None:
            plan.sync_grads(state.model)
        if accum > 1:
            grads = [p.grad for p in state.model.parameters()
                     if p.grad is not None]
            # FSDP's sharded gradients and plain ones in separate calls.
            for kind in {type(g) for g in grads}:
                torch._foreach_mul_([g for g in grads if type(g) is kind],
                                    1.0 / accum)
        state.optimizer.step()
        state.step += 1
        metrics = {k: torch.stack([m[k] for m in metric_list]).mean()
                   for k in metric_list[0]}
        return state, (metrics if plan is None
                       else plan.mean_metrics(metrics))

    def _reduce_kwargs(self) -> dict:
        """The tasks' batch-global sums reduce over "data" under a
        mesh."""
        group = None if self.plan is None else self.plan.reduce_group
        return {} if group is None else {"data_group": group}

    def eval_step(self, model: torch.nn.Module,
                  batch) -> Dict[str, torch.Tensor]:
        if self.plan is not None:
            batch = self.plan.local_rows(batch)
        with torch.no_grad():
            _, metrics = self.task_fn(model, self._place(batch), self.seg_cfg,
                                      deterministic=True,
                                      attn_impl=self.attn_impl,
                                      **self._reduce_kwargs())
        return metrics if self.plan is None else self.plan.mean_metrics(
            metrics)

    # ------------------------------------------------------------------- fit
    def fit(self, train_dataset, val_dataset=None, *,
            state: Optional[TrainState] = None,
            max_epochs: Optional[int] = None,
            checkpoint_dir: Optional[str] = None,
            resume_from: Optional[str] = None,
            profile_dir: Optional[str] = None,
            on_epoch_end: Optional[Callable[[int, Dict[str, float]], None]] = None
            ) -> TrainState:
        """Train for ``max_epochs`` (default ``TrainConfig.max_epochs``) or
        until EarlyStopping stops it. checkpoint_dir (default
        ``TrainConfig.checkpoint_dir``): save after every epoch.
        resume_from: a checkpoint, or a directory of them (the latest is
        taken); training goes on from the epoch after the checkpoint's, the
        replacement for Lightning's fit(ckpt_path=...) (reference
        model/CE/trainCurrentViTmodel.py:67-73). profile_dir: a
        torch.profiler trace of the first epoch's global steps 2-5."""
        cfg = self.train_cfg
        max_epochs = max_epochs if max_epochs is not None else cfg.max_epochs
        checkpoint_dir = checkpoint_dir or cfg.checkpoint_dir
        if state is None:
            state = self.init_state()
        start_epoch = 0
        if resume_from:
            path = get_latest_checkpoint(resume_from) or resume_from
            if self.plan is not None:
                state.step = self._resume_parallel(state, path)
            else:
                # Params-only checkpoints keep the fresh Adam moments
                # (partial restore); the optimizer's state lands on the
                # parameters' device.
                restored = restore_checkpoint(
                    path, {"params": state.model.state_dict(),
                           "opt_state": state.optimizer, "step": state.step})
                state.step = int(restored["step"])
            ckpt_epoch = parse_epoch(path)
            start_epoch = ckpt_epoch + 1 if ckpt_epoch is not None else 0

        stopper = None
        if cfg.early_stopping_monitor:
            stopper = EarlyStopping(cfg.early_stopping_patience,
                                    cfg.early_stopping_mode)
        plateau = None
        if cfg.plateau_patience:
            plateau = PlateauScheduler(cfg.learning_rate,
                                       mode=cfg.plateau_mode,
                                       factor=cfg.plateau_factor,
                                       patience=cfg.plateau_patience)

        profiler = None
        for epoch in range(start_epoch, max_epochs):
            # ---- train ----
            t0 = time.time()
            train_metrics = []
            for batch in prefetch(batch_iterator(
                    train_dataset, cfg.batch_size, shuffle=True,
                    seed=cfg.seed, epoch=epoch)):
                if (profile_dir and epoch == start_epoch and state.step == 2
                        and launch.is_primary()):
                    profiler = self._start_trace(profile_dir)
                with (torch.profiler.record_function(
                        f"train_step_{state.step}") if profiler
                      else contextlib.nullcontext()):
                    state, metrics = self.train_step(
                        state, batch, fold_seed(cfg.seed, state.step))
                train_metrics.append(metrics)
                if profiler and state.step == 6:
                    self._stop_trace(profiler)
                    profiler = None
                if self.logger and state.step % cfg.log_every_n_steps == 0:
                    self.logger.log(
                        {f"train_{k}_step": float(v) for k, v in metrics.items()},
                        epoch=epoch, step=state.step)

            if profiler:  # the epoch ended before step 6
                self._stop_trace(profiler)
                profiler = None
            epoch_metrics = _mean_metrics(train_metrics, prefix="train_")
            epoch_metrics["epoch_time_s"] = time.time() - t0

            # ---- validate ----
            if val_dataset is not None:
                val_metrics = [self.eval_step(state.model, batch)
                               for batch in batch_iterator(val_dataset,
                                                           cfg.batch_size)]
                # val_ for the binary PAED task, whose monitors
                # (PAED_TRAIN_DEFAULTS: val_IoU, val_loss) read it, as the
                # TPU package's trainer names them.
                prefix = ("val_" if self.task_name == "paed_binary"
                          else "valid_")
                epoch_metrics.update(_mean_metrics(val_metrics,
                                                   prefix=prefix))

            if self.logger:
                self.logger.log(epoch_metrics, epoch=epoch, step=state.step)
                # tfevents sibling of the CSV log, like the reference's
                # Lightning runs (tfevents next to metrics.csv).
                if self._tb_writer is None:
                    self._tb_writer = EventFileWriter(self.logger.log_dir)
                for key, value in epoch_metrics.items():
                    self._tb_writer.add_scalar(key, value, state.step)
                self._tb_writer.flush()
            if on_epoch_end:
                on_epoch_end(epoch, epoch_metrics)
            if checkpoint_dir:
                self.save(state, checkpoint_dir, epoch=epoch)

            # ---- schedules (host-side) ----
            if plateau is not None:
                monitored = epoch_metrics.get(cfg.plateau_monitor)
                if monitored is not None:
                    set_learning_rate(state.optimizer, plateau.step(monitored))
            if stopper is not None:
                monitored = epoch_metrics.get(cfg.early_stopping_monitor)
                if monitored is not None and stopper.step(monitored):
                    break
        return state

    def save(self, state: TrainState, checkpoint_dir: str, *,
             epoch: int) -> Optional[str]:
        """Write ``epoch=N-step=M`` with the model, optimizer and step;
        under a mesh every rank takes part, rank 0 writes the gathered full
        state and returns its path (None elsewhere), the others wait."""
        if self.plan is None:
            return save_checkpoint(
                checkpoint_dir, {"params": state.model.state_dict(),
                                 "opt_state": state.optimizer.state_dict(),
                                 "step": state.step},
                epoch=epoch, step=state.step)
        full = self.plan.gather_state(state.model, state.optimizer)
        path = None
        if full is not None:
            path = save_checkpoint(
                checkpoint_dir, {"params": full[0], "opt_state": full[1],
                                 "step": state.step},
                epoch=epoch, step=state.step)
        launch.barrier()
        return path

    def _resume_parallel(self, state: TrainState, path: str) -> int:
        """Every rank reads the full checkpoint and keeps its parts: the
        params (which must fit, in either layer form) and, where it fits
        the optimizer, the optimizer state."""
        from visiontransformer_tpu_torch.ckpt.io import _check_params
        from visiontransformer_tpu_torch.parallel.state import (
            match_layer_form,
        )

        disk = restore_checkpoint(path)
        params, opt = match_layer_form(disk["params"], disk.get("opt_state"),
                                       stacked=False)
        plan = self.plan
        _check_params(params, {n: torch.empty(s, device="meta")
                               for n, s in plan.full_shapes.items()}, path)
        if opt is not None:
            try:
                check_optimizer(opt, state.optimizer, shapes=[
                    plan.full_shapes[n] for n in plan.full_names])
            except ValueError as e:
                warnings.warn(f"the optimizer state at {path} does not "
                              f"match the target optimizer; keeping the "
                              f"freshly-initialized state ({e})")
                opt = None
        plan.load_state(state.model, state.optimizer, params, opt)
        return int(disk.get("step", state.step))

    def _start_trace(self, profile_dir: str):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                profile_dir))
        profiler.start()
        return profiler

    def _stop_trace(self, profiler) -> None:
        """Wait for the traced steps' kernels, then write the trace."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()

    def evaluate(self, dataset, model: torch.nn.Module, *,
                 batch_size: Optional[int] = None) -> Dict[str, float]:
        batch_size = batch_size or self.train_cfg.batch_size
        return _mean_metrics([self.eval_step(model, b)
                              for b in batch_iterator(dataset, batch_size)],
                             prefix="")


def _mean_metrics(metric_dicts: Iterable[Dict], prefix: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    metric_dicts = list(metric_dicts)
    if not metric_dicts:
        return out
    for key in metric_dicts[0]:
        out[prefix + key] = float(np.mean([float(m[key]) for m in metric_dicts]))
    return out
