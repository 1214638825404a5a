"""How a trainer's model is laid out over the job's ranks, and the work
that layout adds to a step (the mesh branches of the TPU package's
``train/trainer.py``).

A ``Plan`` is built from the ``TrainConfig`` (``mesh_shape``, ``fsdp``,
``fsdp_min_size``, ``seq_parallel``, ``pipeline_stages``,
``pipeline_microbatches``) inside a torch.distributed job
(``parallel/launch.py``), with the TPU package's shape errors. It

- splits the model (``build``): the pipeline keeps this stage's encoder
  layers, tensor parallelism splits the blocks over "model"
  (``parallel/tensor.py``), FSDP2 shards over "data"
  (``parallel/mesh.py:shard_fsdp``); the weights come from the same
  seeded init on every rank, so every replica starts equal;
- gives each rank its rows (``local_rows``): every rank builds the same
  global batch and takes its contiguous 1/dp of each micro-batch, the
  counterpart of ``multihost.local_shard``;
- reduces the gradients after the backward (``sync_grads``): the
  DDP-style average over "data" of every parameter FSDP does not manage
  (FSDP2 reduce-scatters its own), and under sequence parallelism the sum
  over "model" of the blocks' token-shard LayerNorms and biases;
- averages a step's metrics over "data" (``mean_metrics``);
- gathers the full train state for a checkpoint (``gather_state``), in
  the single-device format (stacked layers in pipeline mode), and loads
  such a state into its shards (``load_state``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from visiontransformer_tpu_torch.parallel import launch
from visiontransformer_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FSDP_MIN_SIZE,
    MODEL_AXIS,
    create_mesh,
    mesh_dims,
    param_placements,
    shard_axis,
    shard_fsdp,
)
from visiontransformer_tpu_torch.parallel.multihost import global_batch
from visiontransformer_tpu_torch.parallel.pipeline import (
    STAGE_AXIS,
    Pipeline,
    create_pipeline_mesh,
)
from visiontransformer_tpu_torch.parallel.tensor import (
    gather_full,
    local_slice,
    parallelize_vit,
)


def wants_plan(train_cfg, mesh=None) -> bool:
    """Whether a trainer lays its model out over a job's ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return (mesh is not None or train_cfg.pipeline_stages > 1
            or (train_cfg.mesh_shape is not None
                and mesh_dims(train_cfg.mesh_shape, world) != (1, 1))
            or world > 1)


class Plan:
    def __init__(self, seg_cfg, train_cfg, model: str, mesh=None, *,
                 device_type: str = "cuda"):
        world = dist.get_world_size() if dist.is_initialized() else 1
        micro = train_cfg.batch_size // train_cfg.accumulate_grad_batches
        self.pipe: Optional[Pipeline] = None
        self.fsdp = train_cfg.fsdp
        self.fsdp_min_size = (train_cfg.fsdp_min_size
                              if train_cfg.fsdp_min_size is not None
                              else FSDP_MIN_SIZE)
        self.vit = model == "vitseg"
        stages = train_cfg.pipeline_stages
        if stages > 1:
            if model != "vitseg":
                raise ValueError(
                    "pipeline parallelism is implemented for the vitseg "
                    f"model family, not {model!r}")
            if train_cfg.fsdp or train_cfg.seq_parallel:
                raise ValueError(
                    "pipeline_stages does not compose with fsdp/seq_parallel")
            if seg_cfg.vit.num_hidden_layers % stages:
                raise ValueError(
                    f"{seg_cfg.vit.num_hidden_layers} encoder layers must "
                    f"divide over {stages} pipeline stages")
            shape = train_cfg.mesh_shape
            if shape is None:
                if world % stages:
                    raise ValueError(
                        f"{world} devices do not divide into {stages} "
                        "pipeline stages; pass mesh_shape=(dp, stages)")
                shape = (world // stages, stages)
            if len(shape) != 2 or shape[1] != stages:
                raise ValueError(f"pipeline mesh_shape must be (dp, "
                                 f"{stages}); got {shape}")
            self.mesh = mesh if mesh is not None else create_pipeline_mesh(
                shape, device_type=device_type)
            m = train_cfg.pipeline_microbatches or stages
            self.dp, self.tp = shape[0], 1
            if micro % m or (micro // m) % self.dp:
                raise ValueError(
                    f"micro-batch {micro} must divide into {m} pipeline "
                    f"microbatches of a multiple of the data axis "
                    f"({self.dp} devices)")
            self.microbatches = m
            self.stages = stages
        else:
            self.mesh = mesh if mesh is not None else create_mesh(
                train_cfg.mesh_shape, device_type=device_type)
            names = self.mesh.mesh_dim_names
            self.dp = self.mesh.size(names.index(DATA_AXIS))
            self.tp = (self.mesh.size(names.index(MODEL_AXIS))
                       if MODEL_AXIS in names else 1)
            if micro % self.dp:
                raise ValueError(
                    f"micro-batch {micro} (batch_size="
                    f"{train_cfg.batch_size} / accumulate_grad_batches="
                    f"{train_cfg.accumulate_grad_batches}) must be divisible "
                    f"by the data-parallel mesh axis ({self.dp} devices); "
                    f"pick a larger batch or a smaller mesh "
                    f"(TrainConfig.mesh_shape)")
            self.stages = 1
        self.seq_parallel = (train_cfg.seq_parallel and self.tp > 1
                             and self.vit)
        self.data_group = self.mesh.get_group(DATA_AXIS)
        self.data_rank = self.mesh.get_local_rank(DATA_AXIS)
        self.model_group = (self.mesh.get_group(MODEL_AXIS)
                            if self.tp > 1 else None)
        self.model_rank = (self.mesh.get_local_rank(MODEL_AXIS)
                           if self.tp > 1 else 0)
        self.stage_group = (self.mesh.get_group(STAGE_AXIS)
                            if self.stages > 1 else None)
        self.heads = seg_cfg.vit.num_attention_heads if self.vit else 0
        self.partial: List[nn.Parameter] = []
        self.full_names: List[str] = []
        self.full_shapes: Dict[str, torch.Size] = {}
        self.specs: Dict[str, tuple] = {}

    # ----------------------------------------------------------- layout
    def describe(self) -> str:
        if self.stages > 1:
            return f"pipeline dp={self.dp} stages={self.stages}"
        mode = "fsdp" if self.fsdp else "dp"
        sp = " seq_parallel" if self.seq_parallel else ""
        return f"{mode} dp={self.dp} tp={self.tp}{sp}"

    def build(self, model: nn.Module) -> nn.Module:
        """Lay ``model`` (on this rank's device, weights equal on every
        rank) out over the mesh, in place."""
        self.full_names = [n for n, _ in model.named_parameters()]
        self.full_shapes = {n: p.shape for n, p in model.named_parameters()}
        self.specs = param_placements(model, (self.dp, self.tp),
                                      fsdp=self.fsdp,
                                      fsdp_min_size=self.fsdp_min_size)
        if self.stages > 1:
            backbone = model.backbone
            pipe = Pipeline(self.stage_group, len(backbone.layers),
                            self.microbatches, self.data_rank, self.dp)
            backbone.layers = nn.ModuleList(list(backbone.layers)[
                pipe.first_layer:pipe.first_layer + pipe.per_stage])
            model.pipeline = self.pipe = pipe
            return model
        partial = []
        if self.tp > 1 and self.vit:
            partial = parallelize_vit(model.backbone, self.mesh,
                                      seq_parallel=self.seq_parallel)
        if self.fsdp and self.dp > 1:
            shard_fsdp(model, self.mesh, self.specs,
                       layers=list(model.backbone.layers) if self.vit
                       else ())
        # By name: FSDP replaces the parameters it shards.
        params = dict(model.named_parameters())
        self.partial = [params["backbone." + n] for n in partial
                        if "backbone." + n in params]
        return model

    @staticmethod
    def foreach(model: nn.Module) -> Optional[bool]:
        """The optimizer's ``foreach`` flag: False where FSDP's sharded
        parameters and plain (replicated) ones share its one group, which
        torch's multi-tensor kernels refuse; else torch's default."""
        from torch.distributed.tensor import DTensor

        kinds = {isinstance(p, DTensor) for p in model.parameters()}
        return False if len(kinds) > 1 else None

    def full_name(self, local: str) -> str:
        """A parameter's name in the unsplit model."""
        if self.pipe is None or not local.startswith("backbone.layers."):
            return local
        _, _, index, rest = local.split(".", 3)
        return f"backbone.layers.{self.pipe.first_layer + int(index)}.{rest}"

    # ------------------------------------------------------------- step
    def local_rows(self, batch: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """This data rank's contiguous rows of every entry."""
        return global_batch(self.mesh, batch)

    @property
    def reduce_group(self):
        """The group a task's batch-global sums reduce over (None at
        dp = 1)."""
        return self.data_group if self.dp > 1 else None

    def sync_grads(self, model: nn.Module) -> None:
        """After the step's backward: the token-shard partial sums over
        "model", then the DDP average over "data" of every gradient FSDP
        has not reduce-scattered itself (one flat all-reduce)."""
        from torch.distributed.tensor import DTensor

        if self.partial:
            for p in self.partial:
                if p.grad is not None:
                    g = p.grad.to_local() if isinstance(p.grad, DTensor) \
                        else p.grad
                    launch.all_reduce(g, self.model_group)
        if self.dp == 1:
            return
        grads = [p.grad for p in model.parameters() if p.grad is not None
                 and not isinstance(p.grad, DTensor)]
        if not grads:
            return
        flat = torch._utils._flatten_dense_tensors(grads)
        launch.all_reduce(flat, self.data_group)
        flat.div_(self.dp)
        for g, synced in zip(grads, torch._utils._unflatten_dense_tensors(
                flat, grads)):
            g.copy_(synced)

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The data ranks' mean of each metric: the global batch's value
        for a mean over equal row shards, unchanged for one the task
        already reduced."""
        if self.dp == 1:
            return metrics
        keys = list(metrics)
        stacked = torch.stack([metrics[k].float() for k in keys])
        launch.all_reduce(stacked, self.data_group)
        stacked.div_(self.dp)
        return {k: stacked[i] for i, k in enumerate(keys)}

    # ------------------------------------------------------ checkpoints
    def _local_params(self, model):
        return [(self.full_name(n), p) for n, p in model.named_parameters()]

    def _to_full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of parameter (or moment) ``name`` from this
        rank's part of it (a collective over the groups that split it)."""
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            # FSDP's even Shard(dim) over "data", gathered through
            # parallel/launch.py: DTensor.full_tensor's functional
            # collectives crash under gloo on CUDA tensors (torch 2.11).
            dim = t.placements[0].dim
            t = launch.all_gather(t.to_local().movedim(dim, 0).contiguous(),
                                  self.data_group).movedim(0, dim)
        if self.tp > 1 and self.vit:
            t = gather_full(name, t, self.heads, self.model_group)
        return t

    def gathered(self, model: nn.Module, get) -> Optional[Dict[str,
                                                             torch.Tensor]]:
        """{full name: full tensor} of ``get(param)`` (the parameter, its
        gradient or a moment; None skips it on every rank) in the
        per-layer form, on the CPU of rank 0 (None elsewhere); a
        collective of every rank."""
        primary = launch.is_primary()
        out: Dict[str, torch.Tensor] = {}
        stacks: Dict[str, list] = {}
        for name, p in self._local_params(model):
            t = get(p)
            if t is None:
                continue
            t = t.detach()
            if self.pipe is not None and name.startswith("backbone.layers."):
                stacks.setdefault(name.split(".", 3)[3], []).append(t)
                continue
            t = self._to_full(name, t)
            if primary:
                out[name] = t.cpu()
        for leaf, ts in stacks.items():
            # This stage's layers of the leaf -> every stage's, (L, ...).
            stacked = launch.all_gather(torch.stack(ts), self.stage_group)
            if primary:
                for i in range(len(stacked)):
                    out[f"backbone.layers.{i}.{leaf}"] = stacked[i].cpu()
        return out if primary else None

    def gather_state(self, model: nn.Module,
                     optimizer: torch.optim.Optimizer
                     ) -> Optional[Tuple[dict, dict]]:
        """The full (params state dict, optimizer state dict) in the
        single-device format, on the CPU of rank 0 (None elsewhere); every
        rank must call it. Pipeline mode returns ``backbone.layers``
        stacked, its moments alike."""
        from visiontransformer_tpu_torch.parallel.state import (
            stack_train_state,
        )

        if len(optimizer.param_groups) != 1:
            raise ValueError("a parallel trainer's optimizer has one group")
        params = self.gathered(model, lambda p: p)
        keys = sorted({k for s in optimizer.state.values() for k in s})
        moments = {}
        scalars = {}
        for key in keys:
            def get(p, key=key):
                v = optimizer.state.get(p, {}).get(key)
                return v if isinstance(v, torch.Tensor) and v.dim() else None
            moments[key] = self.gathered(model, get)
            # The step count: the same for every parameter.
            for name, p in self._local_params(model):
                v = optimizer.state.get(p, {}).get(key)
                if v is not None and not (isinstance(v, torch.Tensor)
                                          and v.dim()):
                    scalars.setdefault(key, v.detach().cpu()
                                       if isinstance(v, torch.Tensor) else v)
        if params is None:
            return None
        ids = {n: i for i, n in enumerate(self.full_names)}
        state: Dict[int, dict] = {}
        for name in self.full_names:
            entry = {k: moments[k][name] for k in keys
                     if moments[k] is not None and name in moments[k]}
            if entry:
                entry.update(scalars)
                state[ids[name]] = dict(sorted(entry.items()))
        group = {k: v for k, v in optimizer.state_dict()[
            "param_groups"][0].items() if k != "params"}
        group["foreach"] = None  # an implementation flag, not the state's
        opt = {"state": state,
               "param_groups": [{**group, "params": list(range(len(ids)))}]}
        params = {n: params[n] for n in self.full_names}
        if self.pipe is not None:
            return stack_train_state(params, opt)
        return params, opt

    def load_state(self, model: nn.Module, optimizer: Optional[
            torch.optim.Optimizer], params: Mapping[str, torch.Tensor],
                   opt: Optional[Mapping]) -> None:
        """Write a full single-device state (per-layer form) into this
        rank's parts of ``model`` and ``optimizer``."""
        from torch.distributed.tensor import DTensor

        local = self._local_params(model)
        with torch.no_grad():
            for name, p in local:
                p_local = p.to_local() if isinstance(p, DTensor) else p
                p_local.copy_(self._to_local(name, p, params[name]))
        if optimizer is None or opt is None:
            return
        ids = {n: i for i, n in enumerate(self.full_names)}
        state = {}
        for i, (name, p) in enumerate(local):
            saved = opt["state"].get(ids[name])
            if saved is None:
                continue
            state[i] = {}
            for key, v in saved.items():
                if isinstance(v, torch.Tensor) and v.dim():
                    v = self._to_local(name, p, v)
                    if isinstance(p, DTensor):
                        v = DTensor.from_local(
                            v.to(p.device), p.device_mesh, p.placements,
                            shape=p.shape, stride=p.stride(),
                            run_check=False)
                state[i][key] = v
        group = {k: v for k, v in opt["param_groups"][0].items()
                 if k != "params"}
        group["foreach"] = optimizer.param_groups[0]["foreach"]
        optimizer.load_state_dict({"state": state, "param_groups": [
            {**group, "params": list(range(len(local)))}]})

    def _to_local(self, name: str, p, full: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        t = full
        if self.tp > 1 and self.vit:
            t = local_slice(name, t, self.heads, self.model_rank, self.tp)
        if isinstance(p, DTensor):
            axis = shard_axis(self.specs[name], DATA_AXIS)
            t = t.chunk(self.dp, axis)[self.data_rank]
        return t
