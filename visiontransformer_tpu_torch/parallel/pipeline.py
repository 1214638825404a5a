"""GPipe pipeline parallelism over a ("data", "stage") mesh (the TPU
package's ``parallel/pipeline.py``).

The L encoder layers split into S stages of L/S contiguous layers; each
stage rank holds only its layers (and so their Adam moments), embedding,
final LayerNorm and head are replicated and run outside the pipeline.
``pipeline_apply`` runs the GPipe schedule with hand-written
point-to-point sends (``parallel/launch.py:send``/``recv``) inside one
``torch.autograd.Function``:

- forward: microbatch j enters stage 0 at tick j and leaves stage S - 1
  at tick j + S - 1 (M + S - 1 ticks; stage s idles in the S - 1 bubble
  ticks instead of computing a throwaway microbatch, as the TPU package's
  scan does). The last stage's output is broadcast to every stage, so the
  replicated head sees the same activations everywhere;
- backward: the gradients travel the ring the other way; the gradient of
  the pipeline's input (stage 0's) is summed over "stage" (the other
  stages add zeros), so the replicated embedding's gradient is the same
  on every stage.

The output and its gradient are exact: each layer runs the port's own
``encoder_layer`` on the same rows as without the pipeline. Hand-written
sends rather than ``torch.distributed.pipelining``: that package traces
the stage into a copy of the model, where the port's forward (and its
kernels' custom autograd) must stay as it is, and its schedules assume
one loss per stage where the replicated head here computes the loss on
every stage.

The stacked form (``stack_stage_params``): a pipeline checkpoint stores
``backbone.layers`` as one tensor per leaf with a leading layer axis, as
the TPU package's pipeline checkpoints do; ``unstack_stage_params`` and
``maybe_unstack_params`` give back the per-layer form plain serving and a
non-pipeline resume use. They work on state dicts (name -> tensor).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from visiontransformer_tpu_torch.parallel import launch
from visiontransformer_tpu_torch.parallel.mesh import DATA_AXIS, mesh_dims

STAGE_AXIS = "stage"
LAYERS = "backbone.layers."
_LAYER_KEY = re.compile(r"^backbone\.layers\.(\d+)\.(.+)$")


def create_pipeline_mesh(shape: Sequence[int], *,
                         device_type: Optional[str] = None):
    """A ("data", "stage") ``DeviceMesh``; shape=(dp, S)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if len(shape) != 2:
        raise ValueError(f"pipeline mesh shape must be (dp, stages); got "
                         f"{tuple(shape)}")
    dp, pp = mesh_dims(shape, world)
    if device_type is None:
        device_type = launch.device().type
    return init_device_mesh(device_type, (dp, pp),
                            mesh_dim_names=(DATA_AXIS, STAGE_AXIS))


def pipeline_param_placements(names: Sequence[str]) -> Dict[str, tuple]:
    """Each parameter's spec in pipeline mode (the TPU package's
    ``pipeline_param_shardings``): the stacked encoder layers split over
    "stage" on their leading layer axis, everything else replicated."""
    return {n: ((STAGE_AXIS,) if n.startswith(LAYERS) else ()) for n in names}


def is_stacked(state: Mapping[str, torch.Tensor]) -> bool:
    return any(k.startswith(LAYERS) and not _LAYER_KEY.match(k)
               for k in state)


def stack_stage_params(state: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Per-layer ``backbone.layers.<i>.<leaf>`` entries -> one
    ``backbone.layers.<leaf>`` entry per leaf with a leading layer axis,
    at the place of the first layer's entries; the others keep their
    order."""
    layers: Dict[str, Dict[int, torch.Tensor]] = {}
    out: Dict[str, object] = {}
    for key, value in state.items():
        m = _LAYER_KEY.match(key)
        if m is None:
            out[key] = value
            continue
        leaf = LAYERS + m.group(2)
        out.setdefault(leaf, None)
        layers.setdefault(leaf, {})[int(m.group(1))] = value
    for leaf, by_index in layers.items():
        out[leaf] = torch.stack([by_index[i] for i in sorted(by_index)])
    return out


def unstack_stage_params(state: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The inverse of ``stack_stage_params``."""
    out: Dict[str, torch.Tensor] = {}
    stacked = [k for k in state if k.startswith(LAYERS)]
    n = len(state[stacked[0]]) if stacked else 0
    for key, value in state.items():
        if key.startswith(LAYERS):
            if key == stacked[0]:
                leaves = [k[len(LAYERS):] for k in stacked]
                for i in range(n):
                    for leaf in leaves:
                        out[f"{LAYERS}{i}.{leaf}"] = state[LAYERS + leaf][i]
            continue
        out[key] = value
    return out


def maybe_unstack_params(state: Mapping[str, torch.Tensor]
                         ) -> Mapping[str, torch.Tensor]:
    """A restored vitseg state dict in the per-layer form: unstacked if
    it came back stacked, unchanged otherwise."""
    return unstack_stage_params(state) if is_stacked(state) else state


class Pipeline:
    """The "stage" group of a pipeline rank, its layers' place in the
    stack and the microbatch count."""

    def __init__(self, group, n_layers: int, n_microbatches: int,
                 data_rank: int = 0, data_size: int = 1):
        self.group = group
        self.stages = dist.get_world_size(group)
        self.stage = dist.get_rank(group)
        if n_layers % self.stages:
            raise ValueError(f"{n_layers} layers must divide over "
                             f"{self.stages} pipeline stages")
        self.n_layers = n_layers
        self.per_stage = n_layers // self.stages
        self.first_layer = self.stage * self.per_stage
        self.n_microbatches = n_microbatches
        self.data_rank, self.data_size = data_rank, data_size

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1


def pipeline_apply(x: torch.Tensor, layer_fn: Callable, pipe: Pipeline,
                   params: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Run this stage's layers as stage ``pipe.stage`` of the GPipe
    schedule. x: (B, ...) activations, the same on every stage (this
    rank's data shard); ``layer_fn(y, microbatch)`` applies this stage's
    layers, whose parameters are ``params``, to a microbatch (their
    gradients accumulate in their ``.grad`` during the backward). Returns
    the (B, ...) output of all L layers on every stage."""
    batch, m = x.shape[0], pipe.n_microbatches
    if batch % m:
        raise ValueError(f"batch {batch} must divide into {m} microbatches")
    if not torch.is_grad_enabled():  # inference: no graphs to keep
        return _forward(x, layer_fn, pipe, grad=False)[0]
    return _GPipe.apply(x, layer_fn, pipe, *params)


def _forward(x, layer_fn, pipe: Pipeline, grad: bool):
    """The forward ticks: (output on every stage, each microbatch's input
    and output on this stage, graphs kept where ``grad``)."""
    chunks = x.detach().chunk(pipe.n_microbatches)
    inputs: List[torch.Tensor] = []
    outputs: List[torch.Tensor] = []
    for j, chunk in enumerate(chunks):
        inp = chunk if pipe.stage == 0 else launch.recv(
            torch.empty_like(chunk), pipe.stage - 1, pipe.group)
        if grad:
            inp = inp.detach().requires_grad_()
        with torch.enable_grad() if grad else torch.no_grad():
            y = layer_fn(inp, j)
        if not pipe.last:
            launch.send(y.detach(), pipe.stage + 1, pipe.group)
        inputs.append(inp)
        outputs.append(y)
    out = (torch.cat([y.detach() for y in outputs]) if pipe.last
           else torch.empty_like(x))
    out = launch.broadcast(out.contiguous(), pipe.stages - 1, pipe.group)
    return out, inputs, outputs


class _GPipe(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, layer_fn, pipe: Pipeline, *params):
        out, ctx.inputs, ctx.outputs = _forward(x, layer_fn, pipe,
                                                grad=True)
        ctx.pipe, ctx.n_params = pipe, len(params)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        pipe = ctx.pipe
        m = pipe.n_microbatches
        grads = grad_out.contiguous().chunk(m)
        grad_in = []
        for j in range(m):
            g = grads[j] if pipe.last else launch.recv(
                torch.empty_like(ctx.outputs[j]), pipe.stage + 1, pipe.group)
            # The stage's parameters are leaves of this graph: their
            # gradients accumulate in .grad here, not through the return.
            torch.autograd.backward(ctx.outputs[j], g)
            gi = ctx.inputs[j].grad
            if pipe.stage > 0:
                launch.send(gi, pipe.stage - 1, pipe.group)
            grad_in.append(gi)
        ctx.inputs = ctx.outputs = None
        # Only stage 0 fed the input into the pipeline: the sum over
        # "stage" is its gradient, on every stage.
        g = (torch.cat(grad_in) if pipe.stage == 0
             else torch.zeros_like(grad_out))
        return ((launch.all_reduce(g.contiguous(), pipe.group), None, None)
                + (None,) * ctx.n_params)
