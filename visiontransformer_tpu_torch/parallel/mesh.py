"""The ("data", "model") mesh and the parameter layout rules (the TPU
package's ``parallel/mesh.py``).

``create_mesh`` builds a ``DeviceMesh`` over the job's ranks (one rank per
device, ``parallel/launch.py``): batch rows split over "data", tensor
parallelism over "model". The layout rules are the TPU package's, by
parameter name (a state-dict name of the port has the same components as
the TPU package's tree path):

- Megatron (``param_spec``): the ``qkv`` and ``mlp_in`` kernels split on
  their output axis (their biases too), ``attn_out`` and ``mlp_out``
  kernels on their input axis, everything else replicated. The fused QKV
  splits by heads (``parallel/tensor.py``), not by contiguous columns.
- FSDP (``fsdp_spec``): "data" on the largest axis that divides by dp and
  is not taken by "model", for leaves of at least ``FSDP_MIN_SIZE``
  elements; smaller leaves stay replicated.

``param_placements`` gives each parameter's spec as a tuple of axis names
(None for an unsplit axis), the form of a JAX ``PartitionSpec``. The specs
are applied by ``parallel/tensor.py`` ("model") and ``shard_fsdp``
("data", FSDP2's ``fully_shard``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Leaves below this element count stay replicated under FSDP: sharding a
# few-KB LayerNorm scale buys nothing and costs a gather.
FSDP_MIN_SIZE = 2 ** 15

Spec = Tuple[Optional[str], ...]


def mesh_dims(shape: Optional[Sequence[int]], world_size: int
              ) -> Tuple[int, int]:
    """(dp, tp) of a mesh shape: None is every rank on "data", (dp,) is
    dp × 1. Raises unless dp · tp is the world size."""
    if shape is None:
        shape = (world_size, 1)
    elif len(shape) == 1:
        shape = (shape[0], 1)
    dp, tp = shape
    if dp * tp != world_size:
        raise ValueError(f"mesh shape {tuple(shape)} != {world_size} devices")
    return dp, tp


def create_mesh(shape: Optional[Sequence[int]] = None, *,
                device_type: Optional[str] = None):
    """A ("data", "model") ``DeviceMesh`` over the job's ranks. shape=None
    puts every rank on "data"; (dp,) is dp × 1; (dp, tp) is dp × tp. Outside
    a job the world is this one process. device_type: by default that of
    this rank's device (``parallel/launch.py:device``)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    dp, tp = mesh_dims(shape, world)
    if device_type is None:
        from visiontransformer_tpu_torch.parallel.launch import device
        device_type = device().type
    return init_device_mesh(device_type, (dp, tp),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh=None) -> Spec:
    """The batch's spec: rows split over "data" (each rank's rows:
    ``multihost.global_batch``)."""
    return (DATA_AXIS,)


def replicated(mesh=None) -> Spec:
    """The spec of a tensor every rank holds whole."""
    return ()


def param_spec(name: str) -> Spec:
    """The Megatron layout of a parameter by its name."""
    parts = name.split(".")
    if "qkv" in parts or "mlp_in" in parts:
        if parts[-1] == "kernel":
            return (None, MODEL_AXIS)
        if parts[-1] == "bias":
            return (MODEL_AXIS,)
    if "attn_out" in parts or "mlp_out" in parts:
        if parts[-1] == "kernel":
            return (MODEL_AXIS, None)
    return ()


def fsdp_spec(spec: Spec, shape: Sequence[int], dp: int,
              min_size: int = FSDP_MIN_SIZE) -> Spec:
    """Add "data" to ``spec`` (ZeRO-3 weight sharding): on the largest
    dp-divisible axis that "model" leaves free, for leaves of at least
    ``min_size`` elements."""
    numel = 1
    for n in shape:
        numel *= n
    if dp <= 1 or numel < min_size:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    candidates = [i for i in range(len(shape))
                  if entries[i] is None and shape[i] % dp == 0
                  and shape[i] >= dp]
    if not candidates:
        return spec
    axis = max(candidates, key=lambda i: shape[i])
    entries[axis] = DATA_AXIS
    return tuple(entries)


def param_placements(model: nn.Module, mesh_shape: Sequence[int], *,
                     fsdp: bool = False,
                     fsdp_min_size: int = FSDP_MIN_SIZE) -> Dict[str, Spec]:
    """Each parameter's spec (the TPU package's ``param_shardings``) on a
    (dp, tp) mesh, from the full (unsplit) model's shapes. As in the TPU
    package, the Megatron spec names "model" at tp = 1 too, where it
    splits nothing but keeps FSDP off that axis."""
    dp = (tuple(mesh_shape) + (1,))[0]
    out = {}
    for name, p in model.named_parameters():
        spec = param_spec(name)
        if fsdp:
            spec = fsdp_spec(spec, tuple(p.shape), dp, fsdp_min_size)
        out[name] = spec
    return out


def shard_axis(spec: Spec, axis_name: str) -> Optional[int]:
    """The dim ``spec`` splits over ``axis_name``, or None."""
    return spec.index(axis_name) if axis_name in spec else None


def shard_fsdp(model: nn.Module, mesh, specs: Dict[str, Spec],
               layers: Sequence[nn.Module] = ()) -> set:
    """FSDP2 over the mesh's "data" axis: ``fully_shard`` on each module of
    ``layers`` (the encoder blocks, gathered one at a time) and on the
    root, each parameter split on the dim its spec gives "data". A
    parameter whose spec has no "data" (below the size threshold, or no
    free divisible axis) is left out of FSDP (``ignored_params``) and stays
    a replicated plain tensor; its gradient is averaged over "data" by the
    trainer, as a DDP gradient is. Returns those replicated parameters.

    ``specs`` is keyed by the model's parameter names; under tensor
    parallelism the parameters are already this rank's "model" shards
    (``parallel/tensor.py``), which FSDP splits further."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    data_mesh = mesh[DATA_AXIS]
    dims = {}
    replicated = set()
    for name, p in model.named_parameters():
        axis = shard_axis(specs[name], DATA_AXIS)
        if axis is None:
            replicated.add(p)
        else:
            dims[p] = axis

    def placement(p):
        return Shard(dims[p])

    for layer in layers:
        fully_shard(layer, mesh=data_mesh, shard_placement_fn=placement,
                    ignored_params=replicated)
    fully_shard(model, mesh=data_mesh, shard_placement_fn=placement,
                ignored_params=replicated)
    return replicated
