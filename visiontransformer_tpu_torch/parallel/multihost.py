"""Multi-host training (the TPU package's ``parallel/multihost.py``).

The TPU package joins each host's process to one ``jax.distributed`` job
and builds a mesh over every device of the pod. Here every rank is a
process owning one device: host (process) ``i`` of ``num_processes``
starts one rank per local device (``local_ranks``), and rank ``r`` of
host ``i`` joins the job as global rank ``i · local_ranks + r`` at
``tcp://coordinator`` (a ``TCPStore`` that global rank 0 serves). Before
the process group starts, the ranks tell each other their host and card
through that store: where two share a card (two "hosts" on one machine,
as the tests and the single-card check run it) the job runs on gloo,
else on NCCL (``parallel/launch.py``).

- ``pod_mesh(tp)``: the ("data", "model") mesh over every rank of the
  job, and its dp;
- ``is_primary``: rank 0, which alone writes logs; every rank takes part
  in a checkpoint, which rank 0 writes (``train/trainer.py:save``);
- ``local_shard``: this rank's contiguous rows of a batch every rank
  holds whole (the data pipeline is deterministic and the same on every
  host); ``global_batch``: this rank's rows along the mesh's "data" axis
  (the ranks of one data shard hold the same rows), the counterpart of
  JAX's ``make_array_from_process_local_data``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from visiontransformer_tpu_torch.parallel import launch
from visiontransformer_tpu_torch.parallel.mesh import DATA_AXIS, create_mesh


def _store(coordinator: str, rank: int, world_size: int):
    host, port = coordinator.rsplit(":", 1)
    return dist.TCPStore(host, int(port), world_size, is_master=rank == 0,
                         timeout=launch.DEFAULT_TIMEOUT)


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int, *, local_rank: int = 0,
                         local_ranks: int = 1, device_type: str = "cuda"
                         ) -> str:
    """Join the multi-host job as local rank ``local_rank`` of host
    ``process_id``; returns the backend."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in "
                         f"[0, {num_processes})")
    world = num_processes * local_ranks
    rank = process_id * local_ranks + local_rank
    device = launch.rank_device(local_rank, device_type)
    store = _store(coordinator_address, rank, world)
    shared = launch.shares_a_device(store, rank, world, device)
    return launch.init_rank(rank, world, device=device, store=store,
                            shared=shared)


def _rank_main(coordinator, num_processes, process_id, local_rank,
               local_ranks, device_type, fn, args):
    initialize_multihost(coordinator, num_processes, process_id,
                         local_rank=local_rank, local_ranks=local_ranks,
                         device_type=device_type)
    try:
        return fn(*args)
    finally:
        launch.teardown()


def run_multihost(fn: Callable, args: tuple, *, coordinator: str,
                  num_processes: int, process_id: int,
                  local_ranks: Optional[int] = None,
                  device_type: str = "cuda") -> Any:
    """Run ``fn(*args)`` on this host's ranks of the multi-host job and
    return local rank 0's result. ``local_ranks`` defaults to the host's
    cards (1 on the CPU); one rank runs in this process."""
    if local_ranks is None:
        local_ranks = (torch.cuda.device_count() if device_type == "cuda"
                       else 1)
    if local_ranks == 1:
        return _rank_main(coordinator, num_processes, process_id, 0, 1,
                          device_type, fn, args)
    threads = (max(1, torch.get_num_threads() // local_ranks)
               if device_type == "cpu" else None)
    return launch.run_processes(_rank_main, [
        (coordinator, num_processes, process_id, r, local_ranks,
         device_type, fn, args) for r in range(local_ranks)],
        threads=threads)[0]


def pod_mesh(tp: int = 1) -> Tuple[Any, int]:
    """The ("data", "model") mesh over every rank of the job, and its dp.
    Call initialize_multihost first on every rank."""
    n = dist.get_world_size()
    if n % tp:
        raise ValueError(f"tp={tp} must divide global device count {n}")
    return create_mesh((n // tp, tp)), n // tp


def is_primary() -> bool:
    """True on exactly one rank of the job: gate logs and file writes."""
    return launch.is_primary()


def _rows(batch: Dict[str, Any], index: int, count: int,
          what: str) -> Dict[str, Any]:
    if count == 1:
        return dict(batch)
    out = {}
    for key, value in batch.items():
        if value.shape[0] % count:
            raise ValueError(
                f"batch axis {value.shape[0]} of '{key}' must be divisible "
                f"by {what} {count}")
        per = value.shape[0] // count
        out[key] = value[index * per:(index + 1) * per]
    return out


def local_shard(batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's contiguous rows of a batch every rank holds whole."""
    if not dist.is_initialized():
        return dict(batch)
    return _rows(batch, dist.get_rank(), dist.get_world_size(),
                 "process count")


def global_batch(mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of the global batch along the mesh's "data" axis:
    the rows the TPU package's batch sharding gives this rank's device."""
    return _rows(batch, mesh.get_local_rank(DATA_AXIS),
                 mesh.size(mesh.mesh_dim_names.index(DATA_AXIS)),
                 "the data axis")
