"""Process groups of the parallel modes: the rendezvous, the ranks and
their devices, and the collectives every mode goes through.

The TPU package is single-controller SPMD (one process, a mesh of
devices); the port runs one process per rank, each rank owning one
device, as torch.distributed does.

- ``spawn(fn, world_size)`` starts ``world_size`` ranks of a local job
  (``multiprocessing`` spawn context) that meet at a ``FileStore`` in a
  fresh temporary directory, so concurrent jobs on one host cannot collide
  on a port; ``init_rank`` joins an existing job at any ``init_method``
  (``tcp://host:port`` across hosts, ``parallel/multihost.py``).
- Backend: NCCL when each rank has a card of its own; gloo on the CPU and
  when ranks share a card (NCCL refuses two ranks on one device). Ranks
  may share a card only when the caller asks for it (``share_device``);
  otherwise a job asking for more ranks than the host has cards raises.
- Host staging: on a shared card gloo runs every collective but the
  ones in ``HOST_STAGED`` on CUDA tensors itself; those go through host
  memory here (``_staged``), and ``transport()`` reports "gloo-host".
  Every collective of the port goes through the functions below, so that
  rule lives in this one place.
- Teardown: ``spawn`` always destroys each rank's group, gives every join
  a timeout and kills the ranks still alive when one fails, so a failed
  rank cannot hang the others.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from visiontransformer_tpu_torch.device import resolve_device

# What gloo cannot do on CUDA tensors (torch 2.11 on an H100, two ranks on
# one card): its all-reduce, broadcast, all-gather and reduce-scatter take
# them, but a send of a CUDA tensor aborts the process ("writev: Bad
# address"), so point-to-point transfers are staged through host memory.
HOST_STAGED = frozenset({"send", "recv"})
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

# This process's rank setup, written once by ``init_rank`` (or by
# ``device`` in a job started without it): the device it owns and whether
# its ranks share a card (the torch.distributed default
# group is process-wide state of the same kind).
_SETUP = {"device": None, "shared": False, "staged": 0}


def backend_for(device: torch.device, shared: bool) -> str:
    """NCCL when each rank owns a card; gloo on the CPU or a shared card."""
    return "nccl" if device.type == "cuda" and not shared else "gloo"


def rank_device(local_rank: int, device_type: str, *,
                devices: Optional[Sequence[torch.device]] = None
                ) -> torch.device:
    """The device of a rank: ``devices[local_rank]`` when given, else
    cuda:local_rank modulo the cards on the host (the CPU for "cpu")."""
    if devices is not None:
        return torch.device(devices[local_rank])
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_rank(rank: int, world_size: int, *, device: torch.device,
              init_method: Optional[str] = None, store=None,
              shared: bool = False,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> str:
    """Join the job as ``rank`` on ``device`` (at ``init_method``, or
    through ``store``); returns the backend."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend_for(device, shared)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = init_method
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=timeout, **kwargs)
    _SETUP.update(device=device, shared=shared and device.type == "cuda",
                  staged=0)
    return backend


def _card(device: torch.device) -> str:
    """The host and card of a CUDA device, the same from every process."""
    import socket

    return f"{socket.gethostname()}/{torch.cuda.get_device_properties(device).uuid}"


def shares_a_device(store, rank: int, world_size: int,
                    device: torch.device) -> bool:
    """Whether any two ranks of the job sit on one card: each rank writes
    its host and card to ``store`` and reads the others' (ranks on
    different hosts find this out only so)."""
    if device.type != "cuda":
        return False
    store.set(f"device/{rank}", _card(device))
    seen = [store.get(f"device/{r}").decode() for r in range(world_size)]
    return len(set(seen)) < world_size


def teardown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _SETUP.update(device=None, shared=False)


def device(requested: Optional[Union[str, torch.device]] = None
           ) -> torch.device:
    """The device this rank owns. A rank that joined through ``init_rank``
    owns the device it joined on, and asking it for another device type
    raises. A rank of a job started otherwise (the caller's own
    ``init_process_group``, torchrun) takes ``requested`` as every entry
    point resolves it (None is CUDA, which raises without a card), a bare
    "cuda" meaning the card of its LOCAL_RANK (else of its rank), and keeps
    it from then on. Outside a job: ``requested`` resolved."""
    own = _SETUP["device"]
    if own is not None:
        if requested is not None and torch.device(requested).type != own.type:
            raise ValueError(f"this rank owns {own}; it cannot run on "
                             f"{torch.device(requested)}")
        return own
    dev = resolve_device(requested)
    if not dist.is_initialized():
        return dev
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    shared = False
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        seen = [None] * dist.get_world_size()
        dist.all_gather_object(seen, _card(dev))
        shared = len(set(seen)) < len(seen)
    _SETUP.update(device=dev, shared=shared, staged=0)
    return dev


def in_job() -> bool:
    """Whether this process is a rank of a job of more than one."""
    return dist.is_initialized() and dist.get_world_size() > 1


def is_primary() -> bool:
    """True on exactly one rank of a job (rank 0), and outside a job."""
    return not dist.is_initialized() or dist.get_rank() == 0


def transport() -> str:
    """How this job's collectives travel: "nccl", "gloo", or "gloo-host"
    where ranks share a card and ``HOST_STAGED`` collectives go through
    host memory."""
    if not dist.is_initialized():
        return "none"
    backend = dist.get_backend()
    return "gloo-host" if backend == "gloo" and _SETUP["shared"] else backend


def staged_transfers() -> int:
    """How many transfers this rank has staged through host memory."""
    return _SETUP["staged"]


# ---------------------------------------------------------------- collectives
def _staged(name: str, t: torch.Tensor) -> bool:
    staged = name in HOST_STAGED and _SETUP["shared"] and t.is_cuda
    _SETUP["staged"] += staged
    return staged


def _global(group, group_rank: int) -> int:
    return group_rank if group is None else dist.get_global_rank(group,
                                                                 group_rank)


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place SUM over ``group``; returns ``t``."""
    dist.all_reduce(t, group=group)
    return t


def global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over ``group``'s ranks by a differentiable all-reduce
    (its gradient is all-reduced too), or x itself when ``group`` is None:
    a loss's or metric's sums over the global batch under data
    parallelism."""
    if group is None:
        return x
    from torch.distributed.nn.functional import all_reduce as reduce_sum

    return reduce_sum(x, group=group)


def global_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over ``group``'s ranks of a mean over equal row shards:
    the global batch's mean."""
    if group is None:
        return x
    return global_sum(x, group) / dist.get_world_size(group)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """In-place broadcast from ``src``, a rank of ``group``."""
    dist.broadcast(t, _global(group, src), group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The group's tensors of ``t``'s shape, concatenated on dim 0."""
    n = dist.get_world_size(group)
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """SUM over the group, then this rank's 1/n of dim 0."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, t, group=group)
    return out


def send(t: torch.Tensor, dst: int, group=None) -> None:
    """Send to ``dst``, a rank of ``group``."""
    t = t.contiguous()
    if _staged("send", t):
        t = t.cpu()
    dist.send(t, _global(group, dst), group=group)


def recv(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Receive into ``t`` from ``src``, a rank of ``group``; returns ``t``."""
    if _staged("recv", t):
        host = torch.empty(t.shape, dtype=t.dtype)
        dist.recv(host, _global(group, src), group=group)
        return t.copy_(host)
    dist.recv(t, _global(group, src), group=group)
    return t


def barrier(group=None) -> None:
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[device().index])
    else:
        dist.barrier(group=group)


# --------------------------------------------------------------------- spawn
def _entry(rank: int, threads: Optional[int], fn: Callable, rank_args,
           results) -> None:
    if threads:
        torch.set_num_threads(threads)
    # Plain pickle bytes: torch's queue would pass tensors as shared
    # memory, which vanishes with this process.
    results.put((rank, pickle.dumps(fn(*rank_args[rank]))))


def _failures(context, first) -> str:
    """The first failure, then every other rank's traceback (a rank's own
    error, then the others' broken collectives, in either order)."""
    lines = [str(first)]
    for i, path in enumerate(context.error_files):
        if i != first.error_index and os.access(path, os.R_OK):
            with open(path, "rb") as fh:
                lines.append(f"-- Process {i} failed too:\n{pickle.load(fh)}")
        if os.path.exists(path):
            os.unlink(path)
    return "\n".join(lines)


def run_processes(fn: Callable, rank_args: Sequence[tuple], *,
                  threads: Optional[int] = None,
                  timeout: float = DEFAULT_TIMEOUT.total_seconds()
                  ) -> List[Any]:
    """Run ``fn(*rank_args[i])`` in one new process each (spawn context)
    and return the results in order; ``fn`` and the results are pickled.
    Raises RuntimeError with the first failure's traceback, when a process
    dies, or when they outlast ``timeout`` seconds; kills whatever is
    still alive then."""
    import torch.multiprocessing as mp

    n = len(rank_args)
    results = mp.get_context("spawn").Queue()
    context = mp.start_processes(_entry, (threads, fn, list(rank_args),
                                          results),
                                 nprocs=n, join=False, daemon=True,
                                 start_method="spawn")
    got = {}
    deadline = time.monotonic() + timeout
    try:
        done = False
        while not (done and len(got) == n):
            # Raises on a failed rank, once the others have had a few
            # seconds to write their own errors.
            done = context.join(timeout=0.2, grace_period=5)
            # Drain the queue while joining (a process blocks at exit on a
            # full pipe).
            while True:
                try:
                    i, out = results.get_nowait()
                except queue.Empty:
                    break
                got[i] = pickle.loads(out)
            if time.monotonic() > deadline:
                raise RuntimeError(f"parallel job timed out after {timeout} "
                                   f"s ({sorted(got)} of {n} ranks done)")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise RuntimeError(_failures(context, e)) from None
    finally:
        for p in context.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
    return [got[i] for i in range(n)]


def _job_rank(rank: int, world_size: int, init_method: str,
              device_type: str, devices, shared: bool, fn: Callable,
              args: tuple) -> Any:
    dev = rank_device(rank, device_type, devices=devices)
    init_rank(rank, world_size, device=dev, init_method=init_method,
              shared=shared)
    try:
        return fn(*args)
    finally:
        teardown()


def spawn(fn: Callable, world_size: int, args: tuple = (), *,
          device_type: str = "cuda", share_device: bool = False,
          devices: Optional[Sequence[torch.device]] = None,
          threads: Optional[int] = None,
          timeout: float = DEFAULT_TIMEOUT.total_seconds()) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` new ranks of a local job and
    return their results in rank order (``fn`` and its results are
    pickled: a module-level function, and CPU values). Raises RuntimeError
    with the first failed rank's traceback, or when the job outlasts
    ``timeout`` seconds. ``share_device`` lets ranks share a card
    (gloo); otherwise a job needs a card per rank. ``threads`` sets each
    rank's torch thread count; on the CPU it defaults to this process's
    count shared out among the ranks (more threads than cores stall
    every rank's operator pools)."""
    if device_type == "cuda" and devices is None and not share_device:
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"{world_size} ranks need {world_size} cards, the host has "
                f"{cards}; pass fewer ranks (a smaller --mesh)")
    shared = share_device or (devices is not None and len(
        {str(d) for d in devices}) < world_size)
    if threads is None and device_type == "cpu":
        threads = max(1, torch.get_num_threads() // world_size)
    store_dir = tempfile.mkdtemp(prefix="vt_rendezvous_")
    init_method = "file://" + os.path.join(store_dir, "store")
    try:
        return run_processes(_job_rank, [
            (rank, world_size, init_method, device_type, devices, shared,
             fn, args) for rank in range(world_size)],
            threads=threads, timeout=timeout)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
