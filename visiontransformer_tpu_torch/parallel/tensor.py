"""Tensor (Megatron) and sequence parallelism of the ViT encoder over the
mesh's "model" axis: the counterpart of the TPU package's parameter
shardings and ``act_sharding``, which XLA turns into collectives; here
they are written out.

``parallelize_vit`` replaces each split parameter of every encoder block
by this rank's shard (``local_slice``, by the Megatron rule of
``parallel/mesh.py:param_spec``, the same rule that cuts and gathers
checkpoints), kept as a plain tensor, so the attention kernels and the
``vt::`` custom ops see plain local tensors and FSDP2 can split the shards
further over "data" (``parallel/mesh.py:shard_fsdp``): the fused QKV by
heads and ``mlp_in`` by output columns, ``attn_out`` and ``mlp_out`` by
input rows. The block then runs on its
nh/tp local heads and its 1/tp of the MLP (``models/vit.py``), with:

- tensor parallelism: one all-reduce after ``attn_out`` and one after
  ``mlp_out`` (``_ReduceFromModel``), and their transposes before ``qkv``
  and ``mlp_in`` (``_CopyToModel``);
- sequence parallelism: an all-gather of tokens before ``qkv`` and
  ``mlp_in`` and a reduce-scatter after ``attn_out`` and ``mlp_out``,
  so that between blocks the residual stream is token-sharded over
  "model" (the TPU package's P("data", "model")). Token shards are
  ceil(N/tp) long but the last (N = 197 at tp = 2: 99 and 98).

**The fused QKV splits by heads.** Its output axis is laid out (3, nh,
hd), so a contiguous column split at tp = 2 would give rank 0 all of q
and half of k; ``head_columns`` gives each rank q, k and v of nh/tp
heads, and nh must divide by tp (GSPMD does not need that; the port
does, deliberately). Checkpoints keep the full layout
(``parallel/state.py`` gathers the shards back).

Dropout under tensor parallelism: the residual stream's hidden dropout
is drawn from the step's generator, the same on every "model" rank (the
stream is replicated there); attention dropout acts on local heads and
so draws from a generator of this rank's (``TensorParallel.fork``); under
sequence parallelism the hidden dropout acts on token shards and draws
from that one too.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn

from visiontransformer_tpu_torch.parallel import launch
from visiontransformer_tpu_torch.parallel.mesh import MODEL_AXIS, param_spec

# fold_seed's salt for a "model" rank's generator.
_MODEL_SALT = 0x6D6F64656C


class TensorParallel:
    """The "model" group of an encoder block: its size, this rank's index,
    and whether the residual stream is token-sharded (sequence
    parallelism). Set as ``layer.tp`` by ``parallelize_vit``."""

    def __init__(self, group, seq_parallel: bool):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.seq_parallel = seq_parallel

    # Token shards of a sequence of n tokens: ceil(n / tp) each, the last
    # one (or ones) shorter.
    def chunk(self, n: int) -> int:
        return math.ceil(n / self.size)

    def token_range(self, n: int):
        c = self.chunk(n)
        start = min(self.rank * c, n)
        return start, min(start + c, n)

    def enter(self, y: torch.Tensor, n: int) -> torch.Tensor:
        """Before a column-parallel product (``qkv``, ``mlp_in``)."""
        if self.seq_parallel:
            return _GatherTokens.apply(y, self, n)
        return _CopyToModel.apply(y, self.group)

    def exit(self, y: torch.Tensor, n: int) -> torch.Tensor:
        """After a row-parallel product (``attn_out``, ``mlp_out``): the
        partial sums reduced (and token-scattered under sequence
        parallelism)."""
        if self.seq_parallel:
            return _ReduceScatterTokens.apply(y, self, n)
        return _ReduceFromModel.apply(y, self.group)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Replicated (B, N, H) -> this rank's token shard."""
        return _SplitTokens.apply(x, self, x.shape[1])

    def gather(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's token shard -> the replicated (B, N, H) stream."""
        return _AllGatherTokens.apply(x, self, n)

    def fork(self, generator: Optional[torch.Generator]
             ) -> Optional[torch.Generator]:
        """A generator of this "model" rank's own, derived from the step's
        generator without waiting for the card (its seed is host state)."""
        if generator is None:
            return None
        from visiontransformer_tpu_torch.train.trainer import fold_seed

        seed = fold_seed(fold_seed(generator.initial_seed(), _MODEL_SALT),
                         self.rank)
        return torch.Generator(device=generator.device).manual_seed(seed)


# ------------------------------------------------ autograd collectives
class _CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return launch.all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward; identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        return launch.all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _pad_tokens(x: torch.Tensor, length: int) -> torch.Tensor:
    """(B, n, H) -> (length, B, H), zero rows past n: tokens leading, as
    the collectives split dim 0."""
    t = x.transpose(0, 1)
    if t.shape[0] < length:
        pad = t.new_zeros((length - t.shape[0],) + tuple(t.shape[1:]))
        t = torch.cat([t, pad])
    return t.contiguous()


def _all_gather_tokens(x, tp: TensorParallel, n: int) -> torch.Tensor:
    full = launch.all_gather(_pad_tokens(x, tp.chunk(n)), tp.group)
    return full[:n].transpose(0, 1).contiguous()


def _reduce_scatter_tokens(x, tp: TensorParallel, n: int) -> torch.Tensor:
    part = launch.reduce_scatter(_pad_tokens(x, tp.chunk(n) * tp.size),
                                 tp.group)
    start, end = tp.token_range(n)
    return part[:end - start].transpose(0, 1).contiguous()


def _split_tokens(x, tp: TensorParallel, n: int) -> torch.Tensor:
    start, end = tp.token_range(n)
    return x[:, start:end].contiguous()


class _GatherTokens(torch.autograd.Function):
    """All-gather of token shards before a column-parallel product; the
    gradient is reduce-scattered (every rank's product used every token)."""

    @staticmethod
    def forward(ctx, x, tp, n):
        ctx.tp, ctx.n = tp, n
        return _all_gather_tokens(x, tp, n)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_tokens(g, ctx.tp, ctx.n), None, None


class _ReduceScatterTokens(torch.autograd.Function):
    """Reduce-scatter of partial sums after a row-parallel product; the
    gradient is all-gathered."""

    @staticmethod
    def forward(ctx, x, tp, n):
        ctx.tp, ctx.n = tp, n
        return _reduce_scatter_tokens(x, tp, n)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_tokens(g, ctx.tp, ctx.n), None, None


class _SplitTokens(torch.autograd.Function):
    """The replicated stream's token shard; the gradient is all-gathered
    (the shards' gradients are disjoint)."""

    @staticmethod
    def forward(ctx, x, tp, n):
        ctx.tp, ctx.n = tp, n
        return _split_tokens(x, tp, n)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_tokens(g, ctx.tp, ctx.n), None, None


class _AllGatherTokens(torch.autograd.Function):
    """The replicated stream from token shards; every rank computes the
    same consumer, so the gradient is this rank's shard of its own."""

    @staticmethod
    def forward(ctx, x, tp, n):
        ctx.tp, ctx.n = tp, n
        return _all_gather_tokens(x, tp, n)

    @staticmethod
    def backward(ctx, g):
        return _split_tokens(g, ctx.tp, ctx.n), None, None


# ------------------------------------------------------------- the split
def head_columns(hidden: int, heads: int, rank: int, size: int
                 ) -> torch.Tensor:
    """The fused QKV's output columns of ``rank``'s heads: q, k and v of
    heads [rank·nh/tp, (rank+1)·nh/tp), in that order."""
    if heads % size:
        raise ValueError(f"{heads} attention heads do not divide over the "
                         f"tensor-parallel axis ({size} ranks): the fused "
                         f"QKV splits by heads")
    hd, local = hidden // heads, heads // size
    cols = torch.arange(3 * hidden).reshape(3, heads, hd)
    return cols[:, rank * local:(rank + 1) * local].reshape(-1)


def _chunk_index(n: int, rank: int, size: int, what: str) -> torch.Tensor:
    if n % size:
        raise ValueError(f"{what} of {n} does not divide over the "
                         f"tensor-parallel axis ({size} ranks)")
    c = n // size
    return torch.arange(rank * c, (rank + 1) * c)


def parallelize_vit(backbone: nn.Module, mesh, *, seq_parallel: bool
                    ) -> List[str]:
    """Split every encoder block of ``backbone`` (models/vit.py:ViT) over
    the mesh's "model" axis in place: each split parameter becomes this
    rank's ``local_slice``, a plain tensor. Returns the names (in
    ``backbone``) of the replicated parameters whose gradients are partial
    sums over "model" (under sequence parallelism: the blocks' LayerNorms
    and row-parallel biases, which see one token shard), for the trainer to
    all-reduce."""
    group = mesh[MODEL_AXIS].get_group()
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    heads = backbone.cfg.num_attention_heads
    for name, p in list(backbone.layers.named_parameters(prefix="layers")):
        full = p.detach()
        local = local_slice(name, full, heads, rank, size)
        if local is not full:
            module, attr = name.rsplit(".", 1)
            setattr(backbone.get_submodule(module), attr,
                    nn.Parameter(local.clone().contiguous()))
    tp = TensorParallel(group, seq_parallel)
    partial = []
    for i, layer in enumerate(backbone.layers):
        layer.tp = tp
        if seq_parallel:
            partial += [f"layers.{i}.{n}" for n in (
                "ln1.scale", "ln1.bias", "ln2.scale", "ln2.bias",
                "attn_out.bias", "mlp_out.bias")]
    return partial


def _split_index(name: str, n: int, heads: int, rank: int,
                 size: int) -> torch.Tensor:
    """Rank ``rank``'s indices along the split dim (of length n) of
    parameter ``name``: the fused QKV's by heads, the others' a chunk."""
    if ".qkv." in f".{name}.":
        return head_columns(n // 3, heads, rank, size)
    return _chunk_index(n, rank, size, name)


def local_slice(name: str, full: torch.Tensor, heads: int, rank: int,
                size: int) -> torch.Tensor:
    """This "model" rank's part of parameter (or moment) ``name`` as
    ``parallelize_vit`` splits it; the full tensor where it is
    replicated."""
    spec = param_spec(name)
    if size == 1 or not spec:
        return full
    dim = spec.index(MODEL_AXIS)
    idx = _split_index(name, full.shape[dim], heads, rank, size)
    return full.index_select(dim, idx.to(full.device))


def gather_full(name: str, local: torch.Tensor, heads: int, group
                ) -> torch.Tensor:
    """The inverse of ``local_slice``: every "model" rank's part of
    ``name`` put back in the full layout (a collective of the group)."""
    size = dist.get_world_size(group)
    spec = param_spec(name)
    if size == 1 or not spec:
        return local
    dim = spec.index(MODEL_AXIS)
    mine = local.movedim(dim, 0).contiguous()
    parts = launch.all_gather(mine, group).reshape((size,) + mine.shape)
    full = mine.new_empty((size * mine.shape[0],) + mine.shape[1:])
    for rank in range(size):
        idx = _split_index(name, full.shape[0], heads, rank, size)
        full[idx.to(full.device)] = parts[rank]
    return full.movedim(0, dim)
