"""ViT backbone forward: ``vit_encode`` block by block, for training and
the logits; ``vit_cut_step``'s pieces for masks (``models/vitseg.py``).

Mirrors the TPU package's ``models/vit.py`` (HF ``ViTModel`` semantics):
patch embedding as patchify + one matmul, CLS token and learned position
embeddings, pre-LN encoder blocks with a fused (H, 3H) QKV projection and
exact-erf GELU MLP, final LayerNorm. With ``deterministic=False`` dropout
applies where the TPU package applies it (embeddings, attention probs,
attention output, MLP output), its draws taken in that order from one
explicit ``torch.Generator``.

Two options of ``ViTConfig`` shape the encoder trunk (``vit_encode``):

- ``token_merge_r``: ToMe merging after every block (``ops/token_merge.py``),
  then the final LayerNorm, then the unmerge back to every position;
- ``remat``: each block under ``torch.utils.checkpoint`` when a gradient
  is being taken, its activations recomputed in the backward. The
  recompute replays the block's dropout draws: the generator's state at
  the block's start is an input of the checkpointed function, which
  rewinds the generator to it on the recompute and restores it after, so
  loss, gradients and the generator's final state equal those without
  remat bit for bit (the TPU package passes ``fold_in(rng, i)`` into its
  checkpointed block instead).

Tensor and sequence parallelism (``parallel/tensor.py``): a block whose
``tp`` attribute is set runs on its local heads and MLP slice, with the
"model" collectives around its row- and column-parallel products; under
sequence parallelism ``vit_encode`` token-shards the residual stream
between the embedding and the final LayerNorm. ``vit_apply_pipelined``
runs the encoder as a GPipe pipeline (``parallel/pipeline.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from visiontransformer_tpu_torch.configs import ViTConfig
from visiontransformer_tpu_torch.nn.layers import (
    LayerNorm,
    Linear,
    dropout,
    gelu_exact,
    linear,
)
from visiontransformer_tpu_torch.ops.attention import multi_head_attention
from visiontransformer_tpu_torch.ops.layer_norm import add_layer_norm
from visiontransformer_tpu_torch.ops.token_merge import (
    init_merge_state,
    merge_step,
    unmerge,
)
from visiontransformer_tpu_torch.utils.spans import ranged


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ln1 = LayerNorm(h, eps)
        self.qkv = Linear(h, 3 * h, bias=cfg.qkv_bias)
        self.attn_out = Linear(h, h)
        self.ln2 = LayerNorm(h, eps)
        self.mlp_in = Linear(h, cfg.intermediate_size)
        self.mlp_out = Linear(cfg.intermediate_size, h)

    def forward(self, x: torch.Tensor, cfg: ViTConfig, **kwargs
                ) -> torch.Tensor:
        """``encoder_layer``; called as a module, so that FSDP2 gathers
        the block's weights around it."""
        with ranged("vit.block"):
            return encoder_layer(self, x, cfg, **kwargs)


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        patch_dim = cfg.patch_size * cfg.patch_size * cfg.num_channels
        self.patch_embed = Linear(patch_dim, cfg.hidden_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.hidden_size))
        self.pos_embed = nn.Parameter(
            torch.empty(1, cfg.seq_len, cfg.hidden_size))
        self.layers = nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.final_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, images: torch.Tensor, *, attn_impl: str = "auto",
                dtype: torch.dtype = torch.float32,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return vit_apply(self, images, attn_impl=attn_impl, dtype=dtype,
                         deterministic=deterministic, generator=generator)


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, p*p*C), (ph, pw, C) pixel order per patch."""
    b, h, w, c = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, gh, gw, ph, pw, C)
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


def vit_embed(model: ViT, images: torch.Tensor, *,
              dtype: torch.dtype = torch.float32, deterministic: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Patchify + project + CLS + position embeddings + embedding
    dropout."""
    with ranged("vit.embed"):
        x = patchify(images.to(dtype), model.cfg.patch_size)
        return vit_embed_patch_tokens(
            model, model.patch_embed(x, dtype=dtype), dtype=dtype,
            deterministic=deterministic, generator=generator)


def vit_embed_patch_tokens(model: ViT, x: torch.Tensor, *,
                           dtype: torch.dtype, deterministic: bool = True,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """``vit_embed`` after its projection: CLS + position embeddings +
    embedding dropout over (B, N, hidden) patch tokens."""
    x = x.to(dtype)
    cls = model.cls_token.to(dtype).expand(x.shape[0], -1, -1)
    x = torch.cat([cls, x], dim=1)
    x = x + model.pos_embed.to(dtype)
    return dropout(x, model.cfg.hidden_dropout_prob, generator=generator,
                   deterministic=deterministic)


def encoder_layer(layer: EncoderLayer, x: torch.Tensor, cfg: ViTConfig, *,
                  attn_impl: str, deterministic: bool = True,
                  generator: Optional[torch.Generator] = None,
                  tp_generator: Optional[torch.Generator] = None,
                  n_tokens: Optional[int] = None) -> torch.Tensor:
    """One pre-LN block: ``encoder_layer_qkv``, the attention
    (``block_attention``), then ``encoder_layer_out``. Under tensor
    parallelism (``layer.tp``) the attention draws its dropout from
    ``tp_generator``, this "model" rank's generator, as does the hidden
    dropout under sequence parallelism, where x is a token shard of a
    sequence of ``n_tokens``."""
    tp = getattr(layer, "tp", None)
    qkv = encoder_layer_qkv(layer, x, cfg, n_tokens=n_tokens)
    attn = block_attention(qkv, cfg, attn_impl=attn_impl,
                           deterministic=deterministic,
                           generator=generator if tp is None
                           else tp_generator)
    return encoder_layer_out(layer, x, attn, cfg,
                             deterministic=deterministic,
                             generator=generator, tp_generator=tp_generator,
                             n_tokens=n_tokens)


def _block_tokens(layer: EncoderLayer, x: torch.Tensor,
                  n_tokens: Optional[int]):
    """(the block's tensor-parallel plan or None, its sequence length)."""
    tp = getattr(layer, "tp", None)
    n = x.shape[1]
    if tp is not None and n_tokens is not None:
        n = n_tokens
    return tp, n


def encoder_layer_qkv(layer: EncoderLayer, x: torch.Tensor, cfg: ViTConfig,
                      *, n_tokens: Optional[int] = None,
                      normed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The block's half before attention: ln1 and the fused QKV projection,
    as a (3, B, heads, N, head_dim) view (q, k, v along the first axis).
    ``normed``: ln1(x), where the caller has it already."""
    tp, n = _block_tokens(layer, x, n_tokens)
    y = layer.ln1(x) if normed is None else normed
    if tp is not None:
        y = tp.enter(y, n)
    return layer.qkv(y).reshape(x.shape[0], n, 3, -1,
                                cfg.head_dim).permute(2, 0, 3, 1, 4)


def block_attention(qkv: torch.Tensor, cfg: ViTConfig, *, attn_impl: str,
                    deterministic: bool = True,
                    generator: Optional[torch.Generator] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The block's attention over ``encoder_layer_qkv``'s view, (B, heads,
    N, head_dim), through this module's ``multi_head_attention`` looked up
    at each call; ``out``: the tensor it writes (``multi_head_attention``)."""
    with ranged("vit.attention"):
        return multi_head_attention(
            qkv[0], qkv[1], qkv[2], implementation=attn_impl,
            dropout_rate=cfg.attention_probs_dropout_prob,
            generator=generator, deterministic=deterministic, out=out)


def encoder_layer_out(layer: EncoderLayer, x: torch.Tensor,
                      attn: torch.Tensor, cfg: ViTConfig, *,
                      deterministic: bool = True,
                      generator: Optional[torch.Generator] = None,
                      tp_generator: Optional[torch.Generator] = None,
                      n_tokens: Optional[int] = None,
                      norm: Optional[LayerNorm] = None):
    """The block's half after attention: the output projection and its
    residual, ln2, the MLP and its residual, with the hidden dropout.
    ``norm``: the LayerNorm that follows the block; given, returns (x,
    norm(x)) instead of x.

    Each residual add and the LayerNorm after it (ln2, then ``norm``) are
    one ``add_layer_norm``: one launch of kernel 10 on a CUDA device
    without a gradient. Without a tensor-parallel plan and with the dropout
    inert, the product's bias goes into the same call."""
    tp, n = _block_tokens(layer, x, n_tokens)
    rate = cfg.hidden_dropout_prob
    hidden_generator = generator
    if tp is not None and tp.seq_parallel:
        hidden_generator = tp_generator
    split = tp is None and (deterministic or rate == 0.0)

    def product(module, h):
        """(t, b): module(h) = t + b, b the bias still to add, or None."""
        if split and isinstance(module, Linear):
            return linear(h, module.kernel), module.bias
        return dropout(_row_parallel(module, h, tp, n), rate,
                       generator=hidden_generator,
                       deterministic=deterministic), None

    attn = attn.transpose(1, 2).reshape(x.shape[0], n, -1)
    x, y = _add_norm(x, *product(layer.attn_out, attn), layer.ln2)
    if tp is not None:
        y = tp.enter(y, n)
    t, b = product(layer.mlp_out, gelu_exact(layer.mlp_in(y)))
    if norm is None:
        return x + (t if b is None else t + b.to(t.dtype))
    return _add_norm(x, t, b, norm)


def _add_norm(x: torch.Tensor, t: torch.Tensor, b: Optional[torch.Tensor],
              norm: LayerNorm):
    """(s, norm(s)), s = x + (t + b)."""
    return add_layer_norm(x, t, b, norm.scale, norm.bias, eps=norm.eps)


def _row_parallel(module, x: torch.Tensor, tp, n: int) -> torch.Tensor:
    """``module(x)``; under tensor parallelism the partial products are
    reduced over "model" before the bias is added, once."""
    if tp is None:
        return module(x)
    y = tp.exit(linear(x, module.kernel), n)
    return y if module.bias is None else y + module.bias.to(y.dtype)


def _remat_layer(layer: EncoderLayer, x: torch.Tensor, cfg: ViTConfig, *,
                 attn_impl: str, deterministic: bool,
                 generator: Optional[torch.Generator],
                 tp_generator: Optional[torch.Generator] = None,
                 n_tokens: Optional[int] = None) -> torch.Tensor:
    """encoder_layer under activation checkpointing. The first run draws
    from the generators as usual; a recompute rewinds them to the states
    the block started from, draws the same masks, and puts them back."""
    generators = [g for g in (generator, tp_generator) if g is not None]
    start = [g.get_state() for g in generators]
    runs = [0]

    def run(x):
        runs[0] += 1
        replay = runs[0] > 1 and generators
        if replay:
            now = [g.get_state() for g in generators]
            for g, state in zip(generators, start):
                g.set_state(state)
        try:
            return layer(x, cfg, attn_impl=attn_impl,
                         deterministic=deterministic, generator=generator,
                         tp_generator=tp_generator, n_tokens=n_tokens)
        finally:  # also when the recompute stops early
            if replay:
                for g, state in zip(generators, now):
                    g.set_state(state)

    return checkpoint(run, x, use_reentrant=False)


def vit_encode(model: ViT, x: torch.Tensor, *, attn_impl: str,
               deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Encoder blocks + final LayerNorm over embedded tokens, with the
    config's token merging (merge after each block, final LayerNorm, then
    unmerge) and remat (only where a gradient is taken), and the blocks'
    tensor and sequence parallelism."""
    cfg = model.cfg
    remat = cfg.remat and torch.is_grad_enabled()
    tp = getattr(model.layers[0], "tp", None) if len(model.layers) else None
    sp = tp is not None and tp.seq_parallel
    if sp and cfg.token_merge_r:
        raise ValueError("token merging needs every token of the sequence; "
                         "it does not compose with sequence parallelism")
    tp_generator = None
    if tp is not None and not deterministic:
        tp_generator = tp.fork(generator)
    n = x.shape[1]
    if sp:
        x = tp.scatter(x)
    state = (init_merge_state(x.shape[0], x.shape[1], x.device)
             if cfg.token_merge_r else None)
    for layer in model.layers:
        kwargs = dict(attn_impl=attn_impl, deterministic=deterministic,
                      generator=generator, tp_generator=tp_generator,
                      n_tokens=n)
        x = (_remat_layer(layer, x, cfg, **kwargs) if remat
             else layer(x, cfg, **kwargs))
        if state is not None:
            x, state = merge_step(x, state, cfg.token_merge_r)
    if sp:
        x = tp.gather(x, n)
    x = model.final_ln(x)
    return x if state is None else unmerge(x, state)


def vit_cut_step(model: ViT, i: int, x: torch.Tensor, state=None,
                 attn: Optional[torch.Tensor] = None):
    """Piece i of the inference encoder cut at its attention calls (the
    config's token merging; no dropout, parallelism or remat). Piece 0
    takes embedded tokens x and starts the merge state; piece i > 0 runs
    block i-1's half after attention on its attention output, and its
    merge. Then block i's half before attention, returning (x, state, qkv)
    for ``block_attention``, or, after the last block, the final LayerNorm
    and unmerge, returning the final token states as ``vit_encode`` does."""
    cfg = model.cfg
    last = i == len(model.layers)
    normed = None
    if i == 0:
        state = (init_merge_state(x.shape[0], x.shape[1], x.device)
                 if cfg.token_merge_r else None)
    elif state is None:
        # Nothing lies between the block's residual and the next LayerNorm
        # (ToMe's merge would): encoder_layer_out gives both.
        x, normed = encoder_layer_out(
            model.layers[i - 1], x, attn, cfg,
            norm=model.final_ln if last else model.layers[i].ln1)
    else:
        x = encoder_layer_out(model.layers[i - 1], x, attn, cfg)
        x, state = merge_step(x, state, cfg.token_merge_r)
    if not last:
        return x, state, encoder_layer_qkv(model.layers[i], x, cfg,
                                           normed=normed)
    x = model.final_ln(x) if normed is None else normed
    return x if state is None else unmerge(x, state)


def vit_apply(model: ViT, images: torch.Tensor, *, attn_impl: str = "auto",
              dtype: torch.dtype = torch.float32, deterministic: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, H, W, C) images -> (B, N+1, hidden) final token states."""
    x = vit_embed(model, images, dtype=dtype, deterministic=deterministic,
                  generator=generator)
    return vit_encode(model, x, attn_impl=attn_impl,
                      deterministic=deterministic, generator=generator)


def vit_apply_from_patch_tokens(model: ViT, patch_tokens: torch.Tensor, *,
                                attn_impl: str = "auto",
                                dtype: torch.dtype = torch.float32,
                                deterministic: bool = True,
                                generator: Optional[torch.Generator] = None
                                ) -> torch.Tensor:
    """vit_apply from already projected (B, N, hidden) patch embeddings,
    such as the fused preprocessing's (``ops/fused_preproc.py``): CLS,
    position embeddings, dropout and the encoder as in vit_apply."""
    x = vit_embed_patch_tokens(model, patch_tokens, dtype=dtype,
                               deterministic=deterministic,
                               generator=generator)
    return vit_encode(model, x, attn_impl=attn_impl,
                      deterministic=deterministic, generator=generator)


def vit_apply_pipelined(model: ViT, images: torch.Tensor, pipe, *,
                        attn_impl: str = "auto",
                        dtype: torch.dtype = torch.float32,
                        deterministic: bool = True,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """vit_apply with the encoder run as a GPipe pipeline over the mesh's
    "stage" axis (``parallel/pipeline.py``); ``model.layers`` holds this
    stage's layers. The embedding and the final LayerNorm run outside the
    pipeline, on every stage. With dropout, each layer of each microbatch
    draws from a generator seeded from (the step's generator's seed,
    global layer, microbatch, data shard), as the TPU package folds its
    keys: the same distribution as without the pipeline, the bits of this
    schedule's own."""
    from visiontransformer_tpu_torch.parallel.pipeline import pipeline_apply
    from visiontransformer_tpu_torch.train.trainer import fold_seed

    cfg = model.cfg
    if cfg.token_merge_r:
        raise ValueError("token merging does not compose with the pipeline")
    x = vit_embed(model, images, dtype=dtype, deterministic=deterministic,
                  generator=generator)
    base = None if deterministic else generator.initial_seed()

    def layer_fn(y: torch.Tensor, microbatch: int) -> torch.Tensor:
        for j, layer in enumerate(model.layers):
            g = None
            if base is not None:
                seed = fold_seed(fold_seed(fold_seed(
                    base, pipe.first_layer + j), microbatch), pipe.data_rank)
                g = torch.Generator(device=y.device).manual_seed(seed)
            y = layer(y, cfg, attn_impl=attn_impl,
                      deterministic=deterministic, generator=g)
        return y

    return model.final_ln(pipeline_apply(x, layer_fn, pipe,
                                         list(model.layers.parameters())))
