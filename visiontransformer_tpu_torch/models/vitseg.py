"""ViT segmentation model: backbone + conv head + bilinear upsample.

Mirrors the TPU package's ``models/vitseg.py``: drop the CLS token, fold
the tokens to the (g, g) grid, Conv3×3(hidden→256) + ReLU +
Conv1×1(256→classes), then one bilinear upsample (align_corners=False) to
the output size. Activations are NHWC throughout, as in the TPU package.
``vitseg_apply`` with ``deterministic=False`` and a generator is the
training forward (dropout in the backbone, fp32 logits at the input size).
``MasksForward`` is the one masks forward, cut at its attention calls:
``vitseg_predict``, ``vitseg_predict_fused`` (the resize and normalize
folded into the patch embedding, ``ops/fused_preproc.py``), the serving
runner, its CUDA graphs and the exported program run it.
``vitseg_apply_pipelined`` runs the backbone's encoder as a GPipe pipeline
(``parallel/pipeline.py``); a model whose ``pipeline`` attribute the
trainer set takes that forward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from visiontransformer_tpu_torch.configs import ViTSegConfig
from visiontransformer_tpu_torch.models.vit import (
    ViT,
    block_attention,
    vit_apply,
    vit_apply_pipelined,
    vit_cut_step,
    vit_embed,
    vit_embed_patch_tokens,
)
from visiontransformer_tpu_torch.nn.layers import Conv2d
from visiontransformer_tpu_torch.ops.fused_preproc import (
    build_fused_embed,
    fused_resize_embed,
)
from visiontransformer_tpu_torch.ops.resize import resize_bilinear_mm
from visiontransformer_tpu_torch.ops.token_merge import MergeState
from visiontransformer_tpu_torch.ops.upsample_argmax import (
    upsample_argmax,
    upsample_argmax_plain,
)
from visiontransformer_tpu_torch.utils.spans import ranged

EPILOGUES = ("auto", "plain", "kernel")


class ViTSeg(nn.Module):
    family = "vitseg"

    def __init__(self, cfg: ViTSegConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ViT(cfg.vit)
        self.head_conv1 = Conv2d(cfg.vit.hidden_size, cfg.head_channels, 3)
        self.head_conv2 = Conv2d(cfg.head_channels, cfg.num_classes, 1)
        self.pipeline = None  # a parallel.pipeline.Pipeline in that mode

    def forward(self, images: torch.Tensor, *, attn_impl: str = "auto",
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.pipeline is not None:
            return vitseg_apply_pipelined(
                self, images, self.pipeline, attn_impl=attn_impl,
                deterministic=deterministic, generator=generator)
        return vitseg_apply(self, images, attn_impl=attn_impl,
                            deterministic=deterministic, generator=generator)


def set_token_merge_r(model: ViTSeg, r: int) -> ViTSegConfig:
    """Turn ToMe token merging on (r tokens merged per block) or off (0)
    in place, with the same weights; returns the new config."""
    model.backbone.cfg = dataclasses.replace(model.backbone.cfg,
                                             token_merge_r=r)
    model.cfg = dataclasses.replace(model.cfg, vit=model.backbone.cfg)
    return model.cfg


def vitseg_head_logits(model: ViTSeg, images: torch.Tensor, *,
                       attn_impl: str = "auto", deterministic: bool = True,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, g, g, classes) grid logits, in the
    compute dtype (before the upsample)."""
    tokens = vit_apply(model.backbone, images, attn_impl=attn_impl,
                       dtype=model.cfg.dtype, deterministic=deterministic,
                       generator=generator)
    return vitseg_head_from_tokens(model, tokens)


def vitseg_head_from_tokens(model: ViTSeg, tokens: torch.Tensor
                            ) -> torch.Tensor:
    """Final hidden states (B, N+1, hidden) -> grid logits (B, g, g,
    classes): drop CLS, fold to the grid, the conv head."""
    cfg = model.cfg
    g = cfg.vit.grid_size
    with ranged("vitseg.head"):
        features = tokens[:, 1:, :].reshape(tokens.shape[0], g, g,
                                            cfg.vit.hidden_size)
        x = torch.relu(model.head_conv1(features))
        return model.head_conv2(x)


def vitseg_apply(model: ViTSeg, images: torch.Tensor, *,
                 attn_impl: str = "auto", deterministic: bool = True,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, H, W, classes) fp32 logits, upsampled to
    the input size by ``resize_bilinear_mm`` in fp32."""
    x = vitseg_head_logits(model, images, attn_impl=attn_impl,
                           deterministic=deterministic, generator=generator)
    return resize_bilinear_mm(x.float(), (images.shape[1], images.shape[2]))


def vitseg_apply_pipelined(model: ViTSeg, images: torch.Tensor, pipe, *,
                           attn_impl: str = "auto",
                           deterministic: bool = True,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """vitseg_apply with the encoder as stage ``pipe.stage`` of a GPipe
    pipeline (``vit_apply_pipelined``); the head runs on every stage."""
    tokens = vit_apply_pipelined(model.backbone, images, pipe,
                                 attn_impl=attn_impl, dtype=model.cfg.dtype,
                                 deterministic=deterministic,
                                 generator=generator)
    x = vitseg_head_from_tokens(model, tokens)
    return resize_bilinear_mm(x.float(), (images.shape[1], images.shape[2]))


def vitseg_logits_nchw(model: ViTSeg, images_nchw: torch.Tensor,
                       **kwargs) -> torch.Tensor:
    """Torch-layout wrapper: (B, 3, H, W) in -> (B, C, H, W) logits out."""
    logits = vitseg_apply(model, images_nchw.permute(0, 2, 3, 1), **kwargs)
    return logits.permute(0, 3, 1, 2)


def vitseg_predict(model: ViTSeg, images: torch.Tensor, *,
                   out_size: Optional[Tuple[int, int]] = None,
                   epilogue: str = "auto", attn_impl: str = "auto",
                   mask_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, out_H, out_W) argmax class map in
    ``mask_dtype`` (int32, as the TPU package returns, or uint8, the
    serving path's type), with ONE bilinear upsample straight from the
    token grid to ``out_size``: ``MasksForward`` run eagerly.

    epilogue: "kernel" runs the fused upsample+argmax kernel
    (``ops/upsample_argmax.py``; its plain version on a CPU tensor), which
    reads the grid logits in the compute dtype and writes ``mask_dtype``
    itself; "plain" the interpolation products in fp32 then argmax; "auto"
    the kernel on a CUDA tensor and the plain form on the CPU. Both compute
    the same function."""
    return MasksForward(model, out_size or images.shape[1:3], mask_dtype,
                        attn_impl=attn_impl, epilogue=epilogue)(images)


class MasksForward(nn.Module):
    """vitseg's masks forward, (B, H, W, 3) images -> (B, out_H, out_W)
    masks in ``mask_dtype``, cut at its attention calls and before its
    epilogue for the serving runner's CUDA graphs; ``forward`` composes the
    pieces eagerly. ``attn_impl``, ``epilogue``: as ``vitseg_predict``'s.

    - segment 0: the /255 of uint8 images (float ones as they are), the
      embedding (with ``preproc``, ``vitseg_build_fused_preproc``'s
      constants, the fused preprocessing's), block 0's half before
      attention;
    - segment i (0 < i < layers): block i-1's half after attention, its
      merge (ToMe), block i's half before attention;
    - segment ``layers``: the last block's half after attention, its
      merge, the final LayerNorm, the unmerge, the conv head; the grid
      logits, contiguous.

    ``attention`` runs between two segments and ``epilogue`` after the
    last, through ``models/vit.py:multi_head_attention`` and
    ``upsample_argmax`` here, looked up at each call. A segment takes and
    returns a flat tuple of tensors, so that both can be static buffers:
    segment 0 takes (images,), segment i > 0 the previous one's outputs and
    the attention's; every segment but the last returns (x, qkv) and the
    merge state's tensors."""

    cut = True

    def __init__(self, model: ViTSeg, out_size: Tuple[int, int],
                 mask_dtype: torch.dtype, *, attn_impl: str = "auto",
                 epilogue: str = "auto", preproc: Optional[dict] = None):
        super().__init__()
        if epilogue not in EPILOGUES:
            raise ValueError(f"unknown epilogue {epilogue!r}; known: "
                             f"{EPILOGUES}")
        self.model, self.out_size = model, tuple(out_size)
        self.mask_dtype, self.preproc = mask_dtype, preproc
        self.attn_impl, self.epilogue_impl = attn_impl, epilogue
        self.count = len(model.backbone.layers) + 1

    def segment(self, i: int, inputs: tuple) -> tuple:
        vit, dtype = self.model.backbone, self.model.cfg.dtype
        if i == 0:
            (x,), state, attn = inputs, None, None
            if self.preproc is not None:
                x = vit_embed_patch_tokens(vit, fused_resize_embed(
                    self.preproc, x, dtype=dtype), dtype=dtype)
            else:
                if x.dtype == torch.uint8:
                    x = x.float() / 255.0
                x = vit_embed(vit, x, dtype=dtype)
        else:
            x, _, *state, attn = inputs
            state = MergeState(*state) if state else None
        out = vit_cut_step(vit, i, x, state, attn)
        if i == self.count - 1:
            # Contiguous here, in the graph, rather than in the epilogue's
            # eager launch.
            return (vitseg_head_from_tokens(self.model, out).contiguous(),)
        x, state, qkv = out
        return (x, qkv) + (() if state is None else tuple(state))

    def attention(self, outputs: tuple,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The attention of the block whose qkv view ``outputs`` holds,
        written into ``out`` if given."""
        return block_attention(outputs[1], self.model.cfg.vit,
                               attn_impl=self.attn_impl, out=out)

    def epilogue(self, outputs: tuple) -> torch.Tensor:
        grid, impl = outputs[0], self.epilogue_impl
        with ranged("vitseg.epilogue"):
            if impl == "kernel" or (impl == "auto" and grid.is_cuda):
                return upsample_argmax(grid, self.out_size,
                                       out_dtype=self.mask_dtype)
            return upsample_argmax_plain(grid, self.out_size,
                                         self.mask_dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        outputs = self.segment(0, (images,))
        for i in range(1, self.count):
            outputs = self.segment(i, outputs + (self.attention(outputs),))
        return self.epilogue(outputs)


def vitseg_build_fused_preproc(model: ViTSeg, *, in_size: int, mean, std,
                               input_scale: float = 1.0) -> dict:
    """The constants of ``vitseg_predict_fused`` for raw ``in_size``
    images (512 for the bench workload), on the model's device; the compute
    size is the backbone's (``cfg.vit.image_size``). ``input_scale`` =
    1/255 takes uint8 images."""
    pe = model.backbone.patch_embed
    return build_fused_embed(
        {"kernel": pe.kernel, "bias": pe.bias},
        patch_size=model.cfg.vit.patch_size, in_size=in_size,
        compute_size=model.cfg.vit.image_size, mean=mean, std=std,
        input_scale=input_scale, device=pe.kernel.device)


def vitseg_predict_fused(model: ViTSeg, consts: dict, raw: torch.Tensor, *,
                         out_size: Tuple[int, int], epilogue: str = "auto",
                         attn_impl: str = "auto",
                         mask_dtype: torch.dtype = torch.int32
                         ) -> torch.Tensor:
    """The serving forward with the preprocessing folded into the patch
    embedding: (B, in, in, 3) raw images (fp32 in [0, 1], or uint8 where
    the constants fold 1/255) -> (B, out_H, out_W) masks in
    ``mask_dtype``; the same function as resize -> normalize ->
    ``vitseg_predict`` up to floating-point association: ``MasksForward``
    with ``preproc=consts``. ``epilogue`` as in vitseg_predict."""
    return MasksForward(model, out_size, mask_dtype, attn_impl=attn_impl,
                        epilogue=epilogue, preproc=consts)(raw)
