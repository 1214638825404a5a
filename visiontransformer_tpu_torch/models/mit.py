"""MiT (Mix Transformer), SegFormer's hierarchical encoder: the TPU
package's ``models/mit.py``.

Four stages, each an overlapping patch embedding (a 7x7 stride-4 conv,
then 3x3 stride-2 ones, padded k // 2 on each side as HF's
``SegformerOverlapPatchEmbeddings`` pads: not XLA's SAME, which pads (1, 2)
for k = 7 at stride 4 on 224), a LayerNorm, transformer blocks and a final
LayerNorm. A block is

- efficient attention: q from the tokens; k and v from the tokens
  spatially reduced by an r x r stride-r conv and a LayerNorm (sr > 1), so
  stage 1 attends 3,136 queries to 49 keys at 224^2 (65,536 to 1,024 at
  1024^2). The core goes through the attention dispatch
  (``ops/attention.py``, ``attn_impl``): with no gradient to take,
  ``"flash"``, and ``"auto"`` on a CUDA tensor, run kernel 1
  (``ops/flash_attention.py``), which takes Nk ≠ Nq; its logits and
  softmax are fp32 inside the kernel, a deliberate difference from the TPU
  package, which runs no Pallas kernel here, that lies closer to an fp32
  forward. ``"eager"``, ``"auto"`` on the CPU and every call that needs a
  gradient keep the TPU package's eager order: logits in the compute
  dtype times the scale cast to that dtype, the softmax in fp32 and cast
  back, the product with v;
- Mix-FFN: fc1, the 3x3 depthwise conv (MiT's only positional signal),
  exact GELU, fc2.

Every LayerNorm has eps 1e-5 (torch's default, which HF's encoder uses).
The tokens of a stage are (B, H·W, C), row-major over (H, W) as the TPU
package's ``x.reshape(b, h * w, d)`` of NHWC orders them; the convs see
them as NCHW through ``tokens.transpose(1, 2).reshape(B, C, H, W)`` (a
view whose memory is channels_last) and give them back by
``flatten(2).transpose(1, 2)``. The encoder's parameters are the TPU
package's tree under its names (``stages / i / blocks / j / attn / q``),
read by the tree helpers of ``models/unet.py``, which take the W8A8 form
where a layer holds ``kernel_q``.

Spans (``utils/spans.py``): the ranges ``mit.attention.<stage>`` (stages 1
to 4, the attention core alone: q, k, v in, its output out),
``mit.reduce`` (the reduction conv and its LayerNorm) and ``mit.ffn``
(Mix-FFN); the counters ``mit.attention_flash`` and ``mit.attention_eager``,
one a call of the core by the path it took.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from visiontransformer_tpu_torch.models.unet import (
    _depthwise,
    conv,
    linear,
)
from visiontransformer_tpu_torch.nn.layers import (
    conv2d_init,
    depthwise_init,
    layer_norm,
    trunc_normal,
)
from visiontransformer_tpu_torch.ops.attention import (
    multi_head_attention,
    resolve_implementation,
)
from visiontransformer_tpu_torch.utils.spans import count, ranged

# SegFormer's table 6: per-stage widths, depths, heads and KV
# spatial-reduction ratios (the TPU package's tuples).
MIT_PRESETS = {
    "mit_b0": ((32, 64, 160, 256), (2, 2, 2, 2), (1, 2, 5, 8), (8, 4, 2, 1)),
    "mit_b1": ((64, 128, 320, 512), (2, 2, 2, 2), (1, 2, 5, 8), (8, 4, 2, 1)),
    "mit_b2": ((64, 128, 320, 512), (3, 4, 6, 3), (1, 2, 5, 8), (8, 4, 2, 1)),
    "mit_b3": ((64, 128, 320, 512), (3, 4, 18, 3), (1, 2, 5, 8), (8, 4, 2, 1)),
    "mit_b4": ((64, 128, 320, 512), (3, 8, 27, 3), (1, 2, 5, 8), (8, 4, 2, 1)),
    "mit_b5": ((64, 128, 320, 512), (3, 6, 40, 3), (1, 2, 5, 8), (8, 4, 2, 1)),
}

LN_EPS = 1e-5
_MLP_RATIO = 4
_ATTENTION_RANGES = tuple(f"mit.attention.{i}" for i in range(1, 5))


def _linear_init(generator, cin: int, cout: int) -> dict:
    return {"kernel": trunc_normal((cin, cout), generator),
            "bias": torch.zeros(cout)}


def _layer_norm_init(dim: int) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def _norm(params, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, params["scale"], params["bias"], eps=LN_EPS)


def _to_map(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H·W, C) tokens -> the (B, C, H, W) map, a view."""
    return tokens.transpose(1, 2).reshape(tokens.shape[0], -1, h, w)


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H·W, C), row-major over (H, W)."""
    return x.flatten(2).transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _scale(hd: int, dtype: torch.dtype) -> float:
    """The TPU package's logit scale, hd ** -0.5 in fp32 cast to the
    compute dtype, as a Python number: the product with it rounds once in
    that dtype, as the TPU package's does, and no tensor is copied to the
    card (a host-to-device copy would wait for the card at every call)."""
    return float(torch.tensor(np.float32(hd) ** np.float32(-0.5)).to(dtype))


def _attn_init(generator, dim: int, sr: int) -> dict:
    params = {name: _linear_init(generator, dim, dim)
              for name in ("q", "k", "v", "proj")}
    if sr > 1:
        params["sr"] = conv2d_init(generator, dim, dim, sr)
        params["sr_ln"] = _layer_norm_init(dim)
    return params


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               attn_impl: str) -> torch.Tensor:
    """(B, heads, Nq, hd) q against (B, heads, Nk, hd) k and v: kernel 1
    where the dispatch takes the flash path and no gradient is needed, the
    TPU package's eager order otherwise (module docstring)."""
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if not needs_grad and resolve_implementation(attn_impl, q) == "flash":
        count("mit.attention_flash")
        return multi_head_attention(q, k, v, implementation="flash")
    count("mit.attention_eager")
    logits = torch.matmul(q, k.transpose(-1, -2)) * _scale(q.shape[-1],
                                                            q.dtype)
    attn = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(attn, v)


def _attn_apply(params, x: torch.Tensor, h: int, w: int, heads: int,
                sr: int, stage: int = 0,
                attn_impl: str = "auto") -> torch.Tensor:
    """Efficient self-attention on (B, H·W, C) tokens of stage
    ``stage`` (0-based)."""
    b, n, d = x.shape
    hd = d // heads
    q = linear(params["q"], x)
    kv = x
    if sr > 1:
        with ranged("mit.reduce"):
            kv = _norm(params["sr_ln"], _to_tokens(
                conv(params["sr"], _to_map(x, h, w), stride=sr)))
    m = kv.shape[1]
    k = linear(params["k"], kv)
    v = linear(params["v"], kv)
    q = q.reshape(b, n, heads, hd).transpose(1, 2)
    k = k.reshape(b, m, heads, hd).transpose(1, 2)
    v = v.reshape(b, m, heads, hd).transpose(1, 2)
    with ranged(_ATTENTION_RANGES[stage]):
        out = _attention(q, k, v, attn_impl)
    return linear(params["proj"], out.transpose(1, 2).reshape(b, n, d))


def _mixffn_init(generator, dim: int) -> dict:
    hidden = dim * _MLP_RATIO
    return {"fc1": _linear_init(generator, dim, hidden),
            "dw": depthwise_init(generator, hidden, 3),
            "fc2": _linear_init(generator, hidden, dim)}


def _mixffn_apply(params, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    y = _depthwise(params["dw"], _to_map(linear(params["fc1"], x), h, w))
    return linear(params["fc2"], _to_tokens(F.gelu(y, approximate="none")))


def _block_init(generator, dim: int, sr: int) -> dict:
    return {"ln1": _layer_norm_init(dim),
            "attn": _attn_init(generator, dim, sr),
            "ln2": _layer_norm_init(dim),
            "ffn": _mixffn_init(generator, dim)}


def _block_apply(params, x: torch.Tensor, h: int, w: int, heads: int,
                 sr: int, stage: int = 0,
                 attn_impl: str = "auto") -> torch.Tensor:
    x = x + _attn_apply(params["attn"], _norm(params["ln1"], x), h, w,
                        heads, sr, stage, attn_impl)
    y = _norm(params["ln2"], x)
    with ranged("mit.ffn"):
        y = _mixffn_apply(params["ffn"], y, h, w)
    return x + y


def mit_encoder_init(generator: torch.Generator, encoder_name: str,
                     in_channels: int = 3) -> dict:
    """The encoder's parameter tree (the TPU package's distributions:
    trunc-normal(0.02) kernels, zero biases, LayerNorm ones and zeros;
    conv kernels OIHW, linear kernels (in, out))."""
    dims, depths, _, srs = MIT_PRESETS[encoder_name]
    stages = []
    cin = in_channels
    for i, (dim, depth, sr) in enumerate(zip(dims, depths, srs)):
        stages.append({
            "embed": conv2d_init(generator, cin, dim, 7 if i == 0 else 3),
            "embed_ln": _layer_norm_init(dim),
            "blocks": [_block_init(generator, dim, sr) for _ in range(depth)],
            "norm": _layer_norm_init(dim)})
        cin = dim
    return {"stages": stages}


def mit_encoder_apply(params, x: torch.Tensor, encoder_name: str,
                      attn_impl: str = "auto") -> List[torch.Tensor]:
    """NCHW images -> the [OS-4, OS-8, OS-16, OS-32] NCHW feature maps.
    ``attn_impl``: the attention dispatch's name (module docstring)."""
    _, _, heads, srs = MIT_PRESETS[encoder_name]
    feats = []
    for i, stage in enumerate(params["stages"]):
        k = 7 if i == 0 else 3
        x = conv(stage["embed"], x, stride=4 if i == 0 else 2,
                 padding=(k // 2, k // 2))
        h, w = x.shape[2], x.shape[3]
        tokens = _norm(stage["embed_ln"], _to_tokens(x))
        for block in stage["blocks"]:
            tokens = _block_apply(block, tokens, h, w, heads[i], srs[i], i,
                                  attn_impl)
        x = _to_map(_norm(stage["norm"], tokens), h, w)
        feats.append(x)
    return feats
