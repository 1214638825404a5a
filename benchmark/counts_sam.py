"""Operations and bytes of SAM with a box prompt: the yardstick's arithmetic
for the SAM cell, from the configuration's ``hf_config`` alone, never from
a measurement (``counts.py`` holds the peaks).

The forward's products, at 2 operations a multiply-add, of one image at
the configuration's size (g = image / patch tokens a side):

- the 16 x 16 patch embedding over g^2 patches;
- each block over its tokens T (windowed: the grid zero-padded to a
  multiple of the window, T = (ceil(g / S) S)^2, as SAM computes them;
  global: T = g^2): qkv and the output product on T tokens, Q.K^T and P.V
  a window (4 · T · S^2 · C; global 4 · g^4 · C), the rel_h and rel_w
  products (2 · 2 · T · side · C, side the window or grid), and the MLP on
  the g^2 tokens of the grid;
- the neck's 1x1 and 3x3 convs;
- the mask decoder: each two-way block's self-attention of the 7 tokens,
  its two cross-attentions against the g^2 image tokens at half width
  (q, k, v and output products and both attention products), its MLP on
  the tokens; the final token-to-image attention; the two transposed
  convs; mask token 0's hypernetwork MLP and its product with the
  upscaled embedding.

LayerNorm, GELU, softmax, the Fourier encodings, the IoU head (not run)
and the resize of the mask are left out: they are not products, or not
computed.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

# The port's ranges around the attention core (``models/sam.py``).
ATTENTION_RANGES = ("sam.attention.window", "sam.attention.global")
TOKENS = 7  # the IoU token, four mask tokens and a box's two corners


def grid(hf: dict) -> int:
    v = hf["vision_config"]
    return v["image_size"] // v["patch_size"]


def attention_shapes(hf: dict, batch: int
                     ) -> Dict[str, Tuple[int, int, int, int, int]]:
    """{range: (B·windows·heads, N, d, kh, kw)} of the encoder's two kinds
    of attention at a batch of images: a window's S x S tokens, or the
    g x g grid."""
    v = hf["vision_config"]
    g, s, heads = grid(hf), v["window_size"], v["num_attention_heads"]
    d = v["hidden_size"] // heads
    windows = math.ceil(g / s) ** 2
    return {"sam.attention.window": (batch * windows * heads, s * s, d, s, s),
            "sam.attention.global": (batch * heads, g * g, d, g, g)}


def attention_fwd_counts(bh: int, n: int, d: int, kh: int, kw: int,
                         elem_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of one biased attention forward over bh heads of
    n = kh · kw tokens of size d: Q, K, V read and O written once, and the
    bias's rel_h (n x kh) and rel_w (n x kw) read once a head; Q.K^T and
    P.V at 2 operations a multiply-add."""
    return (float(bh * (4 * n * d + n * (kh + kw)) * elem_bytes),
            4.0 * bh * n * n * d)


def _attention_block(n_q: int, n_k: int, c: int, inner: int) -> float:
    """A decoder attention: q over n_q tokens, k and v over n_k, the
    output product over n_q, and Q.K^T and P.V at the inner width."""
    return (2.0 * n_q * c * inner + 2.0 * 2 * n_k * c * inner
            + 2.0 * n_q * inner * c + 4.0 * n_q * n_k * inner)


def forward_flops(cfg: dict) -> float:
    """Operations of one image through SAM's forward with a box prompt
    (module docstring)."""
    hf = cfg["hf_config"]
    v, m = hf["vision_config"], hf["mask_decoder_config"]
    c, g, p = v["hidden_size"], grid(hf), v["patch_size"]
    s, mlp, o = v["window_size"], v["mlp_dim"], v["output_channels"]
    n = g * g
    total = 2.0 * n * (v["num_channels"] * p * p) * c          # patches
    for i in range(v["num_hidden_layers"]):
        if i in v["global_attn_indexes"]:
            t, side, attention = n, g, 4.0 * n * n * c
        else:
            t, side = (math.ceil(g / s) * s) ** 2, s
            attention = 4.0 * t * s * s * c
        total += (2.0 * t * c * 3 * c + 2.0 * t * c * c + attention
                  + 2.0 * 2 * t * side * c + 2.0 * 2 * n * c * mlp)
    total += 2.0 * n * c * o + 2.0 * n * o * o * 9              # neck
    inner = o // m["attention_downsample_rate"]
    block = (_attention_block(TOKENS, TOKENS, o, o)            # self
             + _attention_block(TOKENS, n, o, inner)           # token->image
             + 2.0 * 2 * TOKENS * o * m["mlp_dim"]             # MLP
             + _attention_block(n, TOKENS, o, inner))          # image->token
    total += m["num_hidden_layers"] * block
    total += _attention_block(TOKENS, n, o, inner)             # final
    total += 2.0 * n * o * (o // 4) * 4                        # upscale 1
    total += 2.0 * (4 * n) * (o // 4) * (o // 8) * 4           # upscale 2
    total += 2.0 * 2 * o * o + 2.0 * o * (o // 8)              # hypernet
    total += 2.0 * (16 * n) * (o // 8)                         # mask
    return total
