"""Operations and bytes of SegFormer at a crop: the yardstick's arithmetic
for the segformer cells, from the configuration's ``hf_config`` and the
crop alone, never from a measurement (``counts.py`` holds the peaks and
the ViT's counts).

The forward's products, at 2 operations a multiply-add, of one image:

- each stage's overlapping patch embedding, a k x k stride-s conv padded
  k // 2 (7/4 then 3/2: stage i holds (crop / 4 / 2^i)^2 tokens);
- each block: the q, k, v and output projections, the r x r stride-r
  reduction conv (r > 1; k and v then over N / r^2 tokens), Q.K^T and P.V
  over all heads (4·N·Nk·C), Mix-FFN's fc1 and fc2 (4C wide) and its 3x3
  depthwise conv;
- the decoder: each level's projection onto the decoder width at its own
  resolution, the fuse of the four at OS-4, the classifier.

LayerNorm, GELU, softmax, BatchNorm, ReLU and the resizes are left out:
they are not products.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# The port's ranges around the attention core of each stage
# (``models/mit.py``), stage 1 first.
ATTENTION_RANGES = tuple(f"mit.attention.{i}" for i in range(1, 5))


def stage_grids(hf: dict, crop: int) -> List[int]:
    """Side of each stage's token grid at a square crop."""
    sides, side = [], crop
    for k, s in zip(hf["patch_sizes"], hf["strides"]):
        side = (side + 2 * (k // 2) - k) // s + 1
        sides.append(side)
    return sides


def attention_shapes(hf: dict, crop: int, batch: int
                     ) -> Dict[str, Tuple[int, int, int, int]]:
    """{range: (B·heads, Nq, Nk, head dim)} of each stage's attention at a
    batch of square crops."""
    out = {}
    for name, side, c, heads, r in zip(
            ATTENTION_RANGES, stage_grids(hf, crop), hf["hidden_sizes"],
            hf["num_attention_heads"], hf["sr_ratios"]):
        reduced = (side - r) // r + 1
        out[name] = (batch * heads, side * side, reduced * reduced,
                     c // heads)
    return out


def attention_fwd_counts(bh: int, n_q: int, n_k: int, d: int,
                         elem_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of one attention forward over bh heads of n_q
    queries and n_k keys of size d: Q and O at n_q rows, K and V at n_k,
    each read or written once; Q.K^T and P.V at 2 operations a
    multiply-add."""
    return (2.0 * bh * (n_q + n_k) * d * elem_bytes,
            4.0 * bh * n_q * n_k * d)


def forward_flops(cfg: dict) -> float:
    """Operations of one image through the SegFormer forward at the
    configuration's crop (module docstring)."""
    hf, crop = cfg["hf_config"], cfg["crop_size"]
    sides = stage_grids(hf, crop)
    total, cin = 0.0, hf["num_channels"]
    for i, (side, c, depth, r, k, ratio) in enumerate(zip(
            sides, hf["hidden_sizes"], hf["depths"], hf["sr_ratios"],
            hf["patch_sizes"], hf["mlp_ratios"])):
        n = side * side
        total += 2.0 * n * c * k * k * cin                # patch embedding
        reduced = ((side - r) // r + 1) ** 2
        block = 2.0 * n * c * c * 2                       # q, output proj
        if r > 1:
            block += 2.0 * reduced * c * r * r * c        # reduction conv
        block += 2.0 * reduced * c * c * 2                # k, v
        block += 4.0 * n * reduced * c                    # Q.K^T, P.V
        hidden = ratio * c
        block += 2.0 * n * c * hidden * 2                 # fc1, fc2
        block += 2.0 * n * hidden * 9                     # depthwise 3x3
        total += depth * block
        cin = c
    e = hf["decoder_hidden_size"]
    n0 = sides[0] * sides[0]
    total += sum(2.0 * side * side * c * e
                 for side, c in zip(sides, hf["hidden_sizes"]))
    total += 2.0 * n0 * len(sides) * e * e                # fuse
    total += 2.0 * n0 * e * len(hf["id2label"])           # classifier
    return total
