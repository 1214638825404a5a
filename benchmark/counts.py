"""Operations, bytes and peak rates: the yardstick's arithmetic.

Every count follows from a call's shapes, never from a measurement. Each
input byte is read once and each output byte written once, whatever a
kernel reads again. The attention bounds are PERF.md's (section 6, kernel
table); the epilogue's operations are the ones the fused upsample + argmax
needs: the H stage (2 multiplies, 1 add) once per (image, output row, grid
column, class), the W stage (2 multiplies, 1 add) and the argmax compare
once per output pixel and class.
"""

from __future__ import annotations

# Published H100 rates (NVIDIA data sheets, dense, no sparsity): memory
# bytes/s, bf16 tensor-core operations/s, fp32 operations/s outside the
# tensor cores. The SXM part unless the card's name says PCIe.
PEAKS = {
    "sxm": {"bytes": 3.35e12, "bf16": 989e12, "fp32": 67e12},
    "pcie": {"bytes": 2.0e12, "bf16": 756e12, "fp32": 51e12},
}


def peaks_for(device_name: str) -> dict:
    return PEAKS["pcie" if "PCIe" in device_name else "sxm"]


def least_seconds(peaks: dict, n_bytes: float, n_ops: float,
                  op_type: str) -> float:
    """The least time the chip could take: max(bytes / bandwidth,
    operations / peak rate of ``op_type``)."""
    return max(n_bytes / peaks["bytes"], n_ops / peaks[op_type])


def vitseg_forward_flops(cfg: dict) -> float:
    """Multiply-adds x 2 of one image through the ViT segmentation forward:
    patch embedding, every encoder layer (QKV, Q.K^T, P.V, output
    projection, MLP) and the conv head (3x3 then 1x1). LayerNorm, GELU,
    softmax and the upsample are left out: they are not products."""
    p, size = cfg["patch_size"], cfg["image_size"]
    d, m = cfg["hidden_size"], cfg["intermediate_size"]
    grid = size // p
    patches = grid * grid
    n = patches + 1
    patch_dim = p * p * cfg["num_channels"]
    embed = 2 * patches * patch_dim * d
    layer = (2 * n * d * 3 * d          # fused QKV projection
             + 2 * 2 * n * n * d        # Q.K^T and P.V over all heads
             + 2 * n * d * d            # attention output projection
             + 2 * 2 * n * d * m)       # MLP in and out
    head = (2 * patches * 9 * d * cfg["head_channels"]
            + 2 * patches * cfg["head_channels"] * cfg["num_classes"])
    return float(embed + cfg["num_hidden_layers"] * layer + head)


def attention_fwd_counts(bh: int, n: int, d: int, elem_bytes: int = 2):
    """(bytes, operations) of one attention forward over bh heads of n
    tokens and head size d: Q, K, V read and O written once; Q.K^T and P.V
    at 2 operations a multiply-add."""
    return 4.0 * bh * n * d * elem_bytes, 4.0 * bh * n * n * d


def upsample_argmax_counts(b: int, h: int, w: int, c: int, out_h: int,
                           out_w: int, in_bytes: int = 2,
                           out_bytes: int = 1):
    """(bytes, operations) of the fused bilinear upsample + argmax from
    (b, h, w, c) grid logits to (b, out_h, out_w) class ids: the logits
    read, the masks written, and the two axes' tap tables (int32 index
    pairs and fp32 weight pairs, 16 bytes an output row or column)."""
    n_bytes = (b * h * w * c * in_bytes + b * out_h * out_w * out_bytes
               + 16 * (out_h + out_w))
    n_ops = 3 * b * out_h * w * c + 4 * b * out_h * out_w * c
    return float(n_bytes), float(n_ops)
