"""Flash-attention inference-variant sweep (round 2) on the GPU.

The port's counterpart of ``scripts/tune_flash2.py``: one lever at a time,
which softmax form and which key-tile width move the forward's time.
Every case is kernel 6 (``csrc/flash_variants.cu``, ``flash_variant``):

  base     p = exp(s - m), the full-accuracy expf
  bf16exp  s - m rounded to bf16, exp computed in bf16 (two per instruction)
  exp2     p = exp2((s - m) * log2 e), log2 e applied after the subtraction

at key tiles of 32, 64 and 128 keys (the running max is updated once per
tile), every case on one design ("wgmma_tma", ``variant_path``:
warpgroups of 64 query rows on Hopper's warpgroup products, K and V by
TMA), so that the cases differ by the one lever. The key tiles are
wgmma's n of S = Q·Kᵀ; the warpgroups an SM runs follow from each tile's
registers (four at 32 keys, three at 64, two at 128). Each case prints its time, TFLOP/s
(4·BH·N²·d / t) and its error against the production kernel (kernel 1,
``flash_attention``), beside the production kernel's and SDPA's lines;
its label ends with the design in brackets.

    python -m visiontransformer_tpu_torch.scripts.tune_flash2 [N] [bh] [--device cpu]

Defaults N = 1025, bh = 192, d = 64, bf16. ``--device cpu`` runs the plain
versions on the host; without it the sweep needs CUDA and raises.
"""

from __future__ import annotations

import sys

import torch

from visiontransformer_tpu_torch.ops.flash_variants import (
    MODES,
    VARIANT_BLOCK_KS,
    flash_variant,
    variant_path,
)
from visiontransformer_tpu_torch.scripts import sweep


def main(argv=None) -> int:
    with torch.no_grad():
        args, device, q, k, v, ref = sweep.setup(argv, __doc__)
        sweep.references(q, k, v, args, device)
        for mode in MODES:
            for block_k in VARIANT_BLOCK_KS:
                run = lambda: flash_variant(q, k, v, mode=mode,
                                            block_k=block_k)
                err = sweep.rel_err(run(), ref)
                sweep.report(f"{mode} (block_k={block_k}) "
                             f"[{variant_path(mode, block_k)}]",
                             sweep.timed(run, device), args.n, args.bh)
                sweep.print_err(err)
    return 0


if __name__ == "__main__":
    sys.exit(main())
