"""Flash-attention contraction-shape sweep (round 3) on the GPU.

The port's counterpart of ``scripts/tune_flash3.py``: base-mode attention
with its schedule changed, one lever at a time.

  dualq / quadq  2 / 4 independent online-softmax chains (kernel 7,
                 ``flash_multiq``): on Hopper a chain is 64 query rows, one
                 wgmma M; a warpgroup runs two, one chain's softmax while
                 the other's products run, and quadq orders the products
                 of a block's two warpgroups ping-pong, so that its four
                 chains interleave;
  pvT            O^T = V^T P^T (kernel 8, ``flash_pvt``): the 64 features
                 on wgmma's M, the queries on its N, P^T through shared
                 memory; O^T lands as (bh, 64, N);
  dualq_pvT      both (kernel 9, ``flash_dualq_pvt``): pvT with two
                 chains a warpgroup.

Every case runs one design ("wgmma_tma", ``chains_path``: warpgroups of
64-row chains on wgmma products, K and V by TMA from a producer warp), so
"1 chain" lines (kernel 6 in base mode at the same key tiles: three
warpgroups a block at 64-key tiles, two at 32) differ from each case by
its lever alone. Each label ends with its design in brackets. Key tiles
are 32 and 64 keys. The transposed cases are timed as the kernel alone
(the (bh, N, 64) view of its output) and with the transpose to a
contiguous (bh, N, 64). Each case
prints its time, TFLOP/s (4·BH·N²·d / t) and its error against the
production kernel (kernel 1, ``flash_attention``); the sweep ends with the
best variant against the production kernel.

    python -m visiontransformer_tpu_torch.scripts.tune_flash3 [N] [bh] [--device cpu]

Defaults N = 1025, bh = 192, d = 64, bf16. ``--device cpu`` runs the plain
versions on the host; without it the sweep needs CUDA and raises.
"""

from __future__ import annotations

import sys

import torch

from visiontransformer_tpu_torch.ops.flash_variants import (
    CHAIN_BLOCK_KS,
    chains_path,
    flash_dualq_pvt,
    flash_multiq,
    flash_pvt,
    flash_variant,
    variant_path,
)
from visiontransformer_tpu_torch.scripts import sweep

# name -> (kernel, its schedule arguments, chains, computed transposed)
KERNELS = {
    "dualq": (flash_multiq, {"chains": 2}, 2, False),
    "quadq": (flash_multiq, {"chains": 4}, 4, False),
    "pvT": (flash_pvt, {}, 1, True),
    "dualq_pvT": (flash_dualq_pvt, {}, 2, True),
}


def main(argv=None) -> int:
    with torch.no_grad():
        args, device, q, k, v, ref = sweep.setup(argv, __doc__)
        base = sweep.references(q, k, v, args, device)
        for block_k in CHAIN_BLOCK_KS:
            run = lambda: flash_variant(q, k, v, mode="base", block_k=block_k)
            err = sweep.rel_err(run(), ref)
            sweep.report(f"1 chain (base, block_k={block_k}) "
                         f"[{variant_path('base', block_k)}]",
                         sweep.timed(run, device), args.n, args.bh)
            sweep.print_err(err)
        best = {}
        for name, (kernel, schedule, chains, transposed) in KERNELS.items():
            for block_k in CHAIN_BLOCK_KS:
                run = lambda: kernel(q, k, v, block_k=block_k, **schedule)
                err = sweep.rel_err(run(), ref)
                label = (f"{name} (block_k={block_k}) "
                         f"[{chains_path(chains, transposed, block_k)}]")
                best[label] = sweep.timed(run, device)
                sweep.report(label, best[label], args.n, args.bh)
                if transposed:
                    sweep.report(f"{label} + transpose",
                                 sweep.timed(lambda: run().contiguous(),
                                             device), args.n, args.bh)
                sweep.print_err(err)
    top = min(best, key=best.get)
    print(f"\nbest variant: {top}  {best[top] * 1e3:.4f} ms "
          f"({base / best[top]:.2f}x the production kernel)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
