"""What the two flash-attention sweeps share: arguments, inputs, timing and
the reference lines (the production kernel and SDPA)."""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from visiontransformer_tpu_torch.device import resolve_device
from visiontransformer_tpu_torch.ops.flash_attention import flash_attention
from visiontransformer_tpu_torch.ops.flash_variants import HEAD_DIM

ITERS = 12   # launches per timed round
ROUNDS = 4   # timed rounds; the best counts
LABEL = 48   # width of a case's label


def parse(argv: Optional[List[str]], description: str) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("n", nargs="?", type=int, default=1025,
                   help="sequence length N (default 1025)")
    p.add_argument("bh", nargs="?", type=int, default=192,
                   help="batch x heads (default 192)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain versions)")
    return p.parse_args(argv)


def inputs(n: int, bh: int, device: torch.device):
    """q, k, v of shape (bh, n, 64), bf16, standard normals from
    default_rng(0), as the JAX sweeps make them."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.standard_normal((bh, n, HEAD_DIM)).astype(
        np.float32)).to(device=device, dtype=torch.bfloat16)
        for _ in range(3)]


def header(args, device: torch.device) -> None:
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain versions, host clock)")
    print(f"N={args.n} bh={args.bh} d={HEAD_DIM} bf16 on {name}: "
          f"{ITERS} launches per round, best of {ROUNDS}", flush=True)


def timed(fn: Callable[[], object], device: torch.device) -> float:
    """Seconds per call: ITERS calls back to back between CUDA events
    (the host clock on the CPU), best of ROUNDS, after a warm-up call."""
    fn()
    best = float("inf")
    for _ in range(ROUNDS):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                fn()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                fn()
            seconds = time.perf_counter() - t0
        best = min(best, seconds / ITERS)
    return best


def report(label: str, seconds: float, n: int, bh: int) -> None:
    flops = 4 * bh * n * n * HEAD_DIM
    print(f"{label:<{LABEL}s} {seconds * 1e3:9.4f} ms  "
          f"{flops / seconds / 1e12:7.1f} TFLOP/s", flush=True)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|, as the JAX sweeps print it."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-9))


def print_err(err: float) -> None:
    print(f"{'':<{LABEL}s} rel err vs production: {err:.2e}", flush=True)


def production(q, k, v) -> torch.Tensor:
    """Kernel 1, the port's inference flash attention, on (bh, n, d)."""
    return flash_attention(q[None], k[None], v[None])[0]


def references(q, k, v, args, device) -> float:
    """Print the production kernel's line and SDPA's (a yardstick, timed
    only); returns the production kernel's seconds per call."""
    base = timed(lambda: production(q, k, v), device)
    report("production kernel (flash_attention)", base, args.n, args.bh)
    sdpa = timed(lambda: F.scaled_dot_product_attention(q[None], k[None],
                                                        v[None]), device)
    report("F.scaled_dot_product_attention", sdpa, args.n, args.bh)
    return base


def setup(argv, description):
    """(args, device, q, k, v, production output): the device resolves to
    CUDA unless ``--device cpu`` was given, and raises without it."""
    args = parse(argv, description)
    device = resolve_device(args.device)
    q, k, v = inputs(args.n, args.bh, device)
    header(args, device)
    return args, device, q, k, v, production(q, k, v)
