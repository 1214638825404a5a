"""The flash-attention tuning-sweep kernels on Hopper, and their plain
versions.

Each kernel replaces a Pallas kernel of the JAX package's tuning scripts
and computes inference attention, softmax(Q·Kᵀ·d^-½)·V, at d = 64, online
over key tiles of ``block_k`` keys:

- kernel 6, ``scripts/tune_flash2.py:_variant_kernel`` →
  ``csrc/flash_variants.cu`` (``flash_variant``): three softmax forms
  (``mode``, see ``variant_plain``);
- kernel 7, ``scripts/tune_flash3.py:_multiq_kernel`` →
  ``csrc/flash_chains.cu`` (``flash_multiq``): 2 or 4 independent
  online-softmax chains over the same key tiles;
- kernel 8, ``_pvt_kernel`` → ``flash_pvt``: Oᵀ = Vᵀ·Pᵀ, stored as
  (…, 64, N);
- kernel 9, ``_dualq_pvt_kernel`` → ``flash_dualq_pvt``: both.

They feed the redesign of kernel 1 (``flash_attention``) and are run by the
sweeps ``visiontransformer_tpu_torch.scripts.tune_flash2`` and
``tune_flash3``, not by the model. Every instantiation runs one design on
the card, "wgmma_tma" (``variant_path``, ``chains_path``): consumer
warpgroups on ``wgmma`` products fed by a TMA ring from a producer warp,
``csrc/flash_variant_wgmma.cuh``. A chain there is 64 query rows, one
``wgmma`` M: kernels 6 and 8 run one a warpgroup, kernels 7 and 9 two, so
that the chains and the transpose are each the one difference from
kernel 6's rows form.

Inputs are (BH, N, 64) as the JAX scripts take them, or (B, H, N, 64);
the output has the input's shape. ``block_k`` is the kernel's key-tile
width and the plain version's chunk width, so both update the running max
at the same keys and round at the same places; rows per block, chains and
the transpose only schedule the work, and the plain versions ignore them.
A CPU tensor runs the plain version (fp32 or bf16); a CUDA tensor (bf16,
last dimension contiguous, strided views allowed) launches the kernel or
raises. The kernels read through TMA, which needs rows on 16-byte
boundaries and every stride of a dimension longer than 1 to be a positive
multiple of 16 bytes below 2^40 bytes; other views raise ``ValueError``
before a launch. Head dims other than 64 raise everywhere.
"""

from __future__ import annotations

import ctypes
import math

import torch

from visiontransformer_tpu_torch.ops import _build
from visiontransformer_tpu_torch.utils import spans
from visiontransformer_tpu_torch.ops.flash_attention import (
    _kernel_layout,
    _stream,
)

NEG_INF = -1e30
LOG2E = 1.4426950408889634
HEAD_DIM = 64
MODES = ("base", "bf16exp", "exp2")
VARIANT_BLOCK_KS = (32, 64, 128)  # key tiles kernel 6 is built for
CHAIN_BLOCK_KS = (32, 64)         # key tiles kernels 7-9 are built for
# (chains, transposed) of kernels 7 (2 or 4 chains), 8 and 9.
CHAIN_SCHEDULES = ((2, False), (4, False), (1, True), (2, True))
_MODE_CODES = {"base": 0, "bf16exp": 1, "exp2": 2}
_TMA_MAX_STRIDE = 2 ** 39  # elements: a TMA stride stays below 2^40 bytes

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
         + [ctypes.c_float, ctypes.c_void_p])
_INFO = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "flash_variants": {
        "vt_flash_variant": ([ctypes.c_int] * 2 + _ARGS, ctypes.c_int),
        "vt_flash_variant_info": ([ctypes.c_int] * 2 + [_INFO], ctypes.c_int)},
    "flash_chains": {
        "vt_flash_chains": ([ctypes.c_int] * 3 + _ARGS, ctypes.c_int),
        "vt_flash_chains_info": ([ctypes.c_int] * 3 + [_INFO], ctypes.c_int)},
}
_INFO_FIELDS = ("registers", "blocks_per_sm", "threads", "smem_bytes",
                "spill_bytes")


# ----------------------------------------------------------- plain versions
def variant_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  mode: str = "base", block_k: int = 64) -> torch.Tensor:
    """Kernel 6's function, step by step as ``_variant_kernel`` computes it.

    s = (q·kᵀ in fp32)·scale, scale = 1/√d, over chunks of ``block_k`` keys;
    the running max m is updated once per chunk; then, per ``mode``:
    ``base`` p = exp(s − m), α = exp(m_old − m); ``bf16exp`` (s − m) and
    (m_old − m) rounded to bf16 and exp taken in bf16 (p stays bf16, l sums
    it in fp32); ``exp2`` p = exp2((s − m)·log2 e), log2 e multiplied after
    the subtraction. l = l·α + Σp, acc = acc·α + p (rounded to v's dtype)·v,
    and out = acc / max(l, 1e-30) in the input dtype. The TPU kernel scores
    keys past N as NEG_INF in its padded last chunk, which gives them p = 0
    exactly and leaves the max alone; here the last chunk is simply shorter.
    """
    _check_mode(mode)
    return _online_softmax(q, k, v, mode, block_k, _torch_bf16_exp)


def bf16exp_card_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       block_k: int = 64) -> torch.Tensor:
    """Kernel 6's ``bf16exp`` mode as the CUDA kernel rounds it: exp of the
    bf16 x taken as the bf16 exp2 of y = x·log2 e, y rounded to bf16, and
    2^y rounded toward zero to bf16, as the card's bf16 exp2 instruction
    (``exp_bf16x2`` in ``csrc/flash_variant_wgmma.cuh``) rounds it. (The
    instruction also flushes a subnormal 2^y to zero and returns 1 for some
    y next to 0 but not 0; on standard-normal inputs such p and x are
    vanishingly rare, and such p add nothing.)

    ``variant_plain(mode="bf16exp")`` takes torch's bf16 exp (fp32 exp of
    the bf16 x, rounded to nearest), which is what the TPU kernel's bf16
    ``jnp.exp`` computes; the card's two extra roundings move p by about as
    much as the mode's own rounding of x does. So the kernel is held to
    this version at a tight gate, which an output with exp in fp32 fails,
    and to ``variant_plain`` at a looser one (chip_smoke.py).
    """
    return _online_softmax(q, k, v, "bf16exp", block_k, _card_bf16_exp)


def _torch_bf16_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.to(torch.bfloat16))


def _card_bf16_exp(x: torch.Tensor) -> torch.Tensor:
    y = (x.to(torch.bfloat16).float() * LOG2E).to(torch.bfloat16)
    p = torch.exp2(y.float())
    # Round toward zero: clear the 16 bits below bf16's.
    return (p.view(torch.int32) & -0x10000).view(torch.float32).to(
        torch.bfloat16)


def _online_softmax(q, k, v, mode: str, block_k: int, bf16_exp):
    """``variant_plain``'s loop; ``bf16_exp`` maps fp32 x to the bf16
    exp(x) of the ``bf16exp`` mode."""
    _check_shapes(q, k, v)
    n, d = q.shape[-2:]
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    lead = q.shape[:-1]
    acc = torch.zeros(*lead, d, dtype=torch.float32, device=q.device)
    m = torch.full((*lead, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((*lead, 1), dtype=torch.float32, device=q.device)
    for start in range(0, n, block_k):
        kc = k[..., start:start + block_k, :]
        vc = v[..., start:start + block_k, :]
        s = torch.matmul(qf, kc.float().transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        if mode == "bf16exp":
            p = bf16_exp(s - m_new)
            alpha = bf16_exp(m - m_new).float()
            l = l * alpha + p.float().sum(-1, keepdim=True)
        elif mode == "exp2":
            p = torch.exp2((s - m_new) * LOG2E)
            alpha = torch.exp2((m - m_new) * LOG2E)
            l = l * alpha + p.sum(-1, keepdim=True)
        else:
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vc.float())
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def multiq_plain(q, k, v, *, block_k: int = 64) -> torch.Tensor:
    """Kernel 7's function (``_multiq_kernel``): base-mode attention at
    ``block_k``. Each chain is the online softmax of its own rows over the
    same key chunks, so the number of chains changes only the schedule."""
    return variant_plain(q, k, v, mode="base", block_k=block_k)


def pvt_plain(q, k, v, *, block_k: int = 64) -> torch.Tensor:
    """Kernel 8's function (``_pvt_kernel``), in (…, N, d): base-mode
    attention at ``block_k``. Computing Sᵀ and Oᵀ transposes the products,
    not their sums, so the transpose changes only the schedule."""
    return variant_plain(q, k, v, mode="base", block_k=block_k)


def dualq_pvt_plain(q, k, v, *, block_k: int = 64) -> torch.Tensor:
    """Kernel 9's function (``_dualq_pvt_kernel``): base-mode attention at
    ``block_k``; two chains, transposed, change only the schedule."""
    return variant_plain(q, k, v, mode="base", block_k=block_k)


# ------------------------------------------------------------ design names
def variant_path(mode: str, block_k: int) -> str:
    """Which design kernel 6 runs on the card for (mode, block_k):
    "wgmma_tma" at every mode and key tile (consumer warpgroups of 64
    query rows on ``wgmma`` products, two a block or three at 64-key
    tiles, K/V by TMA from a producer warp;
    ``csrc/flash_variant_wgmma.cuh``)."""
    _check_mode(mode)
    _check_block_k(block_k, VARIANT_BLOCK_KS)
    return "wgmma_tma"


def chains_path(chains: int, transposed: bool, block_k: int) -> str:
    """Which design kernels 7-9 run on the card for (chains, transposed,
    block_k): "wgmma_tma" for every schedule (``csrc/flash_chains.cu``):
    kernel 7 two 64-row chains a warpgroup, two warpgroups a block, whose
    products quadq orders ping-pong; kernel 8 Oᵀ = Vᵀ·Pᵀ with the
    features on wgmma's M and a warpgroup's 64 queries on its N; kernel 9
    both."""
    _check_block_k(block_k, CHAIN_BLOCK_KS)
    if (chains, bool(transposed)) not in CHAIN_SCHEDULES:
        raise ValueError(f"no kernel for chains={chains}, "
                         f"transposed={transposed}")
    return "wgmma_tma"


def _info(lib_name: str, fn_name: str, *codes) -> dict:
    lib = _build.load(lib_name, _SIGNATURES[lib_name])
    out = (ctypes.c_int * len(_INFO_FIELDS))()
    _build.check(lib, getattr(lib, fn_name)(*codes, out), fn_name)
    return dict(zip(_INFO_FIELDS, out))


def variant_info(mode: str, block_k: int) -> dict:
    """What the card's runtime reports of kernel 6's (mode, block_k)
    instantiation: registers a thread, blocks an SM, threads a block,
    dynamic shared memory and spilled bytes a thread. Needs CUDA."""
    _check_mode(mode)
    _check_block_k(block_k, VARIANT_BLOCK_KS)
    return _info("flash_variants", "vt_flash_variant_info",
                 _MODE_CODES[mode], block_k)


def chains_info(chains: int, transposed: bool, block_k: int) -> dict:
    """``variant_info`` of the (chains, transposed, block_k)
    instantiation of kernels 7-9. Needs CUDA."""
    chains_path(chains, transposed, block_k)
    return _info("flash_chains", "vt_flash_chains_info", chains,
                 int(bool(transposed)), block_k)


# ----------------------------------------------------------------- wrappers
def _check_shapes(q, k, v) -> None:
    if q.dim() not in (3, 4) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"inputs must share one (BH, N, d) or (B, H, N, d) "
                         f"shape, got {[tuple(t.shape) for t in (q, k, v)]}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"head dim must be {HEAD_DIM} (the sweeps' d), "
                         f"got {q.shape[-1]}")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _check_block_k(block_k: int, allowed) -> None:
    if block_k not in allowed:
        raise ValueError(f"block_k must be one of {allowed}, got {block_k}")


def _tma_layout(t: torch.Tensor) -> bool:
    """Whether TMA can read the (B, H, N, 64) view t, besides
    ``_kernel_layout``: every stride of a dimension longer than 1 is a
    positive multiple of 16 bytes below 2^40 bytes."""
    return all(size == 1 or (0 < stride < _TMA_MAX_STRIDE and stride % 8 == 0)
               for size, stride in zip(t.shape[:3], t.stride()[:3]))


def kernel_views(name: str, q, k, v):
    """(B, H, N, 64) views of q, k, v as the kernels read them through
    TMA; ``ValueError`` for a layout it cannot read, before any launch."""
    views = [t if t.dim() == 4 else t.unsqueeze(0) for t in (q, k, v)]
    b, h = views[0].shape[:2]
    if b * h > 65535:
        raise ValueError(f"{name}: B*H = {b * h} exceeds 65535")
    if not all(_kernel_layout(t) for t in views):
        raise ValueError(f"{name}: the last dimension must be contiguous and "
                         f"rows must start on 16-byte boundaries")
    if not all(_tma_layout(t) for t in views):
        raise ValueError(f"{name}: TMA reads strides that are positive "
                         f"multiples of 16 bytes below 2^40 bytes, got "
                         f"{[t.stride()[:3] for t in views]}")
    return views


def _cuda_views(name: str, q, k, v):
    """(B, H, N, 64) views of CUDA q, k, v as the kernels take them."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError(f"{name}: inputs must be on one device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"{name}: the kernels take bfloat16, got "
                        f"{[t.dtype for t in (q, k, v)]}")
    return kernel_views(name, q, k, v)


def _launch_strides(*tensors):
    """``_strides``, with 8 (16 bytes, a stride TMA takes) for a dimension
    of length 1, whose stride the kernels never multiply by more than 0."""
    return [s if size > 1 else 8 for t in tensors
            for size, s in zip(t.shape[:3], t.stride()[:3])]


def _launch(lib_name: str, fn_name: str, codes, q, k, v, out) -> None:
    """Run one kernel on (B, H, N, 64) views into the 4-D ``out``."""
    b, h, n, d = q.shape
    lib = _build.load(lib_name, _SIGNATURES[lib_name])
    with torch.cuda.device(q.device):
        err = getattr(lib, fn_name)(
            *codes, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *_launch_strides(q, k, v, out), b, h, n, 1.0 / math.sqrt(d),
            _stream(q.device))
    _build.check(lib, err, fn_name)


def flash_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  mode: str = "base", block_k: int = 64) -> torch.Tensor:
    """Kernel 6: attention with the softmax form ``mode`` over key tiles of
    ``block_k`` (32, 64 or 128) keys; ``variant_plain`` on a CPU tensor."""
    _check_shapes(q, k, v)
    _check_mode(mode)
    _check_block_k(block_k, VARIANT_BLOCK_KS)
    if q.device.type == "cpu":
        return variant_plain(q, k, v, mode=mode, block_k=block_k)
    q4, k4, v4 = _cuda_views("flash_variant", q, k, v)
    out = torch.empty(q4.shape, dtype=q.dtype, device=q.device)
    _launch("flash_variants", "vt_flash_variant", (_MODE_CODES[mode], block_k),
            q4, k4, v4, out)
    spans.count("flash_variant")
    return out.view(q.shape)


def _chains(name: str, chains: int, transposed: bool, q, k, v, block_k):
    q4, k4, v4 = _cuda_views(name, q, k, v)
    b, h, n, d = q4.shape
    if transposed:
        # Oᵀ, (B, H, d, N), as the TPU kernel writes (bh, d, n_pad); the
        # caller gets its (B, H, N, d) view, without a copy.
        out_t = torch.empty(b, h, d, n, dtype=q.dtype, device=q.device)
        _launch("flash_chains", "vt_flash_chains", (chains, 1, block_k), q4,
                k4, v4, out_t)
        out = out_t.transpose(-1, -2)
    else:
        out = torch.empty(q4.shape, dtype=q.dtype, device=q.device)
        _launch("flash_chains", "vt_flash_chains", (chains, 0, block_k), q4,
                k4, v4, out)
    return out if q.dim() == 4 else out[0]


def flash_multiq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 chains: int = 2, block_k: int = 64) -> torch.Tensor:
    """Kernel 7: base-mode attention with ``chains`` (2 or 4) interleaved
    64-row chains, key tiles of ``block_k`` (32 or 64); ``multiq_plain``
    on a CPU tensor."""
    _check_shapes(q, k, v)
    _check_block_k(block_k, CHAIN_BLOCK_KS)
    if chains not in (2, 4):
        raise ValueError(f"chains must be 2 or 4, got {chains}")
    if q.device.type == "cpu":
        return multiq_plain(q, k, v, block_k=block_k)
    out = _chains("flash_multiq", chains, False, q, k, v, block_k)
    spans.count("flash_multiq")
    return out


def flash_pvt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              block_k: int = 64) -> torch.Tensor:
    """Kernel 8: base-mode attention computed transposed. On CUDA the
    result is the (…, N, 64) view of the kernel's (…, 64, N) output;
    ``pvt_plain`` on a CPU tensor."""
    _check_shapes(q, k, v)
    _check_block_k(block_k, CHAIN_BLOCK_KS)
    if q.device.type == "cpu":
        return pvt_plain(q, k, v, block_k=block_k)
    out = _chains("flash_pvt", 1, True, q, k, v, block_k)
    spans.count("flash_pvt")
    return out


def flash_dualq_pvt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    block_k: int = 64) -> torch.Tensor:
    """Kernel 9: kernel 8 with two 64-row chains a warpgroup;
    ``dualq_pvt_plain`` on a CPU tensor."""
    _check_shapes(q, k, v)
    _check_block_k(block_k, CHAIN_BLOCK_KS)
    if q.device.type == "cpu":
        return dualq_pvt_plain(q, k, v, block_k=block_k)
    out = _chains("flash_dualq_pvt", 2, True, q, k, v, block_k)
    spans.count("flash_dualq_pvt")
    return out
