"""Flash attention on Hopper (forward, training forward, backward), and the
plain versions of each kernel.

Kernels (``csrc/``), each replacing a kernel of the TPU package's
``ops/flash_attention.py``:

- ``flash_attention_fwd.cu``, inference: softmax(Q·Kᵀ·d^-½)·V online over
  key tiles (``_fwd_kernel`` with ``need_lse=False``), launched by
  ``flash_attention`` when no gradient is needed, through the custom op
  ``vt::flash_attention_fwd``. It alone takes a key count Nk of its own
  (q (B, H, Nq, d), k and v (B, H, Nk, d)): MiT's spatial-reduction
  attention (``models/mit.py``);
- the same source, training (``flash_attention_train``): also writes the
  natural-log lse and applies attention dropout inside the kernel
  (``_fwd_kernel`` with ``need_lse=True``);
- the same source, inference with SAM's decomposed relative-position bias
  (``flash_attention_bias``, the custom op ``vt::flash_attention_fwd_bias``):
  with Nk = kh·kw keys on a kh × kw grid, key k of query row i adds
  rel_h[..., i, k // kw] + rel_w[..., i, k % kw] to its scaled logit, inside
  the kernel's softmax step, so no N×Nk bias or logit tensor is written;
  bfloat16 at d = 64 ("wgmma") and d = 80 ("stream") with kw even
  (``bias_kernel_takes``);
- ``flash_attention_bwd_dq.cu`` (``flash_attention_bwd_dq``) and
  ``flash_attention_bwd_dkv.cu`` (``flash_attention_bwd_dkv``): the two
  backward kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``).

``FlashAttention`` (a ``torch.autograd.Function``) joins the training
forward and the backward kernels; it saves q, k, v (views, as the model
passes them), the output and the lse, never an N×N tensor. Δ = rowsum(dO∘O)
is computed by the dQ kernel's prologue from the saved output
(``flash_attention_bwd_dq_delta``) and handed to the dK/dV kernel; the
standalone wrappers also take a given Δ, as the TPU kernels do.

The bf16 kernels, forward and backward, walk a ring of 64-row tiles, on
warpgroup products at d = 64 ("wgmma", every ViT configuration here) and on
``mma.sync`` at the other head dims ("stream"); fp32 runs the scalar kernels
("scalar"). ``forward_path`` and ``backward_path`` name the instantiation a
shape takes; each kernel chooses it by its own template, and the sequence
length does not enter (within "wgmma" the forward picks one or two
warpgroups a block from N and the card's size): an instantiation of the
backward that staged a short head whole was measured no faster at N = 197
(PERF.md) and was not kept.

Dropout keeps probability (row i, column j) of head b·H + h when the top 24
bits of a word of Philox4x32-10, read as u in [0, 1), fall below keep. One
call, key (seed, b·H + h), counter (i >> 1, j >> 1, 0, 0), draws the 2×2
block of probabilities around (i, j): word 2·(i & 1) + (j & 1).
``dropout_keep_mask`` computes the same bits in PyTorch, so a kernel and its
plain version drop the same probabilities. The bitstream is the port's own,
not the TPU package's.

Every wrapper runs its kernel for a CUDA tensor and its plain version for a
CPU tensor; anything else raises. A kernel that fails to build or launch
raises (``_build.check``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from visiontransformer_tpu_torch.ops import _build
from visiontransformer_tpu_torch.utils import spans

HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

Seed = Union[int, torch.Tensor]

_STRIDES = [ctypes.c_longlong] * 3
_SIGNATURES = {
    "flash_attention_fwd": {
        "vt_flash_attention_fwd": (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + _STRIDES * 4
            + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
            ctypes.c_int),
        "vt_flash_attention_fwd_train": (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + _STRIDES * 4
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p,
                                    ctypes.c_uint, ctypes.c_float,
                                    ctypes.c_void_p],
            ctypes.c_int),
        "vt_flash_attention_fwd_bias": (
            [ctypes.c_void_p] * 6 + _STRIDES * 4 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p],
            ctypes.c_int),
        "vt_flash_attention_fwd_block_rows": (
            [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
            ctypes.c_int)},
    "flash_attention_bwd_dq": {
        "vt_flash_attention_bwd_dq": (
            [ctypes.c_int] + [ctypes.c_void_p] * 8 + _STRIDES * 6
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p,
                                    ctypes.c_uint, ctypes.c_float,
                                    ctypes.c_void_p],
            ctypes.c_int)},
    "flash_attention_bwd_dkv": {
        "vt_flash_attention_bwd_dkv": (
            [ctypes.c_int] + [ctypes.c_void_p] * 8 + _STRIDES * 6
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p,
                                    ctypes.c_uint, ctypes.c_float,
                                    ctypes.c_void_p],
            ctypes.c_int)},
}


# ------------------------------------------------------------------ dropout
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo32(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product of the constant a and
    the uint32 values in the int64 tensor b, with b split into 16-bit
    halves so that no int64 product overflows."""
    t_lo = a * (b & 0xFFFF)          # < 2^48
    t_hi = a * (b >> 16)             # < 2^48
    lo = (t_lo + ((t_hi & 0xFFFF) << 16)) & _MASK32
    hi = (t_hi + (t_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11) over int64 tensors holding
    uint32 values: counter (c0, c1, c2, c3), key (k0, k1), broadcast
    together; returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """ceil(keep · 2^24): a draw keeps when its top 24 bits are below it
    (u = bits · 2^-24 < keep). 2^24 keeps everything."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return min(1 << 24, math.ceil((1.0 - rate) * (1 << 24)))


def _seed_tensor(seed: Seed, device) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).to(device=device, dtype=torch.int64)
    return torch.tensor(int(seed), dtype=torch.int64, device=device)


def dropout_keep_mask(seed: Seed, bh: int, n_rows: int, n_cols: int,
                      rate: float, device=None) -> torch.Tensor:
    """(bh, n_rows, n_cols) bool keep-mask of the kernels' dropout, for
    heads 0..bh-1 (b·H + h order): one Philox call per 2×2 block, element
    (i, j) reading word 2·(i & 1) + (j & 1) of the call with counter
    (i >> 1, j >> 1)."""
    device = seed.device if isinstance(seed, torch.Tensor) else device
    k0 = _seed_tensor(seed, device) & _MASK32
    threshold = keep_threshold(rate)
    half_rows, half_cols = (n_rows + 1) // 2, (n_cols + 1) // 2
    rows = torch.arange(half_rows, device=device).view(half_rows, 1)
    cols = torch.arange(half_cols, device=device).view(1, half_cols)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    # Heads in chunks of at most 2^25 elements bound the int64 temporaries.
    step = max(1, (1 << 25) // max(1, n_rows * n_cols))
    masks = []
    for start in range(0, bh, step):
        k1 = torch.arange(start, min(bh, start + step),
                          device=device).view(-1, 1, 1)
        words = philox4x32_10((rows, cols, zero, zero), (k0, k1))
        # (heads, half_rows, half_cols, i & 1, j & 1) -> (heads, rows, cols)
        block = torch.stack(words, -1).view(-1, half_rows, half_cols, 2, 2)
        block = block.permute(0, 1, 3, 2, 4).reshape(
            -1, 2 * half_rows, 2 * half_cols)
        masks.append((block[:, :n_rows, :n_cols] >> 8) < threshold)
    return torch.cat(masks)


def _dropout_scale(seed: Optional[Seed], rate: float, bh: int, n: int,
                   device) -> Optional[torch.Tensor]:
    """(bh, n, n) fp32 mask / keep, or None without dropout."""
    if rate == 0.0:
        return None
    inv_keep = float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))
    mask = dropout_keep_mask(seed, bh, n, n, rate, device)
    return mask.to(torch.float32) * inv_keep


# ----------------------------------------------------------- plain versions
def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """The inference kernel's function in plain PyTorch, fp32 math: fp32
    scale 1/√d as the TPU kernel's ``_fwd`` uses, output in the input
    dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def flash_attention_bias_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, rel_h: torch.Tensor,
                               rel_w: torch.Tensor) -> torch.Tensor:
    """The bias instantiations' function in plain PyTorch, fp32 math: q
    (B, H, N, d) against k and v (B, H, kh·kw, d), key k of row i adding
    rel_h[..., i, k // kw] + rel_w[..., i, k % kw] (rel_h (B, H, N, kh),
    rel_w (B, H, N, kw)) to its logit scaled by 1/√d; output in q's
    dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    bias = rel_h.float().unsqueeze(-1) + rel_w.float().unsqueeze(-2)
    p = torch.softmax(s + bias.flatten(-2), dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _scores(q, k):
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def flash_attention_train_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, rate: float = 0.0,
                                seed: Optional[Seed] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward in plain PyTorch: (out, lse), lse = m + log l
    in fp32 (natural log) of shape (B, H, N). The denominator sums the
    undropped probabilities; P · mask / keep is rounded to the input dtype
    before P·V, where the kernel rounds it."""
    b, h, n, _ = q.shape
    s = _scores(q, k)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    drop = _dropout_scale(seed, rate, b * h, n, q.device)
    if drop is not None:
        p = p * drop.view(b, h, n, n)
    pv = torch.matmul(p.to(q.dtype).float(), v.float())
    return (pv / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _bwd_plain(q, k, v, do, lse, delta, rate, seed):
    """(P · mask / keep, dS) in fp32, each as the kernels round them."""
    b, h, n, _ = q.shape
    p = torch.exp(_scores(q, k) - lse.float().unsqueeze(-1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    drop = _dropout_scale(seed, rate, b * h, n, q.device)
    pd = p
    if drop is not None:
        drop = drop.view(b, h, n, n)
        pd, dp = p * drop, dp * drop
    ds = p * (dp - delta.float().unsqueeze(-1))
    return pd.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, rate=0.0,
                                 seed=None) -> torch.Tensor:
    """dQ = (P ∘ (dP · mask/keep − Δ)) · K · scale, dS rounded to the input
    dtype before the product."""
    _, ds = _bwd_plain(q, k, v, do, lse, delta, rate, seed)
    scale = 1.0 / math.sqrt(q.shape[-1])
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, rate=0.0,
                                  seed=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV): dV = (P · mask/keep)ᵀ · dO, dK = dSᵀ · Q · scale."""
    pd, ds = _bwd_plain(q, k, v, do, lse, delta, rate, seed)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(pd.transpose(-1, -2), do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


# ----------------------------------------------------------------- wrappers
def _check(name: str, q: torch.Tensor, *others: torch.Tensor,
           keys: Tuple[torch.Tensor, ...] = ()) -> None:
    """Raise unless q and others are (B, H, N, d) CUDA views the kernels
    take: one shape, float32 or bfloat16, d in HEAD_DIMS, last dimension
    contiguous, bf16 rows 16-byte aligned. ``keys`` (kernel 1's k and v)
    may hold another count of rows, Nk, one for both."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if (q.dim() != 4 or any(t.shape != q.shape for t in others)
            or any(t.shape != keys[0].shape or t.dim() != 4
                   or t.shape[:2] != q.shape[:2] or t.shape[3] != q.shape[3]
                   for t in keys)):
        raise ValueError(f"{name}: inputs must share one (B, H, N, d) shape "
                         f"(k and v one (B, H, Nk, d)), got "
                         f"{[tuple(t.shape) for t in (q, *keys, *others)]}")
    others = (*keys, *others)
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in others):
        raise TypeError(f"{name}: inputs must all be float32 or bfloat16, "
                        f"got {[t.dtype for t in (q, *others)]}")
    if any(t.device != q.device for t in others):
        raise ValueError(f"{name}: inputs must be on one device")
    b, h, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"{name}: B*H = {b * h} exceeds 65535")
    if not all(_kernel_layout(t) for t in (q, *others)):
        # The tensor-core path moves rows as 16-byte vectors.
        raise ValueError(f"{name}: the last dimension must be contiguous and "
                         f"bfloat16 rows must start on 16-byte boundaries")


def _kernel_layout(t: torch.Tensor) -> bool:
    if t.stride(-1) != 1:
        return False
    return t.dtype != torch.bfloat16 or (
        t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3]))


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def _dropout_args(rate: float, seed: Optional[Seed], device):
    """(seed tensor or None, threshold, 1/keep) for a kernel launch."""
    threshold = keep_threshold(rate)
    if rate == 0.0:
        return None, threshold, 1.0
    if seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    return _seed_tensor(seed, device), threshold, 1.0 / (1.0 - rate)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          rate: float = 0.0, seed: Optional[Seed] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward (kernel 2): (out, lse) as
    ``flash_attention_train_plain``, lse (B, H, N) fp32. On the card the
    kernel runs the instantiation ``forward_path`` names."""
    if q.device.type == "cpu":
        if rate > 0.0 and seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        return flash_attention_train_plain(q, k, v, rate, seed)
    _check("flash_attention_train", q, k, v)
    seed_t, threshold, inv_keep = _dropout_args(rate, seed, q.device)
    b, h, n, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(b, h, n, dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_fwd",
                      _SIGNATURES["flash_attention_fwd"])
    with torch.cuda.device(q.device):
        err = lib.vt_flash_attention_fwd_train(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), *_strides(q, k, v, out), b, h, n,
            d, 1.0 / math.sqrt(d),
            None if seed_t is None else seed_t.data_ptr(), threshold,
            inv_keep, _stream(q.device))
    _build.check(lib, err, "flash_attention_train")
    spans.count("flash_attention_train")
    return out, lse


def _backward_inputs(do: torch.Tensor) -> torch.Tensor:
    # dO comes from autograd: a strided view as a rule, copied only when its
    # rows do not suit the kernels' 16-byte loads.
    return do if _kernel_layout(do) else do.contiguous()


WGMMA_HEAD_DIM = 64  # the head dim the wgmma instantiations are written for


def _path(name: str, d: int, dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return "scalar"
    if dtype != torch.bfloat16:
        raise TypeError(f"{name}: unsupported dtype {dtype}")
    return "wgmma" if d == WGMMA_HEAD_DIM else "stream"


def forward_path(n: int, d: int, dtype: torch.dtype) -> str:
    """Which instantiation of the forward kernels (1 and 2) a (N, d, dtype)
    takes on the card: "scalar" for float32; for bfloat16 "wgmma" at d = 64
    and "stream" (the ``mma.sync`` ring) at the other head dims, at every
    N."""
    return _path("forward_path", d, dtype)


def forward_block_rows(bh: int, n: int) -> int:
    """The rows a block of kernel 1's "wgmma" instantiation (bfloat16, d =
    64) takes at ``bh`` = B·H and ``n`` query rows on the current CUDA
    device: 64 or 128, by the fill rule of
    ``csrc/flash_attention_fwd.cu:launch_wgmma``."""
    lib = _build.load("flash_attention_fwd",
                      _SIGNATURES["flash_attention_fwd"])
    rows = ctypes.c_int(0)
    _build.check(lib, lib.vt_flash_attention_fwd_block_rows(
        bh, n, ctypes.byref(rows)), "forward_block_rows")
    return rows.value


def backward_path(n: int, d: int, dtype: torch.dtype) -> str:
    """Which instantiation of the backward kernels (3 and 4) a (N, d,
    dtype) takes on the card; the same rule as ``forward_path``."""
    return _path("backward_path", d, dtype)


def attention_delta_plain(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO ∘ O), (B, H, N) fp32."""
    return (do.float() * out.float()).sum(-1)


def _launch_bwd_dq(q, k, v, do, lse, delta, out, rate, seed):
    """Launch kernel 3. ``out`` None: ``delta`` is read. Otherwise ``delta``
    is an empty (B, H, N) fp32 tensor the kernel fills from ``out``."""
    seed_t, threshold, inv_keep = _dropout_args(rate, seed, q.device)
    b, h, n, d = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _build.load("flash_attention_bwd_dq",
                      _SIGNATURES["flash_attention_bwd_dq"])
    with torch.cuda.device(q.device):
        err = lib.vt_flash_attention_bwd_dq(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if out is None else out.data_ptr(),
            dq.data_ptr(), *_strides(q, k, v, do, q if out is None else out,
                                     dq),
            b, h, n, d, 1.0 / math.sqrt(d),
            None if seed_t is None else seed_t.data_ptr(), threshold,
            inv_keep, _stream(q.device))
    _build.check(lib, err, "flash_attention_bwd_dq")
    spans.count("flash_attention_bwd_dq")
    return dq


def flash_attention_bwd_dq(q, k, v, do, lse, delta, rate: float = 0.0,
                           seed: Optional[Seed] = None) -> torch.Tensor:
    """dQ (kernel 3) from q, k, v, dO (B, H, N, d) and the forward's lse and
    Δ = rowsum(dO∘O), both (B, H, N) fp32. On the card the kernel runs the
    instantiation ``backward_path`` names: bfloat16 "wgmma" at d = 64 and
    "stream" at the other head dims, float32 the scalar kernel."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, rate,
                                            seed)
    do = _backward_inputs(do)
    _check("flash_attention_bwd_dq", q, k, v, do)
    lse, delta = _rows(lse, q), _rows(delta, q)
    return _launch_bwd_dq(q, k, v, do, lse, delta, None, rate, seed)


def flash_attention_bwd_dq_delta(q, k, v, do, lse, out, rate: float = 0.0,
                                 seed: Optional[Seed] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dQ, Δ): kernel 3 with Δ = rowsum(dO∘O) computed in its prologue
    from the forward's output ``out`` (bfloat16 on the card; float32, whose
    scalar kernel reads a given Δ, and the CPU compute Δ in PyTorch first).
    Paths as ``flash_attention_bwd_dq``."""
    if q.device.type == "cpu" or q.dtype == torch.float32:
        delta = attention_delta_plain(do, out)
        return flash_attention_bwd_dq(q, k, v, do, lse, delta, rate,
                                      seed), delta
    do = _backward_inputs(do)
    _check("flash_attention_bwd_dq", q, k, v, do, out)
    lse = _rows(lse, q)
    delta = torch.empty_like(lse)
    dq = _launch_bwd_dq(q, k, v, do, lse, delta, out, rate, seed)
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, rate: float = 0.0,
                            seed: Optional[Seed] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) (kernel 4), inputs and instantiations as
    ``flash_attention_bwd_dq``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, rate,
                                             seed)
    do = _backward_inputs(do)
    _check("flash_attention_bwd_dkv", q, k, v, do)
    lse, delta = _rows(lse, q), _rows(delta, q)
    seed_t, threshold, inv_keep = _dropout_args(rate, seed, q.device)
    b, h, n, d = q.shape
    dk = torch.empty_like(q, memory_format=torch.contiguous_format)
    dv = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _build.load("flash_attention_bwd_dkv",
                      _SIGNATURES["flash_attention_bwd_dkv"])
    with torch.cuda.device(q.device):
        err = lib.vt_flash_attention_bwd_dkv(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(),
            *_strides(q, k, v, do, dk, dv), b, h, n, d, 1.0 / math.sqrt(d),
            None if seed_t is None else seed_t.data_ptr(), threshold,
            inv_keep, _stream(q.device))
    _build.check(lib, err, "flash_attention_bwd_dkv")
    spans.count("flash_attention_bwd_dkv")
    return dk, dv


def _rows(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """A (B, H, N) fp32 per-row tensor, contiguous, as the kernels read it."""
    if x.shape != q.shape[:3] or x.dtype != torch.float32:
        raise ValueError(f"per-row input must be (B, H, N) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    return x.contiguous()


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is kernel 2 and whose backward is kernels 3
    and 4 (their plain versions on a CPU tensor)."""

    @staticmethod
    def forward(ctx, q, k, v, rate: float, seed: Optional[torch.Tensor]):
        out, lse = flash_attention_train(q, k, v, rate, seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.rate, ctx.seed = rate, seed
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, delta = flash_attention_bwd_dq_delta(q, k, v, do, lse, out,
                                                 ctx.rate, ctx.seed)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.rate,
                                         ctx.seed)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[Seed] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, N, d) q, k, v -> (B, H, N, d) attention output; without a
    gradient and without dropout k and v may hold Nk ≠ N keys, (B, H, Nk,
    d), and the output keeps q's shape (kernel 1 only; the training forward
    and kernels 3 and 4 take Nk = N, so asking them for Nk ≠ N raises).

    When a gradient is needed (grad mode on and an input requires grad),
    ``FlashAttention``: kernel 2 forward, kernels 3 and 4 backward.
    Otherwise without dropout the inference kernel (serving, evaluation)
    through the custom op ``vt::flash_attention_fwd``, which an exported
    program holds as one node; with dropout kernel 2 alone. dropout_rate
    > 0 needs dropout_seed (an int, or an int64 scalar tensor, which may
    live on the device). CUDA: float32 or bfloat16, d in HEAD_DIMS, strided
    views with a contiguous last dimension; the forward kernels run the
    instantiation ``forward_path`` names. CPU: the plain versions. Anything
    else raises.

    ``out``: a (B, H, N, d) tensor of q's dtype on q's device, which the
    inference kernel writes and which is returned
    (``vt::flash_attention_fwd.out``; the serving runner's CUDA graphs
    read it as a static input). Only the inference kernel takes it."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if k.shape[-2] != q.shape[-2] and (needs_grad or dropout_rate > 0.0):
        raise ValueError(
            f"flash_attention: {q.shape[-2]} queries against {k.shape[-2]} "
            f"keys run only in the inference kernel (no gradient, no "
            f"dropout); the training kernels take as many keys as queries")
    if out is not None and (needs_grad or dropout_rate > 0.0):
        raise ValueError("flash_attention: out= is taken by the inference "
                         "kernel only (no gradient, no dropout)")
    if needs_grad:
        seed = (None if dropout_rate == 0.0
                else _seed_tensor(dropout_seed, q.device))
        return FlashAttention.apply(q, k, v, float(dropout_rate), seed)
    if dropout_rate > 0.0:
        return flash_attention_train(q, k, v, dropout_rate, dropout_seed)[0]
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if out is not None:
        return torch.ops.vt.flash_attention_fwd.out(q, k, v, out=out)
    return torch.ops.vt.flash_attention_fwd(q, k, v)


# ------------------------------------------------ the bias instantiations
BIAS_HEAD_DIMS = (64, 80)  # "wgmma" at 64, the mma.sync ring at 80
_BIAS_MAX_KEYS = 1 << 20


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def bias_kernel_takes(q: torch.Tensor, k: torch.Tensor,
                      rel_h: torch.Tensor, rel_w: torch.Tensor) -> bool:
    """Whether ``flash_attention_bias`` on these inputs launches kernel 1's
    bias instantiation: a CUDA tensor, no gradient being taken, bfloat16, d
    in ``BIAS_HEAD_DIMS``, rel_h (B, H, N, kh) and rel_w (B, H, N, kw) of
    q's dtype, Nk = kh·kw with kw even and at most 2^20 keys, B·H·N·max(kh,
    kw) < 2^31, and rows the kernel reads (``_kernel_layout``). Every other
    call is the caller's to run eagerly."""
    b, h, n, d = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    return (q.is_cuda and not needs_grad(q, k, rel_h, rel_w)
            and q.dtype == torch.bfloat16 and d in BIAS_HEAD_DIMS
            and rel_h.dtype == rel_w.dtype == q.dtype
            and k.shape[-2] == kh * kw and kw % 2 == 0
            and kh * kw <= _BIAS_MAX_KEYS
            and b * h * n * max(kh, kw) < 2 ** 31
            and rel_h.shape == (b, h, n, kh) and rel_w.shape == (b, h, n, kw)
            and _kernel_layout(q) and _kernel_layout(k))


def flash_attention_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rel_h: torch.Tensor, rel_w: torch.Tensor
                         ) -> torch.Tensor:
    """softmax(q·kᵀ/√d + bias)·v with SAM's decomposed bias
    (``flash_attention_bias_plain``), through the custom op
    ``vt::flash_attention_fwd_bias``: on a CUDA tensor kernel 1's bias
    instantiation, which raises unless ``bias_kernel_takes`` the call; on
    the CPU the plain version. Without a gradient only."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention_bias: unsupported device "
                         f"{q.device}")
    return torch.ops.vt.flash_attention_fwd_bias(q, k, v, rel_h, rel_w)


def _flash_attention_bias_cuda(q, k, v, rel_h, rel_w) -> torch.Tensor:
    _check("flash_attention_bias", q, keys=(k, v))
    rel_h, rel_w = (t.contiguous() for t in (rel_h, rel_w))
    if not bias_kernel_takes(q, k, rel_h, rel_w) or any(
            t.device != q.device or t.data_ptr() % 4 for t in (rel_h, rel_w)):
        raise ValueError(
            f"flash_attention_bias: the kernel takes bfloat16 at d in "
            f"{BIAS_HEAD_DIMS} without a gradient, with rel_h (B, H, N, kh) "
            f"and rel_w (B, H, N, kw) of q's dtype, kw even and Nk = kh·kw; "
            f"got q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, rel_h "
            f"{tuple(rel_h.shape)} {rel_h.dtype}, rel_w {tuple(rel_w.shape)} "
            f"{rel_w.dtype}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    b, h, n, d = q.shape
    lib = _build.load("flash_attention_fwd",
                      _SIGNATURES["flash_attention_fwd"])
    with torch.cuda.device(q.device):
        err = lib.vt_flash_attention_fwd_bias(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            rel_h.data_ptr(), rel_w.data_ptr(), *_strides(q, k, v, out), b,
            h, n, rel_h.shape[-1], rel_w.shape[-1], d, 1.0 / math.sqrt(d),
            _stream(q.device))
    _build.check(lib, err, "flash_attention_bias")
    spans.count("flash_attention_bias")
    return out


def _flash_attention_bias_fake(q, k, v, rel_h, rel_w) -> torch.Tensor:
    return torch.empty_like(q, memory_format=torch.contiguous_format)


# ------------------------------------------------- vt::flash_attention_fwd
# Kernel 1 as a PyTorch operator: the CUDA implementation is the kernel's
# launch, the CPU one the plain version, the fake one gives the output's
# shape (q's, whatever k's and v's count of keys), dtype and layout without
# touching data (torch.export traces with
# it, so the launch never sees a FakeTensor). The ``out`` overload writes a
# given tensor instead of a new one. ``ops/upsample_argmax.py`` registers
# kernel 5 in the same namespace.
_LIB = torch.library.Library("vt", "FRAGMENT")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v) -> Tensor")
_LIB.define("flash_attention_fwd.out(Tensor q, Tensor k, Tensor v, *, "
            "Tensor(a!) out) -> Tensor(a!)")


def _launch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
    """Kernel 1 into ``out``, any layout ``_check`` admits: q and out
    (B, H, N, d), k and v (B, H, Nk, d)."""
    if out.numel() == 0:
        return out
    b, h, n, d = q.shape
    n_k = k.shape[2]
    lib = _build.load("flash_attention_fwd",
                      _SIGNATURES["flash_attention_fwd"])
    with torch.cuda.device(q.device):
        err = lib.vt_flash_attention_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), *_strides(q, k, v, out), b, h, n, n_k, d,
            1.0 / math.sqrt(d), _stream(q.device))
    _build.check(lib, err, "flash_attention")
    spans.count("flash_attention")
    return out


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    _check("flash_attention", q, keys=(k, v))
    return _launch_fwd(q, k, v, torch.empty_like(
        q, memory_format=torch.contiguous_format))


def _flash_attention_fake(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _check_out(q: torch.Tensor, out: torch.Tensor) -> None:
    if (out.shape != q.shape or out.dtype != q.dtype
            or out.device != q.device):
        raise ValueError(f"flash_attention: out must be {tuple(q.shape)} "
                         f"{q.dtype} on {q.device}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")


def _flash_attention_out_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              out: torch.Tensor) -> torch.Tensor:
    _check("flash_attention", q, out, keys=(k, v))
    return _launch_fwd(q, k, v, out)


def _flash_attention_out_cpu(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             out: torch.Tensor) -> torch.Tensor:
    _check_out(q, out)
    return out.copy_(flash_attention_plain(q, k, v))


def _flash_attention_out_fake(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              out: torch.Tensor) -> torch.Tensor:
    _check_out(q, out)
    return out


_LIB.impl("flash_attention_fwd", _flash_attention_cuda, "CUDA")
_LIB.impl("flash_attention_fwd", flash_attention_plain, "CPU")
_LIB.impl("flash_attention_fwd.out", _flash_attention_out_cuda, "CUDA")
_LIB.impl("flash_attention_fwd.out", _flash_attention_out_cpu, "CPU")
torch.library.register_fake("vt::flash_attention_fwd", _flash_attention_fake,
                            lib=_LIB)
torch.library.register_fake("vt::flash_attention_fwd.out",
                            _flash_attention_out_fake, lib=_LIB)

# The bias instantiations as an operator of their own, registered alike.
_LIB.define("flash_attention_fwd_bias(Tensor q, Tensor k, Tensor v, "
            "Tensor rel_h, Tensor rel_w) -> Tensor")
_LIB.impl("flash_attention_fwd_bias", _flash_attention_bias_cuda, "CUDA")
_LIB.impl("flash_attention_fwd_bias", flash_attention_bias_plain, "CPU")
torch.library.register_fake("vt::flash_attention_fwd_bias",
                            _flash_attention_bias_fake, lib=_LIB)
