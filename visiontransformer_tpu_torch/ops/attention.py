"""Multi-head self-attention dispatch over (B, H, N, d) tensors.

- ``"eager"``: plain PyTorch attention, mirroring the TPU package's
  ``ops/attention.py:_xla_attention`` (scale rounded to the compute dtype,
  fp32 logits and softmax, probs cast to the compute dtype before P·V).
- ``"flash"``: the hand-written flash-attention kernel
  (``ops/flash_attention.py``); its plain version on a CPU tensor.
- ``"auto"``: flash on a CUDA tensor at every sequence length, eager on the
  CPU. The TPU package's ``N >= 512`` threshold was a TPU measurement and
  is not carried over.
"""

from __future__ import annotations

import torch

from visiontransformer_tpu_torch.ops.flash_attention import flash_attention

IMPLEMENTATIONS = ("auto", "eager", "flash")


def eager_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    head_dim = torch.tensor(float(q.shape[-1]), dtype=torch.float32)
    scale = float(1.0 / torch.sqrt(head_dim).to(q.dtype))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, implementation: str = "auto") -> torch.Tensor:
    if implementation == "auto":
        implementation = "flash" if q.is_cuda else "eager"
    if implementation == "flash":
        return flash_attention(q, k, v)
    if implementation == "eager":
        return eager_attention(q, k, v)
    raise ValueError(f"unknown attention implementation {implementation!r}; "
                     f"known: {IMPLEMENTATIONS}")
