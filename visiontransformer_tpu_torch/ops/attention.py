"""Multi-head attention dispatch over (B, H, N, d) queries and (B, H, Nk, d)
keys and values (Nk = N but in MiT's spatial-reduction attention).

- ``"eager"``: plain PyTorch attention, mirroring the TPU package's
  ``ops/attention.py:_xla_attention`` (scale rounded to the compute dtype,
  fp32 logits and softmax, dropout on the fp32 probs, probs cast to the
  compute dtype before P·V).
- ``"flash"``: the hand-written flash-attention kernels
  (``ops/flash_attention.py``; their plain versions on a CPU tensor), with
  dropout inside the kernels; the dropout seed is drawn from the generator
  as an int64 scalar on the generator's device, so drawing it never waits
  for the card.
- ``"auto"``: flash on a CUDA tensor at every sequence length, eager on the
  CPU (``resolve_implementation``). The TPU package's ``N >= 512``
  threshold was a TPU measurement and is not carried over.

Dropout applies only when ``deterministic`` is False and the rate is above
0, and then needs an explicit ``torch.Generator``.

Attention with SAM's decomposed relative-position bias (``models/sam.py``)
has a dispatch of its own, ``biased_attention_path``: kernel 1's bias
instantiation (``flash_attention_bias``) where it takes the call, else its
plain version, which materialises the bias and the logits in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from visiontransformer_tpu_torch.ops.flash_attention import (
    bias_kernel_takes,
    flash_attention,
    needs_grad,
)

IMPLEMENTATIONS = ("auto", "eager", "flash")
# Attention dropout seeds are drawn in [0, 2^31).
_SEED_BOUND = 2 ** 31


def eager_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    dropout_rate: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    deterministic: bool = True) -> torch.Tensor:
    head_dim = torch.tensor(float(q.shape[-1]), dtype=torch.float32)
    scale = float(1.0 / torch.sqrt(head_dim).to(q.dtype))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    if not deterministic and dropout_rate > 0.0:
        keep = 1.0 - dropout_rate
        mask = torch.rand(probs.shape, generator=_required(generator),
                          device=probs.device) < keep
        probs = torch.where(mask, probs / keep, 0.0)
    return torch.matmul(probs.to(q.dtype), v)


def _required(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator "
                         "(or deterministic=True)")
    return generator


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """An int64 scalar in [0, 2^31) from ``generator``, on its device."""
    return torch.randint(0, _SEED_BOUND, (), generator=generator,
                         device=generator.device)


def resolve_implementation(implementation: str, q: torch.Tensor) -> str:
    """"flash" or "eager": the path ``implementation`` takes for q."""
    if implementation == "auto":
        return "flash" if q.is_cuda else "eager"
    if implementation in IMPLEMENTATIONS:
        return implementation
    raise ValueError(f"unknown attention implementation {implementation!r}; "
                     f"known: {IMPLEMENTATIONS}")


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, implementation: str = "auto",
                         dropout_rate: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         deterministic: bool = True,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out``, if given, is a (B, H, N, d) tensor in q's dtype, on its
    device, that receives the output and is returned: the inference
    kernel writes it directly (``flash_attention``); the other paths
    compute their output, then copy it in."""
    implementation = resolve_implementation(implementation, q)
    if implementation == "flash":
        if deterministic or dropout_rate == 0.0:
            return flash_attention(q, k, v, out=out)
        return _into(out, flash_attention(
            q, k, v, dropout_rate=dropout_rate,
            dropout_seed=draw_seed(_required(generator))))
    return _into(out, eager_attention(
        q, k, v, dropout_rate=dropout_rate, generator=generator,
        deterministic=deterministic))


def _into(out: Optional[torch.Tensor], y: torch.Tensor) -> torch.Tensor:
    return y if out is None else out.copy_(y)


def biased_attention_path(implementation: str, q: torch.Tensor,
                          k: torch.Tensor, rel_h: torch.Tensor,
                          rel_w: torch.Tensor) -> str:
    """"flash" or "eager": the path attention with SAM's bias takes.
    "flash" where ``implementation`` resolves to it and, on a CUDA tensor,
    kernel 1's bias instantiation takes the call (``bias_kernel_takes``),
    or, on the CPU, no gradient is taken (the custom op's CPU
    implementation is the plain version); "eager", the plain version
    called directly (``flash_attention_bias_plain``, autograd through it),
    otherwise."""
    if resolve_implementation(implementation, q) == "flash" and (
            bias_kernel_takes(q, k, rel_h, rel_w) if q.is_cuda
            else not needs_grad(q, k, rel_h, rel_w)):
        return "flash"
    return "eager"
