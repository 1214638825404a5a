"""Token merging (ToMe-style bipartite soft matching) between encoder blocks.

The TPU package's ``ops/token_merge.py``: after each block the r most
similar (source, destination) token pairs are merged by a size-weighted
mean, so layer l runs at N - l·r tokens (every shape static); the final
``unmerge`` gathers each original position's representative, so the
dense head sees all positions. The CLS token is never merged. Odd body
positions are sources, even body positions destinations; each source is
scored by the cosine similarity of its best destination, computed on
``x / (|x| + 1e-6)`` in the activation dtype and then in fp32.

Kept as in the TPU package, so both choose the same merges:

- ``r_eff = min(r, na - 1)``: at least one source token stays;
- sources ranked by a stable sort of -best score (ties keep position
  order), partners by the first maximum;
- the fold of merged sources into destinations as one-hot products;
- the norm's roundings at bf16 (``merge_step``), so that the choices
  equal the TPU package's there too on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class MergeState(NamedTuple):
    """sizes: (B, n) fp32, the original tokens each current token stands
    for; assign: (B, N0) int64, each original position's index into the
    current tokens."""
    sizes: torch.Tensor
    assign: torch.Tensor


def init_merge_state(batch: int, n_tokens: int,
                     device: Optional[torch.device] = None) -> MergeState:
    return MergeState(
        sizes=torch.ones(batch, n_tokens, device=device),
        assign=torch.arange(n_tokens, device=device).expand(batch, -1))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, i]] along dim 1, for (B, n) and (B, n, H) x."""
    if x.dim() == 3:
        idx = idx[..., None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx)


def merge_step(x: torch.Tensor, state: MergeState, r: int):
    """Merge the r most similar (source, destination) pairs of x (B, n, H),
    CLS at position 0. Returns (x_new (B, n - r_eff, H), new MergeState);
    the new order is CLS, destinations, kept sources."""
    b, n, _ = x.shape
    n_body = n - 1
    na = (n_body + 1) // 2  # sources: x positions 1, 3, 5, ...
    nb = n_body // 2        # destinations: x positions 2, 4, 6, ...
    r_eff = min(r, na - 1)
    if r_eff <= 0 or nb == 0:
        return x, state

    a, dst = x[:, 1::2], x[:, 2::2]
    size_a, size_b = state.sizes[:, 1::2], state.sizes[:, 2::2]

    # The norm as XLA computes the TPU package's bf16 norm: squares and
    # their sum in fp32, the sum rounded to the activation dtype, then the
    # root (bit for bit with it on the CPU; torch.linalg.vector_norm rounds
    # once, after the root, and differs on a tenth of bf16 tokens).
    norm = x.float().square().sum(dim=-1, keepdim=True).to(x.dtype).sqrt()
    metric = x / (norm + 1e-6)
    sim = torch.bmm(metric[:, 1::2].float(),
                    metric[:, 2::2].float().transpose(1, 2))  # (B, na, nb)
    best_sim = sim.amax(dim=-1)
    partner = torch.argmax(sim, dim=-1)  # the first maximum

    order = torch.argsort(-best_sim, dim=-1, stable=True)
    sel, keep = order[:, :r_eff], order[:, r_eff:]
    a_keep, size_keep = _take(a, keep), _take(size_a, keep)
    a_sel, size_sel = _take(a, sel), _take(size_a, sel)
    partner_sel = _take(partner, sel)  # (B, r)

    # Fold the sources into their destinations by one-hot products.
    w = F.one_hot(partner_sel, nb).float().transpose(1, 2)  # (B, nb, r)
    num = (dst.float() * size_b[..., None]
           + torch.bmm(w, a_sel.float() * size_sel[..., None]))
    den = size_b + torch.bmm(w, size_sel[..., None])[..., 0]
    b_new = (num / den[..., None]).to(x.dtype)

    x_new = torch.cat([x[:, :1], b_new, a_keep], dim=1)
    sizes_new = torch.cat([state.sizes[:, :1], den, size_keep], dim=1)

    # Old token index -> new token index, then composed with assign. CLS
    # stays 0, destination 2 + 2j goes to 1 + j, a kept source to 1 + nb +
    # its rank, a merged source to its destination's new index.
    old2new = torch.zeros(b, n, dtype=torch.int64, device=x.device)
    old2new[:, 2::2] = 1 + torch.arange(nb, device=x.device)
    old2new.scatter_(1, 1 + 2 * keep, (1 + nb + torch.arange(
        na - r_eff, device=x.device)).expand(b, -1))
    old2new.scatter_(1, 1 + 2 * sel, 1 + partner_sel)
    return x_new, MergeState(sizes=sizes_new,
                             assign=torch.gather(old2new, 1, state.assign))


def unmerge(x: torch.Tensor, state: MergeState) -> torch.Tensor:
    """(B, n, H) merged tokens -> (B, N0, H): every original position gets
    its representative's state."""
    return _take(x, state.assign)
