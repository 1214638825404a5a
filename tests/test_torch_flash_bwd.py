"""PyTorch port: the redesigned flash-attention backward (kernels 3 and 4).

What the CPU can hold: the dropout mask (one Philox call per 2×2 block of
probabilities) against a scalar Python Philox; that the training forward,
dQ and dK/dV plain versions draw one mask; the function of (N, d, dtype)
that names a kernel instantiation; Δ computed from the forward's output
against a given Δ; gradients of the explicit wrappers against ``jax.grad``
of the JAX package's Pallas kernels in interpret mode, at sequence lengths on
the edges of the kernels' 64-row tiles; and stand-ins for what
chip_smoke.py's bf16 gate must refuse at those tile sizes. The CUDA kernels
themselves are held against the plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visiontransformer_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from visiontransformer_tpu_torch.ops import flash_attention as fa

GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
# The loss sum(out * w): both sides reduce the same 2·n·64 products in fp32,
# in their own orders, from outputs that differ by their own roundings. Such
# a sum rounds to within a small multiple of u·Σ|out·w| (u = 2^-24; a
# pairwise sum of M terms to at most ceil(log2 M)·u·Σ|x|), while |loss|, a
# sum of terms of either sign, can be far below Σ|out·w|, so the former
# bound, 1e-5·max(1, |loss|), missed at random inputs. LOSS_TOL, times
# Σ|out·w|: 2u, above twice the largest gap measured over 800 cases,
# 0.845·u·Σ|out·w| (`python tests/test_torch_flash_bwd.py 200`: seeds
# 0-199 at each n of the test, with the former bound's misses).
LOSS_TOL = 2 * 2.0 ** -24
LOSS_NS = (64, 65, 130, 197)
_M = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _philox_scalar(counter, key):
    """Philox4x32-10 on Python ints."""
    c, k = list(counter), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & _M, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & _M]
        k = [(k[0] + 0x9E3779B9) & _M, (k[1] + 0xBB67AE85) & _M]
    return c


def _keep_scalar(seed, head, row, col, rate):
    words = _philox_scalar((row >> 1, col >> 1, 0, 0), (seed & _M, head))
    word = words[2 * (row & 1) + (col & 1)]
    return (word >> 8) < fa.keep_threshold(rate)


def test_scalar_philox_known_answer():
    # Random123's known-answer vector, so the scalar oracle below is Philox.
    assert _philox_scalar((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
                          (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


@pytest.mark.parametrize("seed,n", [(11, 197), (2 ** 31 - 1, 65), (0, 1),
                                    (2 ** 40 + 5, 130)])
def test_keep_mask_matches_scalar_philox(seed, n):
    # Chosen elements: the corners, odd rows and columns, both elements of
    # a 2x2 block's diagonal, the last column and row of an odd N.
    bh, rate = 3, 0.3
    mask = fa.dropout_keep_mask(seed, bh, n, n, rate)
    assert mask.shape == (bh, n, n) and mask.dtype == torch.bool
    last = n - 1
    points = {(0, 0), (0, last), (last, 0), (last, last),
              (min(1, last), min(1, last)), (min(1, last), 0),
              (0, min(1, last)), (last // 2, last), (last, last // 2),
              (min(7, last), min(4, last)), (min(6, last), min(5, last))}
    for head in range(bh):
        for row, col in sorted(points):
            assert bool(mask[head, row, col]) == _keep_scalar(
                seed, head, row, col, rate), (head, row, col)


def test_keep_mask_odd_shape_is_a_crop():
    # The mask is one fixed function of (seed, head, row, column): a
    # smaller or rectangular request is a crop of a larger one.
    big = fa.dropout_keep_mask(5, 2, 66, 66, 0.2)
    torch.testing.assert_close(fa.dropout_keep_mask(5, 2, 65, 65, 0.2),
                               big[:, :65, :65])
    torch.testing.assert_close(fa.dropout_keep_mask(5, 2, 3, 66, 0.2),
                               big[:, :3])
    # Fewer Philox calls than probabilities: a 2x2 block is the four words
    # of one call.
    as_t = lambda x: torch.tensor(x, dtype=torch.int64)
    words = fa.philox4x32_10((as_t(3), as_t(8), as_t(0), as_t(0)),
                             (as_t(5), as_t(1)))
    block = torch.stack(words).view(2, 2)
    threshold = fa.keep_threshold(0.2)
    torch.testing.assert_close((block >> 8) < threshold, big[1, 6:8, 16:18])


def _arrays(rng, n, d=64, b=1, h=2, count=4):
    return [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for _ in range(count)]


@pytest.mark.parametrize("n", [65, 130])
def test_plain_versions_draw_one_mask(rng, n):
    # Forward, dQ and dK/dV plain versions under one (seed, rate) equal
    # autograd through plain attention with dropout_keep_mask's mask.
    rate, seed = 0.25, 19
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(rng, n))
    keep = fa.dropout_keep_mask(seed, 2, n, n, rate).view(1, 2, n, n)
    keep = keep.float() * float(torch.tensor(1 / (1 - rate),
                                             dtype=torch.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    p = torch.softmax(leaves[0] @ leaves[1].transpose(-1, -2) / 8.0, dim=-1)
    want_out = (p * keep) @ leaves[2]
    want_out.backward(do)

    out, lse = fa.flash_attention_train_plain(q, k, v, rate, seed)
    delta = fa.attention_delta_plain(do, out)
    dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, rate, seed)
    dk, dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, rate,
                                              seed)
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=0)
    for got, leaf in zip((dq, dk, dv), leaves):
        torch.testing.assert_close(got, leaf.grad, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [1, 64, 197, 256, 257, 3137])
def test_backward_path(n):
    # The instantiation is a function of head dim and dtype alone: no
    # sequence length crosses from one to another.
    bf16, f32 = torch.bfloat16, torch.float32
    assert fa.backward_path(n, 64, bf16) == "wgmma"
    assert [fa.backward_path(n, d, bf16) for d in (16, 32, 80, 128)] == [
        "stream"] * 4
    assert [fa.backward_path(n, d, f32) for d in fa.HEAD_DIMS] == [
        "scalar"] * len(fa.HEAD_DIMS)
    with pytest.raises(TypeError):
        fa.backward_path(n, 64, torch.float16)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_delta_from_out_equals_explicit_delta(rng, rate):
    n, seed = 70, 5
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(rng, n))
    out, lse = fa.flash_attention_train(q, k, v, rate, seed)
    delta = (do.float() * out.float()).sum(-1)
    want_dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, rate, seed)
    want_dk, want_dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                  rate, seed)
    dq, got_delta = fa.flash_attention_bwd_dq_delta(q, k, v, do, lse, out,
                                                    rate, seed)
    torch.testing.assert_close(got_delta, delta, atol=0, rtol=0)
    torch.testing.assert_close(dq, want_dq, atol=0, rtol=0)

    # FlashAttention.backward hands `out` over and equals the explicit-Δ
    # calls.
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, dropout_rate=rate,
                       dropout_seed=seed).backward(do)
    for leaf, want in zip(leaves, (want_dq, want_dk, want_dv)):
        torch.testing.assert_close(leaf.grad, want, atol=0, rtol=0)


def _wrapper_against_jax(seed, n):
    """(|loss gap|, Σ|out·w|, JAX's loss, port's (dq, dk, dv), JAX's) of
    the explicit wrappers against jax.grad of the JAX kernels, on the
    inputs of default_rng(seed)."""
    q, k, v, w = _arrays(np.random.default_rng(seed), n)
    tq, tk, tv, tw = (torch.from_numpy(a) for a in (q, k, v, w))
    out, lse = fa.flash_attention_train(tq, tk, tv)
    dq, delta = fa.flash_attention_bwd_dq_delta(tq, tk, tv, tw, lse, out)
    dk, dv = fa.flash_attention_bwd_dkv(tq, tk, tv, tw, lse, delta)

    loss = lambda a, b, c: jnp.sum(
        jax_flash_attention(a, b, c, interpret=True) * w)
    want_loss, want = jax.value_and_grad(loss, argnums=(0, 1, 2))(q, k, v)
    gap = abs(float((out * tw).sum()) - float(want_loss))
    return (gap, float((out * tw).abs().sum()), float(want_loss),
            (dq, dk, dv), want)


@pytest.mark.parametrize("n", LOSS_NS)
def test_wrapper_grads_match_jax(n):
    # Inputs of the case's own (seed n): the shared rng fixture would hand
    # each case the draws left by whatever ran before it on its worker.
    gap, l1, _, got, want = _wrapper_against_jax(n, n)
    assert gap <= LOSS_TOL * l1
    for name, g, gj in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj),
                                   err_msg=f"d{name}", **GRAD_TOL)


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()


@pytest.mark.parametrize("n", [197, 321])
def test_chip_smoke_gate_refuses_tile_faults(rng, n, monkeypatch):
    # Stand-ins for what a fault of the redesigned kernels would produce at
    # their tile sizes, each refused by chip_smoke.py's bf16 gradient gate:
    # a dQ that skipped one 64-key tile, a dK/dV whose last 64-query tile
    # read the rows of Q and dO past N as data, and a dropout mask shifted by
    # one column.
    from chip_smoke import grad_agrees

    rate, seed = 0.1, 23
    pad = 64 - n % 64
    q, k, v, do = (_bf16(rng, (1, 1, n + pad, 64)) for _ in range(4))
    head = lambda t: t[:, :, :n]
    hq, hk, hv, hdo = head(q), head(k), head(v), head(do)
    out, lse = fa.flash_attention_train_plain(hq, hk, hv, rate, seed)
    delta = fa.attention_delta_plain(hdo, out)
    want_dq = fa.flash_attention_bwd_dq_plain(hq, hk, hv, hdo, lse, delta,
                                              rate, seed)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_plain(
        hq, hk, hv, hdo, lse, delta, rate, seed)
    for got, want in ((want_dq, want_dq), (want_dk, want_dk)):
        assert grad_agrees(got, want)[0]

    # One 64-key tile dropped from dQ: its keys' K and V read as zero and
    # their probabilities as zero (lse is the full one, so the rest is
    # unchanged).
    scale = 1.0 / 8.0
    p = torch.exp(hq.float() @ hk.float().transpose(-1, -2) * scale
                  - lse.unsqueeze(-1))
    keep = fa.dropout_keep_mask(seed, 1, n, n, rate).view(1, 1, n, n)
    keep = keep.float() / (1.0 - rate)
    dp = (hdo.float() @ hv.float().transpose(-1, -2)) * keep
    ds = (p * (dp - delta.unsqueeze(-1))).bfloat16().float()
    ds[..., 64:128] = 0.0
    dq_bad = ((ds @ hk.float()) * scale).bfloat16()
    ok, fields = grad_agrees(dq_bad, want_dq)
    assert not ok, fields

    # The tail rows of Q and dO read as data by dK/dV, with their own lse
    # and delta.
    out_x, lse_x = fa.flash_attention_train_plain(q, hk, hv)
    delta_x = fa.attention_delta_plain(do, out_x)
    p_x = torch.exp(q.float() @ hk.float().transpose(-1, -2) * scale
                    - lse_x.unsqueeze(-1))
    keep_x = fa.dropout_keep_mask(seed, 1, n + pad, n, rate).view(
        1, 1, n + pad, n).float() / (1.0 - rate)
    dp_x = (do.float() @ hv.float().transpose(-1, -2)) * keep_x
    ds_x = (p_x * (dp_x - delta_x.unsqueeze(-1))).bfloat16().float()
    dk_bad = ((ds_x.transpose(-1, -2) @ q.float()) * scale).bfloat16()
    dv_bad = ((p_x * keep_x).bfloat16().float().transpose(-1, -2)
              @ do.float()).bfloat16()
    for got, want in ((dk_bad, want_dk), (dv_bad, want_dv)):
        ok, fields = grad_agrees(got, want)
        assert not ok, fields

    # The mask shifted by one column, in each backward kernel.
    true_mask = fa.dropout_keep_mask
    monkeypatch.setattr(fa, "dropout_keep_mask", lambda *a, **kw: torch.roll(
        true_mask(*a, **kw), 1, dims=-1))
    dq_shift = fa.flash_attention_bwd_dq_plain(hq, hk, hv, hdo, lse, delta,
                                               rate, seed)
    dk_shift, dv_shift = fa.flash_attention_bwd_dkv_plain(
        hq, hk, hv, hdo, lse, delta, rate, seed)
    for got, want in ((dq_shift, want_dq), (dk_shift, want_dk),
                      (dv_shift, want_dv)):
        ok, fields = grad_agrees(got, want)
        assert not ok, fields


def test_chip_smoke_step_gate_refuses_shifted_backward_mask(rng, monkeypatch):
    # Stand-in for the card's bf16 dropout-step check: one optimizer step of
    # a small model with attention dropout 0.1, whose backward kernels draw
    # the forward's mask one column off, is refused by chip_smoke.py's step
    # gate; the same step with one mask everywhere passes it.
    from chip_smoke import STEP_GRAD_REL_NORM, step_grads_agree
    from visiontransformer_tpu_torch import configs as tcfg
    from visiontransformer_tpu_torch.train.trainer import Trainer

    cfg = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(
        image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.1),
        num_classes=5)
    trainer = Trainer(cfg, tcfg.TrainConfig(batch_size=4,
                                            accumulate_grad_batches=1),
                      device="cpu", attn_impl="flash")
    batch = {"image": rng.random((4, 32, 32, 3), np.float32),
             "mask": rng.integers(0, 5, (4, 40, 40), dtype=np.int32)}

    def grads():
        torch.manual_seed(0)
        state = trainer.init_state()
        trainer.train_step(state, batch, seed=0)
        return {name: p.grad.detach().clone()
                for name, p in state.model.named_parameters()}

    want = grads()
    bad, norms, _ = step_grads_agree(grads(), want)
    assert not bad and max(norms.values()) == 0.0

    true_mask, true_bwd = fa.dropout_keep_mask, fa._bwd_plain

    def shifted_bwd(*args):
        with monkeypatch.context() as m:
            m.setattr(fa, "dropout_keep_mask", lambda *a, **kw: torch.roll(
                true_mask(*a, **kw), 1, dims=-1))
            return true_bwd(*args)

    monkeypatch.setattr(fa, "_bwd_plain", shifted_bwd)
    bad, norms, _ = step_grads_agree(grads(), want)
    assert bad and max(norms.values()) > STEP_GRAD_REL_NORM, norms


if __name__ == "__main__":
    # The measurement behind LOSS_TOL: the largest loss gap, in
    # u·Σ|out·w|, over seeds 0 .. argv[1] - 1 at each n of the test, and
    # how many of those cases the former bound, 1e-5·max(1, |loss|),
    # refuses.
    import sys

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    for n in LOSS_NS:
        gaps, missed = [], 0
        for seed in range(seeds):
            gap, l1, loss, _, _ = _wrapper_against_jax(seed, n)
            gaps.append(gap / (2.0 ** -24 * l1))
            missed += gap > 1e-5 * max(1.0, abs(loss))
        print(f"n = {n}: {seeds} seeds, largest gap {max(gaps):.3f} "
              f"u·Σ|out·w|, median {float(np.median(gaps)):.3f}; "
              f"1e-5·max(1, |loss|) refuses {missed}", flush=True)
