"""PyTorch port vs the JAX package: the flash-attention training kernels.

On the CPU the port's training-forward, dQ and dK/dV wrappers run their
plain versions, and ``FlashAttention`` (the autograd Function joining them)
runs those. They are held against the JAX package's ``_fwd`` with
``need_lse=True`` and ``jax.grad`` of its Pallas ``flash_attention``, both in
interpret mode, at the tolerances of tests/test_flash_attention.py. Dropout
is checked against autograd of plain attention with the same explicit
per-element mask, and by statistics. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visiontransformer_tpu.ops.flash_attention import _fwd as jax_fwd
from visiontransformer_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from visiontransformer_tpu_torch.ops.attention import eager_attention
from visiontransformer_tpu_torch.ops.flash_attention import (
    dropout_keep_mask,
    flash_attention,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq_plain,
    flash_attention_train,
    flash_attention_train_plain,
    keep_threshold,
    philox4x32_10,
)

FWD_ATOL = 2e-5
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(rng, n, d=64, b=1, h=2, count=3):
    return [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for _ in range(count)]


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def _plain_attention(q, k, v, keep_scale=None):
    """softmax(QKᵀ/√d) (times an explicit mask / keep) · V, fp32."""
    p = torch.softmax(q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5, dim=-1)
    return (p if keep_scale is None else p * keep_scale) @ v


@pytest.mark.parametrize("n", [64, 130, 197])
@pytest.mark.parametrize("fn", [flash_attention_train_plain,
                                flash_attention_train])
def test_train_forward_matches_jax(rng, n, fn):
    q, k, v = _arrays(rng, n)
    out, lse = fn(*(torch.from_numpy(a) for a in (q, k, v)))
    merge = lambda a: jnp.asarray(a.reshape(2, n, 64))
    jout, jlse = jax_fwd(merge(q), merge(k), merge(v), jnp.zeros((1,)),
                         block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(out.numpy().reshape(2, n, 64),
                               np.asarray(jout), atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy().reshape(2, n), np.asarray(jlse),
                               atol=FWD_ATOL)


@pytest.mark.parametrize("n", [64, 130, 197])
def test_function_grads_match_jax_and_eager(rng, n):
    q, k, v, w = _arrays(rng, n, count=4)
    leaves = _leaves(q, k, v)
    (flash_attention(*leaves) * torch.from_numpy(w)).sum().backward()
    got = [t.grad.numpy() for t in leaves]

    want = jax.grad(lambda a, b, c: jnp.sum(
        jax_flash_attention(a, b, c, interpret=True) * w),
        argnums=(0, 1, 2))(q, k, v)
    eager = _leaves(q, k, v)
    (eager_attention(*eager) * torch.from_numpy(w)).sum().backward()
    for name, g, gj, ge in zip("qkv", got, want, eager):
        np.testing.assert_allclose(g, np.asarray(gj), err_msg=f"d{name}",
                                   **GRAD_TOL)
        np.testing.assert_allclose(g, ge.grad.numpy(), err_msg=f"d{name}",
                                   **GRAD_TOL)


def test_philox_known_answers():
    # Random123's known-answer vectors for philox4x32_10.
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    as_t = lambda xs: tuple(torch.tensor(x, dtype=torch.int64) for x in xs)
    for counter, key, want in cases:
        got = philox4x32_10(as_t(counter), as_t(key))
        assert tuple(int(x) for x in got) == want


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_backward_matches_autograd_with_mask(rng, rate):
    n, seed = 130, 11
    q, k, v, w = _arrays(rng, n, count=4)
    keep_scale = dropout_keep_mask(seed, 2, n, n, rate).view(1, 2, n, n)
    keep_scale = keep_scale.float() * float(
        torch.tensor(1 / (1 - rate), dtype=torch.float32))
    ref = _leaves(q, k, v)
    want_out = _plain_attention(*ref, keep_scale)
    (want_out * torch.from_numpy(w)).sum().backward()
    got = _leaves(q, k, v)
    out = flash_attention(*got, dropout_rate=rate, dropout_seed=seed)
    (out * torch.from_numpy(w)).sum().backward()
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=0)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=0)


def test_dropout_seeds_and_statistics(rng):
    n = 130
    q, k, v = (torch.from_numpy(a) for a in _arrays(rng, n))
    base = flash_attention(q, k, v)
    a = flash_attention(q, k, v, dropout_rate=0.3, dropout_seed=7)
    b = flash_attention(q, k, v, dropout_rate=0.3,
                        dropout_seed=torch.tensor(7))
    c = flash_attention(q, k, v, dropout_rate=0.3, dropout_seed=8)
    torch.testing.assert_close(a, b, atol=0, rtol=0)   # same seed
    assert float((a - c).abs().max()) > 1e-4           # another seed
    assert float((a - base).abs().max()) > 1e-4        # something dropped
    # Unbiased: the mean over many seeds approaches the undropped output
    # (the bound of tests/test_flash_attention.py).
    mean = sum(flash_attention(q, k, v, dropout_rate=0.3, dropout_seed=s)
               for s in range(48)) / 48
    err = float((mean - base).abs().mean())
    assert err < 0.12 * float(base.abs().mean())
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, k, v, dropout_rate=0.1)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_kept_fraction_within_4_sigma(rate):
    bh, n = 4, 197
    kept = float(dropout_keep_mask(3, bh, n, n, rate).float().mean())
    keep = 1 - rate
    sigma = (keep * rate / (bh * n * n)) ** 0.5
    assert abs(kept - keep) < 4 * sigma, (kept, keep, sigma)
    assert keep_threshold(0.0) == 1 << 24
    with pytest.raises(ValueError):
        keep_threshold(1.0)


@pytest.mark.parametrize("n", [65, 197])
def test_dropout_function_matches_autograd_at_odd_n(rng, n):
    # As test_dropout_backward_matches_autograd_with_mask, at odd N: the
    # last row and column are half of a 2x2 Philox block.
    rate, seed = 0.2, 29
    q, k, v, w = _arrays(rng, n, count=4)
    keep_scale = dropout_keep_mask(seed, 2, n, n, rate).view(1, 2, n, n)
    keep_scale = keep_scale.float() * float(
        torch.tensor(1 / (1 - rate), dtype=torch.float32))
    ref = _leaves(q, k, v)
    want_out = _plain_attention(*ref, keep_scale)
    (want_out * torch.from_numpy(w)).sum().backward()
    got = _leaves(q, k, v)
    out = flash_attention(*got, dropout_rate=rate, dropout_seed=seed)
    (out * torch.from_numpy(w)).sum().backward()
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=0)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(197, 197), (1, 3137), (3137, 1)])
def test_kept_fraction_of_each_word_within_4_sigma(shape):
    # Each of the four words of a Philox call serves one parity class of
    # (row, column); every class keeps its share.
    rate, (rows, cols) = 0.1, shape
    mask = dropout_keep_mask(9, 4, rows, cols, rate).float()
    for i in range(min(2, rows)):
        for j in range(min(2, cols)):
            part = mask[:, i::2, j::2]
            sigma = ((1 - rate) * rate / part.numel()) ** 0.5
            assert abs(float(part.mean()) - (1 - rate)) < 4 * sigma, (i, j)


def test_dropout_gradients_match_finite_difference(rng):
    n = 64
    q, k, v, w = _arrays(rng, n, h=1, count=4)
    k_t, v_t, w_t = (torch.from_numpy(a) for a in (k, v, w))

    def f(qq):
        return (flash_attention(qq, k_t, v_t, dropout_rate=0.25,
                                dropout_seed=3) * w_t).sum()

    leaf = torch.from_numpy(q).requires_grad_()
    f(leaf).backward()
    eps = 1e-3
    for idx in [(0, 0, 0, 0), (0, 0, 10, 5), (0, 0, 63, 63), (0, 0, 31, 17)]:
        dq = np.zeros_like(q)
        dq[idx] = eps
        with torch.no_grad():
            fd = (float(f(torch.from_numpy(q + dq)))
                  - float(f(torch.from_numpy(q - dq)))) / (2 * eps)
        ad = float(leaf.grad[idx])
        assert abs(fd - ad) < 5e-2 * max(1.0, abs(fd)), (idx, fd, ad)


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()


@pytest.mark.parametrize("n", [3137, 197])
def test_chip_smoke_bf16_backward_gate(rng, n):
    # chip_smoke.py's bf16 check of the backward kernels passes gradients
    # whose sums ran in another order (queries or keys permuted, as a
    # kernel's tiling reorders them), and refuses ones in which the rows of
    # the last 32-row tile past N were read as real data instead of masked.
    from chip_smoke import grad_agrees

    pad = 32 - n % 32
    q, k, v, do = (_bf16(rng, (1, 1, n + pad, 64)) for _ in range(4))
    head = lambda t: t[:, :, :n]
    out, lse = flash_attention_train_plain(head(q), head(k), head(v))
    delta = (head(do).float() * out.float()).sum(-1)
    want_dq = flash_attention_bwd_dq_plain(head(q), head(k), head(v),
                                           head(do), lse, delta)
    want_dk, want_dv = flash_attention_bwd_dkv_plain(
        head(q), head(k), head(v), head(do), lse, delta)

    perm = torch.from_numpy(rng.permutation(n))
    dq_perm = flash_attention_bwd_dq_plain(head(q), k[:, :, perm],
                                           v[:, :, perm], head(do), lse,
                                           delta)
    dk_perm, dv_perm = flash_attention_bwd_dkv_plain(
        q[:, :, perm], head(k), head(v), do[:, :, perm], lse[:, :, perm],
        delta[:, :, perm])
    for got, want in ((dq_perm, want_dq), (dk_perm, want_dk),
                      (dv_perm, want_dv)):
        assert grad_agrees(got, want)[0]

    # Unmasked tail: dQ sums over keys n..n+pad too; dK/dV over queries
    # n..n+pad, with those rows' own lse and delta.
    dq_bad = flash_attention_bwd_dq_plain(head(q), k, v, head(do), lse, delta)
    out_x, lse_x = flash_attention_train_plain(q, head(k), head(v))
    delta_x = (do.float() * out_x.float()).sum(-1)
    dk_bad, dv_bad = flash_attention_bwd_dkv_plain(q, head(k), head(v), do,
                                                   lse_x, delta_x)
    for got, want in ((dq_bad, want_dq), (dk_bad, want_dk),
                      (dv_bad, want_dv)):
        ok, fields = grad_agrees(got, want)
        assert not ok, fields
