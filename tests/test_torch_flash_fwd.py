"""PyTorch port: the redesigned flash-attention forward (kernels 1 and 2).

What the CPU can hold: the port's inference and training forward (their
plain versions, which the wrappers run on a CPU tensor) against the JAX
package's ``_fwd`` in interpret mode, with and without lse, at sequence
lengths on the edges of the kernels' 64-row and 64-key tiles; the function
of (N, d, dtype) that names a kernel instantiation; and stand-ins for what
chip_smoke.py's bf16 forward gate (``flash_agrees``) and its lse tolerance
must refuse at those tile sizes. The CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visiontransformer_tpu.ops.flash_attention import _fwd as jax_fwd
from visiontransformer_tpu_torch.ops import flash_attention as fa

FWD_ATOL = 2e-5  # tests/test_flash_attention.py:30
TILE = 64        # keys per tile and query rows per warpgroup on the card


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(rng, n, d, h=2):
    return [rng.standard_normal((1, h, n, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("need_lse", [True, False])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [1, 63, 65, 127, 129, 257])
def test_forward_matches_jax(rng, n, d, need_lse):
    q, k, v = _arrays(rng, n, d)
    merge = lambda a: jnp.asarray(a.reshape(2, n, d))
    jout, jlse = jax_fwd(merge(q), merge(k), merge(v), jnp.zeros((1,)),
                         block_q=128, block_k=128, interpret=True,
                         need_lse=need_lse)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    if need_lse:
        got = [fa.flash_attention_train_plain(tq, tk, tv),
               fa.flash_attention_train(tq, tk, tv)]
    else:
        got = [(fa.flash_attention_plain(tq, tk, tv), None),
               (fa.flash_attention(tq, tk, tv, dropout_rate=0.0), None)]
    for out, lse in got:
        np.testing.assert_allclose(out.numpy().reshape(2, n, d),
                                   np.asarray(jout), atol=FWD_ATOL)
        if need_lse:
            np.testing.assert_allclose(lse.numpy().reshape(2, n),
                                       np.asarray(jlse), atol=FWD_ATOL)
        else:
            assert jlse is None


@pytest.mark.parametrize("n", [1, 197, 3137])
def test_forward_path(n):
    # One instantiation per head dim and dtype, at every N, named as the
    # backward's are.
    bf16, f32 = torch.bfloat16, torch.float32
    assert fa.forward_path(n, 64, bf16) == "wgmma"
    assert [fa.forward_path(n, d, bf16) for d in (16, 32, 80, 128)] == [
        "stream"] * 4
    assert [fa.forward_path(n, d, f32) for d in fa.HEAD_DIMS] == [
        "scalar"] * len(fa.HEAD_DIMS)
    for dtype in (bf16, f32):
        assert [fa.forward_path(n, d, dtype) for d in fa.HEAD_DIMS] == [
            fa.backward_path(n, d, dtype) for d in fa.HEAD_DIMS]
    with pytest.raises(TypeError):
        fa.forward_path(n, 64, torch.float16)


# ------------------------------------------------- stand-ins for the gates
def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()


def _attend(q, k, v, keep=None, n_valid=None):
    """The training forward's arithmetic, as flash_attention_train_plain
    does it, over the keys of k and v: keys from n_valid on are masked, and
    keep (rows x keys, mask / keep) multiplies p before P V."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(
        q.shape[-1])
    if n_valid is not None:
        s[..., n_valid:] = -torch.inf
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if keep is not None:
        p = p * keep
    out = torch.matmul(p.to(q.dtype).float(), v.float()) / l
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _keep(seed, rate, n_rows, n_cols):
    mask = fa.dropout_keep_mask(seed, 1, n_rows, n_cols, rate)
    return mask.view(1, 1, n_rows, n_cols).float() / (1.0 - rate)


RATE, SEED = 0.1, 23


def _faulty(fault, q, k, v, want, want_lse, monkeypatch):
    """(out, lse) of a kernel with the named fault, on these inputs."""
    n = q.shape[2]
    if fault == "last_tile_dropped":
        cut = TILE * ((n - 1) // TILE)
        return _attend(q, k, v, _keep(SEED, RATE, n, n), n_valid=cut)
    if fault == "keys_past_n_as_data":
        # The last tile's keys past N read as zero rows of K and V: they
        # score 0 and enter the denominator.
        pad = -n % TILE
        zeros = torch.zeros(1, 1, pad, q.shape[-1], dtype=q.dtype)
        return _attend(q, torch.cat([k, zeros], 2), torch.cat([v, zeros], 2),
                       _keep(SEED, RATE, n, n + pad))
    if fault == "lse_in_log2":
        return want, want_lse / math.log(2.0)
    if fault == "slab_on_neighbour":
        out = want.clone()
        out[:, :, 16:32] = want[:, :, 0:16]
        return out, want_lse
    assert fault == "mask_one_column_off"
    true_mask = fa.dropout_keep_mask
    monkeypatch.setattr(fa, "dropout_keep_mask", lambda *a, **kw: torch.roll(
        true_mask(*a, **kw), 1, dims=-1))
    return fa.flash_attention_train_plain(q, k, v, RATE, SEED)


@pytest.mark.parametrize("fault", ["last_tile_dropped", "keys_past_n_as_data",
                                   "lse_in_log2", "slab_on_neighbour",
                                   "mask_one_column_off"])
@pytest.mark.parametrize("n", [197, 321])
def test_chip_smoke_gates_refuse_tile_faults(rng, n, fault, monkeypatch):
    # What a fault of the redesigned forward at its 64-key and 64-row tiles
    # would produce, each refused by chip_smoke.py's bf16 output gate or its
    # lse tolerance; the stand-ins' own arithmetic, fault-free, passes both.
    from chip_smoke import LSE_ATOL, close, flash_agrees

    q, k, v = (_bf16(rng, (1, 1, n, 64)) for _ in range(3))
    want, want_lse = fa.flash_attention_train_plain(q, k, v, RATE, SEED)
    out, lse = _attend(q, k, v, _keep(SEED, RATE, n, n))
    assert flash_agrees(out, want)[0]
    assert close(lse, want_lse, LSE_ATOL, 0.0)[0]

    out, lse = _faulty(fault, q, k, v, want, want_lse, monkeypatch)
    out_ok, fields = flash_agrees(out, want)
    lse_ok, lse_err = close(lse, want_lse, LSE_ATOL, 0.0)
    assert not (out_ok and lse_ok), (fields, lse_err)
    if fault in ("last_tile_dropped", "keys_past_n_as_data"):
        assert not out_ok and not lse_ok, (fields, lse_err)


@pytest.mark.parametrize("n", [197, 321])
def test_chip_smoke_gate_passes_keys_in_another_order(rng, n):
    # Without dropout the result does not depend on the order in which the
    # keys are summed, as a kernel's tiling reorders them: the gates pass it.
    from chip_smoke import LSE_ATOL, close, flash_agrees

    q, k, v = (_bf16(rng, (1, 1, n, 64)) for _ in range(3))
    want, want_lse = fa.flash_attention_train_plain(q, k, v)
    perm = torch.from_numpy(rng.permutation(n))
    out, lse = fa.flash_attention_train_plain(q, k[:, :, perm], v[:, :, perm])
    assert flash_agrees(out, want)[0]
    assert close(lse, want_lse, LSE_ATOL, 0.0)[0]
