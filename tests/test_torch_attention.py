"""PyTorch port vs the JAX package: attention.

The port's eager attention and its flash wrapper (which on a CPU tensor
runs the kernel's plain version) are held against JAX's ``_xla_attention``
and its Pallas flash kernel in interpret mode, fp32, at the tolerance of
tests/test_flash_attention.py. The CUDA kernel itself is checked on the
card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visiontransformer_tpu.ops.attention import _xla_attention
from visiontransformer_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from visiontransformer_tpu_torch.ops.attention import (
    eager_attention,
    multi_head_attention,
)
from visiontransformer_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)

ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(rng, n, d, b=1, h=2):
    return [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("n", [197, 130])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("port_fn", ["eager", "flash", "flash_plain"])
def test_attention_matches_jax(rng, n, d, port_fn):
    q, k, v = _qkv(rng, n, d)
    fn = {"eager": eager_attention, "flash": flash_attention,
          "flash_plain": flash_attention_plain}[port_fn]
    got = fn(*(torch.from_numpy(t) for t in (q, k, v))).numpy()
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    np.testing.assert_allclose(got, np.asarray(_xla_attention(jq, jk, jv)),
                               atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_flash_attention(jq, jk, jv, interpret=True)),
        atol=ATOL)


def test_strided_views_like_the_model(rng):
    # The model passes q/k/v as slices of the fused QKV projection.
    b, n, h, d = 2, 37, 3, 16
    qkv = torch.from_numpy(
        rng.standard_normal((b, n, 3, h, d)).astype(np.float32)
    ).permute(2, 0, 3, 1, 4)
    want = flash_attention_plain(*(t.contiguous() for t in qkv))
    torch.testing.assert_close(flash_attention(qkv[0], qkv[1], qkv[2]), want)


def test_bf16_eager_rounds_scale_like_jax(rng):
    # d = 80: the eager path's scale is 1/bf16(sqrt(80)), as in JAX.
    q, k, v = _qkv(rng, 21, 80)
    got = eager_attention(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)))
    want = _xla_attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("n", [3137, 1025, 197])
def test_chip_smoke_bf16_gate(rng, n):
    # chip_smoke.py's bf16 flash check passes an output that rounds P to
    # bf16 as the kernel does (the eager path), and refuses one in which
    # the padded keys of the last 32-key tile were scored as zeros.
    from chip_smoke import flash_agrees

    q, k, v = (torch.from_numpy(t).bfloat16() for t in _qkv(rng, n, 64))
    want = flash_attention_plain(q, k, v)
    assert flash_agrees(eager_attention(q, k, v), want)[0]
    pad = torch.zeros(1, 2, -n % 32, 64, dtype=torch.bfloat16)
    mis_masked = flash_attention_plain(q, torch.cat([k, pad], 2),
                                       torch.cat([v, pad], 2))
    ok, fields = flash_agrees(mis_masked, want)
    assert not ok, fields


def test_dispatch():
    q = torch.zeros(1, 1, 4, 16)
    torch.testing.assert_close(multi_head_attention(q, q, q),
                               eager_attention(q, q, q))
    with pytest.raises(ValueError):
        multi_head_attention(q, q, q, implementation="xla")
    # Neither CPU nor CUDA: the wrapper raises instead of running anything.
    m = torch.zeros(1, 1, 4, 16, device="meta")
    with pytest.raises(ValueError):
        flash_attention(m, m, m)
