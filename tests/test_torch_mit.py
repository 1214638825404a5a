"""PyTorch port vs the JAX package: the MiT encoder (models/mit.py).

The port's ``mit_encoder_apply`` (NCHW features) against the JAX one
(NHWC) on the same mit_b0 weights at 64^2 and at 37x53, fp32, atol 2e-5 /
rtol 1e-4; the odd, non-square size is the one where a transposed
token order or SAME padding in place of MiT's symmetric k // 2 would show.
Besides: the presets, one efficient-attention block at both reduction
paths, the explicit padding of ``conv2d_nchw`` against XLA's, and the
LayerNorm eps of 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visiontransformer_tpu.models import mit as jmit
from visiontransformer_tpu.nn.layers import conv2d as jconv2d
from visiontransformer_tpu_torch.ckpt.convert import conv_params_from_jax
from visiontransformer_tpu_torch.models import mit as tmit
from visiontransformer_tpu_torch.nn.layers import (
    ParamTree,
    _same_padding,
    conv2d_nchw,
)

ATOL, RTOL = 2e-5, 1e-4
SIZES = [(64, 64), (37, 53)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_tree(init_tree: dict, jax_params) -> ParamTree:
    """The port's tree of ``init_tree``'s shapes holding the JAX values."""
    tree = ParamTree(init_tree)
    tree.load_state_dict(conv_params_from_jax(jax_params), strict=True)
    return tree


@pytest.fixture(scope="module")
def encoder():
    """(JAX mit_b0 params with numpy leaves, the port's tree holding them)."""
    keys = iter(jax.random.split(jax.random.PRNGKey(0), 2048))
    params = jax.tree_util.tree_map(np.asarray,
                                    jmit.mit_encoder_init(keys, "mit_b0"))
    return params, _port_tree(tmit.mit_encoder_init(
        torch.Generator().manual_seed(0), "mit_b0"), params)


def test_presets_equal_jax():
    assert tmit.MIT_PRESETS == jmit.MIT_PRESETS
    assert tmit.LN_EPS == jmit._LN_EPS == 1e-5


@pytest.mark.parametrize("size", SIZES)
def test_features_match_jax(encoder, size):
    params, model = encoder
    x = np.random.default_rng(sum(size)).standard_normal(
        (2,) + size + (3,)).astype(np.float32)
    want = jmit.mit_encoder_apply(params, jnp.asarray(x), "mit_b0")
    with torch.no_grad():
        got = tmit.mit_encoder_apply(
            model, torch.from_numpy(x).permute(0, 3, 1, 2), "mit_b0")
    dims = tmit.MIT_PRESETS["mit_b0"][0]
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape[1] == dims[i]
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   atol=ATOL, rtol=RTOL,
                                   err_msg=f"OS-{4 << i}")


@pytest.mark.parametrize("sr", [1, 4])
def test_efficient_attention_matches_jax(sr):
    keys = iter(jax.random.split(jax.random.PRNGKey(sr), 16))
    params = jax.tree_util.tree_map(np.asarray,
                                    jmit._attn_init(keys, 64, sr))
    x = np.random.default_rng(sr).standard_normal((2, 9, 13, 64)).astype(
        np.float32)
    want = np.asarray(jmit._attn_apply(params, jnp.asarray(x), 2, sr))
    tree = _port_tree(tmit._attn_init(torch.Generator(), 64, sr), params)
    tokens = torch.from_numpy(x).reshape(2, 9 * 13, 64)
    with torch.no_grad():
        got = tmit._attn_apply(tree, tokens, 9, 13, 2, sr)
    np.testing.assert_allclose(got.reshape(2, 9, 13, 64).numpy(), want,
                               atol=ATOL, rtol=RTOL)


def test_explicit_padding_is_not_same():
    # MiT's stage-1 embedding at 224: SAME would pad (1, 2), MiT pads (3, 3).
    # (At 37 and 53 SAME pads (3, 3) too; 40 and 56 pad (1, 2).)
    assert _same_padding(224, 7, 4, 1) == (1, 2)
    assert _same_padding(37, 7, 4, 1) == _same_padding(53, 7, 4, 1) == (3, 3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 40, 56, 3)).astype(np.float32)
    kernel = rng.standard_normal((7, 7, 3, 8)).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    p = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    kt = torch.from_numpy(kernel).permute(3, 2, 0, 1)
    want = np.asarray(jconv2d(p, jnp.asarray(x), stride=4,
                              padding=[(3, 3), (3, 3)]))
    got = conv2d_nchw(xt, kt, torch.from_numpy(bias), stride=4,
                      padding=(3, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=ATOL, rtol=RTOL)
    same = conv2d_nchw(xt, kt, torch.from_numpy(bias), stride=4)
    assert same.shape == got.shape and not torch.allclose(same, got)
