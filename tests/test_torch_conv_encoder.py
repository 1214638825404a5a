"""PyTorch port vs the JAX package: the shared encoder of the conv families.

GroupNorm's choice of groups (widths that reach its decrement), the
depthwise conv at strides 1 and 2 on odd and even sizes (XLA's SAME pads
(0, 1) at stride 2 on an even size), each of the four block kinds, and
``encoder_apply``'s features and skips at all six encoder presets, held
against the JAX functions at fp32 on the same numpy inputs and a JAX
parameter tree through the weight bridge (HWIO -> OIHW).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visiontransformer_tpu.models import unet as junet
from visiontransformer_tpu.nn import layers as jlayers
from visiontransformer_tpu_torch.ckpt.convert import conv_params_from_jax
from visiontransformer_tpu_torch.models import unet as tunet
from visiontransformer_tpu_torch.nn import layers as tlayers
from visiontransformer_tpu_torch.nn.layers import ParamTree

# fp32 activations of a few convs deep: the CPU conv library sums in
# another order than XLA (ROADMAP.md section 3); measured below 2e-6.
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)  # writable copies


def _port_tree(jax_tree, port_tree: dict) -> ParamTree:
    """The port's ParamTree of ``port_tree``'s shapes holding the JAX
    tree's values."""
    module = ParamTree(port_tree)
    module.load_state_dict(conv_params_from_jax(jax_tree), strict=True)
    return module


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [12, 20, 4, 32])
def test_group_norm_matches_jax(channels, dtype):
    rng = np.random.default_rng(channels)
    # groups=8: 12 channels take 6 groups, 20 take 5 (the decrement), 4
    # take 4 (min), 32 take 8.
    x = (3 * rng.standard_normal((2, 5, 6, channels)) + 1).astype(np.float32)
    params = {"scale": rng.standard_normal(channels).astype(np.float32),
              "bias": rng.standard_normal(channels).astype(np.float32)}
    want = junet._group_norm(params, jnp.asarray(x, dtype), 8)
    got = tunet.group_norm(
        {k: torch.from_numpy(v) for k, v in params.items()},
        _nchw(x).to(getattr(torch, dtype)), 8)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = _nhwc(got.float())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    else:  # one bf16 rounding of the same fp32 value, at most an ulp apart
        np.testing.assert_allclose(got, want, atol=0,
                                   rtol=2.0 ** -7)
        assert np.mean(got == want) > 0.99


def test_group_norm_choice_of_groups():
    # The group count reached by the decrement changes the result: 12
    # channels at groups=8 normalise in 6 groups of 2, not 4 of 3.
    x = torch.randn(1, 12, 3, 3, generator=torch.Generator().manual_seed(0))
    p = {"scale": torch.ones(12), "bias": torch.zeros(12)}
    got = tunet.group_norm(p, x, 8)
    torch.testing.assert_close(got, torch.nn.functional.group_norm(
        x, 6, eps=1e-5), atol=1e-6, rtol=0)
    assert (got - torch.nn.functional.group_norm(x, 4, eps=1e-5)).abs().max() > 0.1


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_matches_jax(stride, size):
    rng = np.random.default_rng(size)
    c = 6
    params = _np(jlayers.depthwise_init(jax.random.PRNGKey(size), c, 3))
    params["bias"] = rng.standard_normal(c).astype(np.float32)
    x = rng.standard_normal((2, size, size + 1, c)).astype(np.float32)
    want = np.asarray(jlayers.depthwise(params, jnp.asarray(x), stride=stride))
    got = tlayers.depthwise(torch.from_numpy(x),
                            torch.from_numpy(params["kernel"]),
                            torch.from_numpy(params["bias"]), stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # The NCHW form inside the conv families, on the bridged OIHW kernel.
    oihw = conv_params_from_jax({"dw": params})
    nchw = tunet._depthwise({"kernel": oihw["dw.kernel"],
                             "bias": oihw["dw.bias"]}, _nchw(x),
                            stride=stride)
    np.testing.assert_allclose(_nhwc(nchw), want, atol=1e-6, rtol=0)


def test_same_padding_at_stride_2_is_xla_s():
    # k = 3 at stride 2 on an even size pads (0, 1); a symmetric (1, 1)
    # would shift every output by a pixel.
    assert tlayers._same_padding(8, 3, 2, 1) == (0, 1)
    assert tlayers._same_padding(7, 3, 2, 1) == (1, 1)
    assert tlayers._same_padding(8, 7, 2, 1) == (2, 3)
    assert tlayers._same_padding(4, 5, 2, 1) == (1, 2)
    assert tlayers._same_padding(8, 3, 1, 4) == (4, 4)


BLOCKS = {
    # kind: (JAX init, port init, cin, cout)
    "basic_proj": (junet._block_init, tunet.block_init, 8, 16),
    "basic_strided": (junet._block_init, tunet.block_init, 16, 16),
    "bottleneck": (junet._bottleneck_init, tunet._bottleneck_init, 8, 32),
    "inverted": (functools.partial(junet._inverted_init, se=False),
                 functools.partial(tunet._inverted_init, se=False), 8, 8),
    "mbconv": (functools.partial(junet._inverted_init, se=True),
               functools.partial(tunet._inverted_init, se=True), 8, 16),
}


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_jax(kind, stride):
    rng = np.random.default_rng(stride)
    jinit, tinit, cin, cout = BLOCKS[kind]
    jparams = _np(jinit(jax.random.PRNGKey(1), cin, cout))
    block = _port_tree(jparams, tinit(torch.Generator().manual_seed(0),
                                      cin, cout))
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    want = np.asarray(junet._block_apply(jparams, jnp.asarray(x), 4,
                                         stride=stride))
    got = _nhwc(tunet.block_apply(block, _nchw(x), 4, stride=stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("preset", sorted(tunet.ENCODER_PRESETS))
def test_encoder_matches_jax(preset):
    rng = np.random.default_rng(0)
    jcfg = junet.UNetConfig(encoder_name=preset)
    tcfg = tunet.UNetConfig(encoder_name=preset)
    jparams = _np(jax.jit(lambda k: junet.encoder_init(
        iter(jax.random.split(k, 256)), jcfg))(jax.random.PRNGKey(0)))
    encoder = _port_tree(jparams, tunet.encoder_init(
        torch.Generator().manual_seed(0), tcfg))
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want, want_skips = jax.jit(lambda p, x: junet.encoder_apply(
        p, x, jcfg.groups))(jparams, jnp.asarray(x))
    with torch.no_grad():
        got, got_skips = tunet.encoder_apply(encoder, _nchw(x), tcfg.groups)
    assert len(got_skips) == len(want_skips) == 4
    for g, w in zip([got] + got_skips, [want] + list(want_skips)):
        w = np.asarray(w)
        assert _nhwc(g).shape == w.shape
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(_nhwc(g), w, atol=ATOL * scale, rtol=0)
