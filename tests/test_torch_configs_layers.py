"""PyTorch port vs the JAX package: configs, layers and the resize ops.

Inputs come from a numpy seed and go through both packages; the port runs
on the CPU (its plain paths), the JAX package on its CPU backend.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.nn import layers as jl
from visiontransformer_tpu.ops import resize as jresize
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.nn import layers as tl
from visiontransformer_tpu_torch.ops import resize as tresize


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else f.default_factory()) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ViTConfig", "ViTSegConfig", "SweepEntry"])
def test_config_fields_and_defaults_match(name):
    jax_cls, port_cls = getattr(jcfg, name), getattr(tcfg, name)
    if name == "SweepEntry":
        assert ([f.name for f in dataclasses.fields(jax_cls)]
                == [f.name for f in dataclasses.fields(port_cls)])
        return
    jf, tf = _fields(jax_cls), _fields(port_cls)
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (n, jd), (_, td) in zip(jf, tf):
        if dataclasses.is_dataclass(jd):
            assert dataclasses.asdict(jd) == dataclasses.asdict(td), n
        else:
            assert jd == td, n


def test_sweep_table_presets_and_lookup_match():
    assert ([dataclasses.astuple(e) for e in jcfg.SWEEP_CONFIGS]
            == [dataclasses.astuple(e) for e in tcfg.SWEEP_CONFIGS])
    assert jcfg.VIT_PRESETS == tcfg.VIT_PRESETS
    for name in [e.name for e in jcfg.SWEEP_CONFIGS] + sorted(jcfg.VIT_PRESETS):
        j = jcfg.vit_config_by_name(name, image_size=448)
        t = tcfg.vit_config_by_name(name, image_size=448)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.seq_len, j.head_dim, j.grid_size) == (
            t.seq_len, t.head_dim, t.grid_size)
    with pytest.raises(KeyError):
        tcfg.vit_config_by_name("P3H1A1")
    assert tcfg.ViTSegConfig(compute_dtype="bfloat16").dtype == torch.bfloat16
    assert tcfg.ViTSegConfig().dtype == torch.float32


def test_layer_norm_matches(rng):
    x = (rng.standard_normal((3, 7, 64)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = jl.layer_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                         jnp.asarray(x))
    got = tl.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_matches(rng, bias):
    x = rng.standard_normal((2, 9, 48)).astype(np.float32)
    kernel = rng.standard_normal((48, 80)).astype(np.float32) * 0.1
    params = {"kernel": jnp.asarray(kernel)}
    b = None
    if bias:
        b = rng.standard_normal(80).astype(np.float32)
        params["bias"] = jnp.asarray(b)
    want = jl.linear(params, jnp.asarray(x))
    got = tl.linear(torch.from_numpy(x), torch.from_numpy(kernel),
                    None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_gelu_exact_matches(rng):
    x = (rng.standard_normal(1000) * 4).astype(np.float32)
    np.testing.assert_allclose(tl.gelu_exact(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.gelu_exact(jnp.asarray(x))),
                               atol=1e-6)


@pytest.mark.parametrize("k,cin,cout,stride,dilation,hw", [
    # A 3x3 SAME conv on the seg head's 4x4 grid. Short reductions keep
    # atol 1e-6 meaningful: at the tiny model's 576-term head reduction the
    # CPU conv library's summation order alone moves results by ~1e-6; the
    # full head is held to the seg-logits tolerance in test_torch_model.py.
    (3, 16, 32, 1, 1, 4),
    (1, 32, 5, 1, 1, 4),      # the seg head's 1x1
    (3, 8, 16, 2, 1, 9),      # strided SAME (asymmetric padding)
    (3, 8, 8, 1, 2, 7),       # dilated SAME
])
def test_conv2d_matches(rng, k, cin, cout, stride, dilation, hw):
    x = rng.standard_normal((2, hw, hw, cin)).astype(np.float32)
    # Weights at the model's init scale (initializer_range 0.02), so the
    # outputs stay O(1) where atol 1e-6 is a few fp32 ulps.
    kernel = (rng.standard_normal((k, k, cin, cout)) * 0.02).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.02).astype(np.float32)
    want = jl.conv2d({"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)},
                     jnp.asarray(x), stride=stride, dilation=dilation)
    got = tl.conv2d(torch.from_numpy(x), torch.from_numpy(kernel),
                    torch.from_numpy(bias), stride=stride, dilation=dilation)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# The (in, out) ratios of tests/test_resize.py's bilinear cases.
RESIZE_PAIRS = [(256, 224), (224, 256), (56, 224), (224, 224), (100, 37),
                (14, 224), (28, 448), (32, 512), (7, 99)]


@pytest.mark.parametrize("in_size,out_size", RESIZE_PAIRS)
def test_bilinear_matrix_bitwise(in_size, out_size):
    want = jresize.bilinear_matrix(out_size, in_size)
    got = tresize.bilinear_matrix(out_size, in_size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("in_size,out_size", RESIZE_PAIRS)
def test_resize_bilinear_mm_matches(rng, in_size, out_size):
    x = rng.standard_normal((1, in_size, in_size // 2 + 1, 3)).astype(np.float32)
    size = (out_size, out_size // 2 + 3)
    want = jresize.resize_bilinear_mm(jnp.asarray(x), size)
    got = tresize.resize_bilinear_mm(torch.from_numpy(x), size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
