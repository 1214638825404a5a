"""PyTorch port vs the JAX package: the conv half of W8A8 (ops/quant.py,
nn/layers.py:conv2d_w8a8) and W8A8 for every family.

- ``quantize_conv_params`` and ``quantize_params_tree`` equal JAX's bit
  for bit, on single kernels and on whole unet and segformer (mit_b0 and
  conv-encoder) trees; ``quantize_conv_model_`` on the port's model gives
  the state dict that the bridge makes of JAX's quantized tree.
- ``conv2d_w8a8``: int32 accumulators equal to JAX's int8 convolution, and
  the output bit for bit with the JAX one run op by op, within 2 ulps of
  the output plus one of the result against the jitted one (whose ``/127``
  XLA rewrites as a reciprocal product: ``test_linear_w8a8_fp32_matches_
  jax``'s allowance). The product form the card runs (``int8_conv_gemm``:
  im2col, K and N padded to multiples of 8) equals the plain int32 conv.
- A JAX W8A8 tree through ``conv_params_from_jax``/``load_jax_params``;
  the W8A8 model's masks against JAX's W8A8 masks (agreement recorded: a
  1e-7 difference upstream may flip one activation's rounding);
  ``ModelRunner`` and ``register-model --quantize int8`` for conv and
  segformer rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visiontransformer_tpu.models import registry as jregistry
from visiontransformer_tpu.models import segformer as jseg
from visiontransformer_tpu.nn import layers as jlayers
from visiontransformer_tpu.ops import quant as jquant
from visiontransformer_tpu_torch import cli
from visiontransformer_tpu_torch.ckpt.convert import (
    conv_params_from_jax,
    load_jax_params,
)
from visiontransformer_tpu_torch.models import registry
from visiontransformer_tpu_torch.nn import layers as tlayers
from visiontransformer_tpu_torch.ops import quant as tquant
from visiontransformer_tpu_torch.serve.store import JobStore
from visiontransformer_tpu_torch.serve.worker import ModelRunner

CLASSES = 5
# Argmax agreement of the W8A8 port's fp32 masks with JAX's W8A8 masks:
# the forwards differ by ~1e-7 before each quantization, which can move
# an activation across a rounding boundary (one int8 step of s_x);
# measured 0.9903 (unet/small), 1.0 (segformer/mit_b0) and 0.9832
# (segformer/small) on these inputs (random weights: many near-ties).
W8A8_AGREEMENT_FLOOR = 0.98
# (B, H, W, C, O, k, stride, dilation, explicit padding or None for SAME)
CONV_CASES = [
    (2, 37, 53, 32, 64, 3, 1, 1, None),
    (2, 37, 53, 32, 64, 3, 2, 1, None),
    (2, 19, 27, 64, 40, 1, 2, 1, None),
    (2, 10, 14, 32, 32, 8, 8, 1, None),
    (2, 16, 16, 64, 24, 3, 1, 2, None),
    (2, 37, 53, 16, 32, 3, 2, 1, (1, 1)),
    (1, 9, 11, 6, 5, 3, 1, 1, None),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(got, want):
    gl = sorted(jax.tree_util.tree_flatten_with_path(got)[0],
                key=lambda kv: str(kv[0]))
    wl = sorted(jax.tree_util.tree_flatten_with_path(want)[0],
                key=lambda kv: str(kv[0]))
    assert [str(p) for p, _ in gl] == [str(p) for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def _case(case, seed):
    b, h, w, c, o, k, stride, dilation, padding = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    x[0] *= 3.0  # the per-sample scales differ
    kernel = (rng.standard_normal((k, k, c, o)) * 0.05).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)
    params = _numpy(jquant.quantize_conv_params(
        {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}))
    jpad = "SAME" if padding is None else [(p, p) for p in padding]
    return x, params, dict(stride=stride, dilation=dilation), jpad, padding


def _port_conv(x, params, kwargs, padding):
    return tlayers.conv2d_w8a8(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(params["kernel_q"]).permute(3, 2, 0, 1),
        torch.from_numpy(params["kernel_scale"]),
        torch.from_numpy(params["bias"]), padding=padding,
        **kwargs).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", [(3, 3, 16, 8), (1, 1, 64, 24),
                                   (7, 7, 3, 32)])
def test_quantize_conv_params_equals_jax(shape):
    rng = np.random.default_rng(sum(shape))
    kernel = rng.standard_normal(shape).astype(np.float32)
    kernel[..., 0] = 0.0  # an all-zero channel takes the 1e-12 floor
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    want = _numpy(jquant.quantize_conv_params(
        {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}))
    got = tquant.quantize_conv_params(kernel, bias)
    assert got["kernel_q"].dtype == torch.int8
    assert got["kernel_q"].shape == shape
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv2d_w8a8_accumulators_equal_jax(case):
    x, params, kwargs, jpad, padding = _case(case, 0)
    xj = jnp.asarray(x, jnp.float32)
    s_x = jnp.maximum(jnp.max(jnp.abs(xj), axis=(1, 2, 3), keepdims=True)
                      / 127.0, 1e-12)
    xq = jnp.clip(jnp.round(xj / s_x), -127, 127).astype(jnp.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        xq, jnp.asarray(params["kernel_q"]),
        window_strides=(kwargs["stride"],) * 2, padding=jpad,
        rhs_dilation=(kwargs["dilation"],) * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    txq, ts_x = tlayers.quantize_per_sample(
        torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(txq.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(xq))
    np.testing.assert_array_equal(ts_x.flatten().numpy(),
                                  np.asarray(s_x).flatten())
    kq = torch.from_numpy(params["kernel_q"]).permute(3, 2, 0, 1)
    got = tlayers.int8_conv(txq, kq, padding=padding, **kwargs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    # The card's form: im2col and one int8 product, here with the plain
    # int32 product.
    gemm = tlayers.int8_conv_gemm(txq, kq, tlayers.int8_matmul_plain,
                                  padding=padding, **kwargs)
    assert torch.equal(gemm, got)


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv2d_w8a8_matches_jax(case):
    x, params, kwargs, jpad, padding = _case(case, 1)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    with jax.disable_jit():
        eager = np.asarray(jlayers.conv2d(jparams, jnp.asarray(x),
                                          padding=jpad, **kwargs))
    jitted = np.asarray(jax.jit(lambda p, v: jlayers.conv2d(
        p, v, padding=jpad, **kwargs))(jparams, jnp.asarray(x)))
    got = _port_conv(x, params, kwargs, padding)
    np.testing.assert_array_equal(got, eager)
    # As for the linear: 2 ulps of the dequantized product, one of the
    # result.
    product = np.abs(got - params["bias"])
    bound = 2 * 2.0 ** -23 * product + np.spacing(np.abs(jitted))
    assert (np.abs(got - jitted) <= bound).all()


def _jax_tree(family, encoder):
    fam = jregistry.get_model_family(family)
    cfg = fam.config_cls(encoder_name=encoder, num_classes=CLASSES)
    if family == "segformer":
        cfg = jseg.SegformerConfig(encoder_name=encoder, num_classes=CLASSES,
                                   embed_channels=32)
    return cfg, jax.tree_util.tree_map(np.array, jax.jit(
        fam.init, static_argnums=1)(jax.random.PRNGKey(0), cfg))


MODELS = [("unet", "small"), ("segformer", "mit_b0"), ("segformer", "small")]


@pytest.fixture(scope="module")
def trees():
    cache = {}

    def get(family, encoder):
        if (family, encoder) not in cache:
            cfg, params = _jax_tree(family, encoder)
            cache[family, encoder] = (cfg, params, _numpy(
                jquant.quantize_params_tree(
                    jax.tree_util.tree_map(jnp.asarray, params))))
        return cache[family, encoder]
    return get


def _port_model(family, encoder):
    fam = registry.get_model_family(family)
    kwargs = {"embed_channels": 32} if family == "segformer" else {}
    return fam.init(torch.Generator().manual_seed(0), fam.config_cls(
        encoder_name=encoder, num_classes=CLASSES, **kwargs))


@pytest.mark.parametrize("family,encoder", MODELS)
def test_quantize_params_tree_equals_jax(trees, family, encoder):
    _, params, want = trees(family, encoder)
    got = tquant.quantize_params_tree(params)
    _assert_trees_equal(got, want)
    assert tquant.tree_is_quantized(got)
    flat = conv_params_from_jax(want)
    # What the rule leaves: the head, the stem or MiT's RGB embedding, the
    # depthwise kernels.
    assert "head.kernel" in flat and "head.kernel_q" not in flat
    first = "stages.0.embed" if encoder.startswith("mit") else "stem"
    assert f"{first}.kernel" in flat
    assert any(k.endswith("kernel_q") and v.dim() == 4
               for k, v in flat.items())
    if encoder.startswith("mit"):
        assert "stages.0.blocks.0.ffn.dw.kernel" in flat
        assert flat["stages.0.blocks.0.attn.q.kernel_q"].shape == (32, 32)


@pytest.mark.parametrize("family,encoder", MODELS)
def test_quantized_model_equals_the_bridged_jax_tree(trees, family,
                                                     encoder):
    _, params, want = trees(family, encoder)
    bridged = load_jax_params(_port_model(family, encoder), want)
    ours = tquant.quantize_conv_model_(load_jax_params(
        _port_model(family, encoder), params))
    assert tquant.is_quantized(bridged) and tquant.is_quantized(ours)
    a, b = bridged.state_dict(), ours.state_dict()
    assert sorted(a) == sorted(b) == sorted(conv_params_from_jax(want))
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key], b[key]), key
    # int8 leaves are buffers, not trainable parameters.
    names = {n for n, _ in ours.named_parameters()}
    assert not any(n.endswith(("kernel_q", "kernel_scale")) for n in names)
    for name, buf in ours.named_buffers():
        if name.endswith("kernel_q") and buf.dim() == 2:
            assert buf.stride() == (1, buf.shape[0]), name  # column-major


@pytest.mark.parametrize("family,encoder", MODELS)
def test_w8a8_masks_agree_with_jax(trees, family, encoder):
    cfg, _, want_tree = trees(family, encoder)
    images = np.random.default_rng(8).random((2, 37, 53, 3), np.float32)
    apply = jregistry.get_model_family(family).apply
    want = np.asarray(jax.jit(lambda p, x: apply(p, x, cfg))(
        want_tree, jnp.asarray(images))).argmax(-1)
    model = load_jax_params(_port_model(family, encoder), want_tree).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(images)).argmax(-1).numpy()
    agreement = float((got == want).mean())
    print(f"{family}/{encoder} W8A8 argmax agreement with JAX: "
          f"{agreement:.6f}")
    assert agreement >= W8A8_AGREEMENT_FLOOR


def test_div127_is_a_true_division():
    # PyTorch's CUDA division by a Python scalar multiplies by its
    # reciprocal, one ulp off the true quotient for some values; div127
    # divides by a tensor on the input's device, so the card's scales are
    # the CPU's (held on the card by chip_smoke.py phase 15). Here: the
    # quotient is the true one, also where the reciprocal product is not.
    x = torch.arange(1, 20001, dtype=torch.float32) * 0.37
    want = torch.from_numpy(x.numpy() / np.float32(127.0))
    assert torch.equal(tlayers.div127(x), want)
    recip = x * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    assert not torch.equal(recip, want)  # the values discriminate
    rows = x.reshape(100, 200)
    _, s_x = tlayers.quantize_per_token(rows)
    np.testing.assert_array_equal(
        s_x.flatten().numpy(),
        np.abs(rows.numpy()).max(-1) / np.float32(127.0))


def test_conv_params_from_jax_takes_a_w8a8_tree():
    tree = {"conv": {"kernel_q": np.arange(2 * 3 * 4 * 5, dtype=np.int8)
                     .reshape(2, 3, 4, 5),
                     "kernel_scale": np.ones(5, np.float32),
                     "bias": np.zeros(5, np.float32)},
            "fc": {"kernel_q": np.ones((8, 16), np.int8),
                   "kernel_scale": np.ones(16, np.float32)}}
    flat = conv_params_from_jax(tree)
    assert flat["conv.kernel_q"].dtype == torch.int8
    assert torch.equal(flat["conv.kernel_q"], torch.from_numpy(
        tree["conv"]["kernel_q"].transpose(3, 2, 0, 1).copy()))
    assert flat["fc.kernel_q"].shape == (8, 16)
    assert flat["fc.kernel_scale"].dtype == torch.float32


@pytest.mark.parametrize("family,config", [("unet", "small"),
                                           ("segformer", "mit_b0")])
def test_runner_serves_int8_rows(family, config):
    row = {"input_size": 32, "config_name": config, "num_classes": CLASSES,
           "model_family": family, "quantize": "int8"}
    runner = ModelRunner(row, compute_dtype="float32", buckets=(2,),
                         device="cpu")
    assert tquant.is_quantized(runner.model)
    _, exact = registry.resolve_model(family, config, num_classes=CLASSES,
                                      compute_dtype="float32", device="cpu")
    assert not tquant.is_quantized(exact)
    want = tquant.quantize_conv_model_(exact)
    assert sorted(want.state_dict()) == sorted(runner.model.state_dict())
    images = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3),
                                               dtype=np.uint8)
    with torch.no_grad():
        masks = torch.argmax(want(torch.from_numpy(images).float() / 255.0),
                             dim=-1)
    np.testing.assert_array_equal(runner.predict(images), masks.numpy())


def test_register_model_takes_int8_for_any_family(tmp_path, capsys):
    db, media = str(tmp_path / "serving.db"), str(tmp_path / "media")
    base = ["register-model", "--db", db, "--media-root", media]
    for name, family, config in (("u", "unet", "small"),
                                 ("s", "segformer", "mit_b2"),
                                 ("f", "fpn", "resnet34")):
        assert cli.main(base + ["--name", name, "--family", family,
                                "--config", config,
                                "--quantize", "int8"]) == 0
    rows = JobStore(db, media_root=media).list_models()
    assert sorted((r["model_family"], r["config_name"], r["quantize"])
                  for r in rows) == [("fpn", "resnet34", "int8"),
                                     ("segformer", "mit_b2", "int8"),
                                     ("unet", "small", "int8")]
    # MiT presets are segformer's only.
    assert cli.main(base + ["--name", "x", "--family", "unet",
                            "--config", "mit_b0"]) == 1
    assert "unknown encoder preset" in capsys.readouterr().err
