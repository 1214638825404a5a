"""PyTorch port vs the JAX package: fused resize -> normalize -> embed.

The offline fold (``ops/fused_preproc.py:_fold_constants``) against JAX's,
bit for bit; ``fused_resize_embed`` against JAX's at the shapes of
tests/test_fused_preproc.py, fp32 and uint8 inputs;
``vit_apply_from_patch_tokens`` and ``vitseg_predict_fused`` against JAX's
and against the port's unfused pipeline.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.models.vit import (
    vit_apply_from_patch_tokens as jax_from_tokens,
)
from visiontransformer_tpu.models.vitseg import (
    vitseg_build_fused_preproc as jax_build,
)
from visiontransformer_tpu.models.vitseg import vitseg_init
from visiontransformer_tpu.models.vitseg import (
    vitseg_predict_fused as jax_predict_fused,
)
from visiontransformer_tpu.nn.layers import linear_init
from visiontransformer_tpu.ops import fused_preproc as jfp
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.ckpt.convert import load_jax_params
from visiontransformer_tpu_torch.models.vit import (
    patchify,
    vit_apply_from_patch_tokens,
)
from visiontransformer_tpu_torch.models.vitseg import (
    ViTSeg,
    vitseg_build_fused_preproc,
    vitseg_predict,
    vitseg_predict_fused,
)
from visiontransformer_tpu_torch.nn.layers import linear
from visiontransformer_tpu_torch.ops import fused_preproc as tfp
from visiontransformer_tpu_torch.ops.resize import resize_bilinear_mm

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
# fp32 embeddings: the port's products against XLA's sum in another order;
# error relative to max|tokens| (measured up to 1.4e-6).
EMBED_RTOL = 1e-5
# The JAX test's bar for the fused forward against the unfused pipeline
# (tests/test_fused_preproc.py:94-95).
MIN_AGREEMENT = 0.999
CFG = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = [(512, 224, 16), (64, 32, 8), (224, 224, 16)]


def _patch_embed(seed, patch, hidden):
    return jax.tree_util.tree_map(np.array, linear_init(
        jax.random.PRNGKey(seed), patch * patch * 3, hidden))


@pytest.mark.parametrize("input_scale", [1.0, 1.0 / 255.0])
@pytest.mark.parametrize("in_size,compute,patch", SHAPES)
def test_fold_constants_equal_jax(in_size, compute, patch, input_scale):
    pe = _patch_embed(0, patch, 48)
    kwargs = dict(patch_size=patch, in_size=in_size, compute_size=compute,
                  mean=MEAN, std=STD, input_scale=input_scale)
    got = tfp._fold_constants(pe, **kwargs)
    want = jfp._fold_constants(pe, **kwargs)
    for g, w, name in zip(got, want, ("wh", "vidx", "k", "bias")):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    consts = tfp.build_fused_embed(pe, device="cpu", **kwargs)
    jconsts = jfp.build_fused_embed(pe, **kwargs)
    for name in ("wh", "vidx", "k", "bias"):
        np.testing.assert_array_equal(consts[name].numpy(),
                                      np.asarray(jconsts[name]))


def _rel_err(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("in_size,compute,patch", SHAPES)
def test_fused_embed_matches_jax(in_size, compute, patch):
    pe = _patch_embed(0, patch, 48)
    kwargs = dict(patch_size=patch, in_size=in_size, compute_size=compute,
                  mean=MEAN, std=STD)
    x = np.random.default_rng(0).random((2, in_size, in_size, 3)).astype(
        np.float32)
    got = tfp.fused_resize_embed(tfp.build_fused_embed(pe, **kwargs),
                                 torch.from_numpy(x), dtype=torch.float32)
    want = jfp.fused_resize_embed(jfp.build_fused_embed(pe, **kwargs),
                                  jnp.asarray(x), dtype=jnp.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel_err(got.numpy(), np.asarray(want)) < EMBED_RTOL


def test_fused_embed_uint8_scale_fold():
    pe = _patch_embed(1, 16, 32)
    kwargs = dict(patch_size=16, in_size=128, compute_size=64, mean=MEAN,
                  std=STD, input_scale=1.0 / 255.0)
    raw = np.random.default_rng(1).integers(0, 256, (2, 128, 128, 3),
                                            dtype=np.uint8)
    got = tfp.fused_resize_embed(tfp.build_fused_embed(pe, **kwargs),
                                 torch.from_numpy(raw), dtype=torch.float32)
    want = jfp.fused_resize_embed(jfp.build_fused_embed(pe, **kwargs),
                                  jnp.asarray(raw), dtype=jnp.float32)
    assert _rel_err(got.numpy(), np.asarray(want)) < EMBED_RTOL
    # ... and against the port's unfused chain on raw / 255.
    x = resize_bilinear_mm(torch.from_numpy(raw).float() / 255.0, (64, 64))
    x = (x - torch.from_numpy(MEAN)) / torch.from_numpy(STD)
    unfused = linear(patchify(x, 16), torch.from_numpy(pe["kernel"]),
                     torch.from_numpy(pe["bias"]))
    assert _rel_err(got.numpy(), unfused.numpy()) < 2e-5


def _models(dtype="float32"):
    j = jcfg.ViTSegConfig(vit=jcfg.ViTConfig(**CFG), num_classes=5,
                          compute_dtype=dtype)
    t = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**CFG), num_classes=5,
                          compute_dtype=dtype)
    params = vitseg_init(jax.random.PRNGKey(0), j)
    model = load_jax_params(ViTSeg(t), jax.tree_util.tree_map(
        np.asarray, params)).eval()
    return j, params, model


def test_vit_apply_from_patch_tokens_matches_jax():
    j, params, model = _models()
    tokens = np.random.default_rng(3).standard_normal((2, 16, 64)).astype(
        np.float32)
    with torch.no_grad():
        got = vit_apply_from_patch_tokens(model.backbone,
                                          torch.from_numpy(tokens),
                                          attn_impl="eager")
    want = jax_from_tokens(params["backbone"], jnp.asarray(tokens), j.vit,
                           attn_impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("uint8", [False, True])
def test_vitseg_predict_fused_matches_jax_and_unfused(uint8):
    """fp32: masks equal to the JAX fused forward's, and at least 0.999 in
    agreement with the port's unfused pipeline (resize, normalize,
    vitseg_predict) on the same raw images."""
    j, params, model = _models()
    rng = np.random.default_rng(2)
    if uint8:
        raw = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
        scale, images = 1.0 / 255.0, raw.astype(np.float32) / 255.0
    else:
        raw = rng.random((2, 64, 64, 3)).astype(np.float32)
        scale, images = 1.0, raw
    consts = vitseg_build_fused_preproc(model, in_size=64, mean=MEAN,
                                        std=STD, input_scale=scale)
    with torch.no_grad():
        got = vitseg_predict_fused(model, consts, torch.from_numpy(raw),
                                   out_size=(64, 64))
        x = resize_bilinear_mm(torch.from_numpy(images), (32, 32))
        x = (x - torch.from_numpy(MEAN)) / torch.from_numpy(STD)
        unfused = vitseg_predict(model, x, out_size=(64, 64))
        as_uint8 = vitseg_predict_fused(model, consts, torch.from_numpy(raw),
                                        out_size=(64, 64),
                                        mask_dtype=torch.uint8)
    assert got.dtype == torch.int32 and got.shape == (2, 64, 64)
    assert torch.equal(as_uint8, got.to(torch.uint8))
    jconsts = jax_build(params, j, in_size=64, mean=MEAN, std=STD,
                        input_scale=scale)
    want = jax_predict_fused(params, jconsts, jnp.asarray(raw), j,
                             out_size=(64, 64), attn_impl="xla")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    agreement = float((got == unfused).float().mean())
    assert agreement >= MIN_AGREEMENT, agreement
