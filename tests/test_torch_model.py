"""PyTorch port vs the JAX package: the ViT backbone and the vitseg slice.

JAX weights (``vitseg_init``) reach the port through the weight bridge
(``ckpt/convert.py``); the same numpy-seeded images go through both. fp32
tolerances are those of tests/test_model_parity.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.models.vit import patchify as jax_patchify
from visiontransformer_tpu.models.vit import vit_apply as jax_vit_apply
from visiontransformer_tpu.models.vitseg import (
    vitseg_head_logits as jax_head_logits,
)
from visiontransformer_tpu.models.vitseg import vitseg_init
from visiontransformer_tpu.models.vitseg import vitseg_predict as jax_predict
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.ckpt.convert import (
    load_jax_params,
    vitseg_params_from_jax,
)
from visiontransformer_tpu_torch.models.registry import resolve_model
from visiontransformer_tpu_torch.models.vit import patchify, vit_apply
from visiontransformer_tpu_torch.models.vitseg import (
    ViTSeg,
    vitseg_apply,
    vitseg_head_logits,
    vitseg_predict,
)

VIT = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128)
CLASSES = 5
# bf16: argmax agreement of the port's masks with JAX's, both in bf16 on
# the CPU (they round at different places); measured 0.9978 on this input.
BF16_AGREEMENT_FLOOR = 0.99
# The exact mask comparisons draw their images from a generator of their
# own, so that their inputs do not depend on which tests ran before them
# in a worker (the session ``rng`` advances with every draw).
PREDICT_SEED = 42


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype="float32"):
    j = jcfg.ViTSegConfig(vit=jcfg.ViTConfig(**VIT), num_classes=CLASSES,
                          compute_dtype=dtype)
    t = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**VIT), num_classes=CLASSES,
                          compute_dtype=dtype)
    return j, t


@pytest.fixture(scope="module")
def jax_params():
    j, _ = _configs()
    return vitseg_init(jax.random.PRNGKey(0), j)


def _port(jax_params, dtype="float32"):
    _, t = _configs(dtype)
    model = ViTSeg(t)
    return load_jax_params(model, jax.tree_util.tree_map(np.asarray,
                                                         jax_params)).eval()


def _images(rng, b=2, size=32):
    return rng.standard_normal((b, size, size, 3)).astype(np.float32)


def test_bridge_covers_every_parameter(jax_params):
    state = vitseg_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jax_params))
    _, t = _configs()
    assert set(state) == set(ViTSeg(t).state_dict())
    assert tuple(state["backbone.layers.1.qkv.kernel"].shape) == (64, 192)
    assert tuple(state["head_conv1.kernel"].shape) == (3, 3, 64, 256)


def test_patchify_pixel_order(rng):
    x = _images(rng, size=16)
    np.testing.assert_array_equal(
        patchify(torch.from_numpy(x), 4).numpy(),
        np.asarray(jax_patchify(jnp.asarray(x), 4)))


def test_backbone_tokens_match(rng, jax_params):
    j, _ = _configs()
    x = _images(rng)
    want = jax_vit_apply(jax_params["backbone"], jnp.asarray(x), j.vit,
                         attn_impl="xla")
    model = _port(jax_params)
    with torch.no_grad():
        got = vit_apply(model.backbone, torch.from_numpy(x),
                        attn_impl="eager")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("attn_impl", ["eager", "flash"])
def test_seg_logits_and_masks_match(rng, jax_params, attn_impl):
    j, _ = _configs()
    x = _images(rng)
    model = _port(jax_params)
    with torch.no_grad():
        logits = vitseg_head_logits(model, torch.from_numpy(x),
                                    attn_impl=attn_impl)
        full = vitseg_apply(model, torch.from_numpy(x), attn_impl=attn_impl)
    want = jax_head_logits(jax_params, jnp.asarray(x), j, attn_impl="xla")
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=5e-5)
    np.testing.assert_array_equal(
        full.argmax(-1).numpy(),
        np.asarray(jax_predict(jax_params, jnp.asarray(x), j,
                               attn_impl="xla")))


@pytest.mark.parametrize("epilogue", ["auto", "plain", "kernel"])
@pytest.mark.parametrize("out_size", [None, (64, 64)])
def test_predict_masks_match(jax_params, epilogue, out_size):
    j, _ = _configs()
    x = _images(np.random.default_rng(PREDICT_SEED))
    model = _port(jax_params)
    with torch.no_grad():
        got = vitseg_predict(model, torch.from_numpy(x), out_size=out_size,
                             epilogue=epilogue)
    want = jax_predict(jax_params, jnp.asarray(x), j, out_size=out_size,
                       attn_impl="xla")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("epilogue", ["auto", "plain", "kernel"])
def test_predict_uint8_masks_match(jax_params, epilogue):
    """The serving path's mask type, asked of the epilogue: the JAX
    forward's int32 masks cast as the JAX serving program casts them."""
    j, _ = _configs()
    x = _images(np.random.default_rng(PREDICT_SEED))
    model = _port(jax_params)
    with torch.no_grad():
        got = vitseg_predict(model, torch.from_numpy(x), epilogue=epilogue,
                             mask_dtype=torch.uint8)
    want = jax_predict(jax_params, jnp.asarray(x), j, attn_impl="xla")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want.astype(jnp.uint8)))


def test_bf16_masks_agree(rng, jax_params):
    j, _ = _configs("bfloat16")
    x = _images(rng, b=4)
    model = _port(jax_params, "bfloat16")
    with torch.no_grad():
        got = vitseg_predict(model, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_predict(jax_params, jnp.asarray(x), j,
                                  attn_impl="xla"))
    agreement = float((got == want).mean())
    print(f"bf16 argmax agreement with JAX: {agreement:.4f}")
    assert agreement >= BF16_AGREEMENT_FLOOR


def test_resolve_model_random_init():
    cfg, model = resolve_model("vitseg", "P16H512A8", num_classes=3,
                               input_size=32, compute_dtype="float32",
                               device="cpu")
    assert dataclasses.asdict(cfg.vit) == dataclasses.asdict(
        tcfg.vit_config_by_name("P16H512A8", image_size=32))
    kernel = model.backbone.layers[0].mlp_in.kernel.detach()
    assert float(kernel.abs().max()) <= 0.04          # truncated at 2 std
    assert 0.015 < float(kernel.std()) < 0.02          # trunc-normal(0.02)
    assert not model.backbone.layers[0].mlp_in.bias.detach().any()
    assert bool((model.backbone.final_ln.scale.detach() == 1.0).all())
    _, again = resolve_model("vitseg", "P16H512A8", num_classes=3,
                             input_size=32, device="cpu")
    torch.testing.assert_close(again.state_dict(), model.state_dict())
    with pytest.raises(ValueError):
        resolve_model("vitseg", "P16H512A8", num_classes=3, input_size=40,
                      device="cpu")
    with pytest.raises(KeyError):
        resolve_model("nosuchfamily", "resnet18", num_classes=3, device="cpu")
    with pytest.raises(KeyError):  # a conv family takes an encoder preset
        resolve_model("unet", "P16H512A8", num_classes=3, device="cpu")
