"""PyTorch port vs the JAX package: the conv families deeplabv3plus,
unetplusplus, pan, manet and upernet (tests/conv_parity.py).

For each family at the ``small`` encoder preset, 32^2, 5 classes: fp32
logits and the argmax agreement against the JAX apply, and the gradient of
the CE loss with respect to every parameter against ``jax.grad``. Besides:
DeepLabV3+ at a second feature size, PAN's 7/5/3 stride-2 pyramid on even
and odd feature sizes, and MAnet's attention block, the identity at init
(gamma = 0) and the JAX block's function once gamma is not zero.
(unet, fpn, linknet, pspnet and deeplabv3 are in
tests/test_torch_conv_families.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conv_parity import Reference, check_grads, check_logits
from visiontransformer_tpu.models import manet as jmanet
from visiontransformer_tpu_torch.ckpt.convert import conv_params_from_jax
from visiontransformer_tpu_torch.models import deeplab as tdeeplab
from visiontransformer_tpu_torch.models import manet as tmanet
from visiontransformer_tpu_torch.nn.layers import ParamTree

FAMILIES = ["deeplabv3plus", "unetplusplus", "pan", "manet", "upernet"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    return Reference()


@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_jax(reference, family):
    check_logits(family, reference(family))


@pytest.mark.parametrize("family", FAMILIES)
def test_ce_gradients_match_jax(reference, family):
    check_grads(family, reference(family))


def test_deeplabv3plus_at_a_second_feature_size(reference):
    # 128^2: an 8x8 feature map, rates (1, 3, 4) against 32^2's (1, 2, 3).
    assert tdeeplab.atrous_rates(tdeeplab.DeepLabV3PlusConfig(), 8, 8) == [
        1, 3, 4]
    check_logits("deeplabv3plus", reference("deeplabv3plus", 128))


@pytest.mark.parametrize("size", [48, 64])
def test_pan_stride2_pyramid(reference, size):
    # 48^2 and 64^2 give 3x3 and 4x4 deepest maps: the 7/5/3 stride-2
    # convs pad (3, 3) / (2, 3) and (2, 2) / (1, 2) and (1, 1) / (0, 1),
    # XLA's SAME on odd and even sizes.
    check_logits("pan", reference("pan", size))


def _pab(gamma: float):
    jparams = jax.tree_util.tree_map(np.array, jmanet._pab_init(
        iter(jax.random.split(jax.random.PRNGKey(3), 4)), 32, 8))
    jparams["gamma"] = np.asarray(gamma, np.float32)
    pab = ParamTree(tmanet._pab_init(torch.Generator().manual_seed(0), 32, 8))
    pab.load_state_dict(conv_params_from_jax(jparams), strict=True)
    return jparams, pab


def test_manet_attention_is_the_identity_at_init():
    model = tmanet.manet_init(torch.Generator().manual_seed(0),
                              tmanet.MAnetConfig(encoder_name="small"))
    assert model["pab"]["gamma"].shape == ()
    assert float(model["pab"]["gamma"].detach()) == 0.0
    _, pab = _pab(0.0)
    x = torch.randn(2, 32, 3, 5, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(tmanet._pab_apply(pab, x), x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_manet_attention_matches_jax(dtype):
    jparams, pab = _pab(0.7)
    x = np.random.default_rng(5).standard_normal((2, 3, 5, 32)).astype(
        np.float32)
    want = np.asarray(jmanet._pab_apply(
        jparams, jnp.asarray(x, dtype)).astype(jnp.float32))
    with torch.no_grad():
        got = tmanet._pab_apply(pab, torch.from_numpy(x).permute(
            0, 3, 1, 2).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().permute(0, 2, 3, 1).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:  # bf16 products in another order: a few ulps of the output
        np.testing.assert_allclose(got, want, atol=2.0 ** -6, rtol=2.0 ** -6)
