"""PyTorch port vs the JAX package: the conv families unet, fpn, linknet,
pspnet and deeplabv3 (tests/conv_parity.py).

For each family at the ``small`` encoder preset, 32^2, 5 classes: fp32
logits and the argmax agreement against the JAX apply, and the gradient of
the CE loss with respect to every parameter against ``jax.grad``. Besides:
DeepLabV3 at a second feature size, whose rescaled atrous rates differ,
and PSPNet's adaptive pool in its matrix form at fp32 and bf16.
(deeplabv3plus, unetplusplus, pan, manet and upernet are in
tests/test_torch_conv_families_2.py, so that xdist spreads the JAX
compiles over two files.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conv_parity import Reference, check_grads, check_logits
from visiontransformer_tpu.models import pspnet as jpspnet
from visiontransformer_tpu_torch.models import deeplab as tdeeplab
from visiontransformer_tpu_torch.models import pspnet as tpspnet

FAMILIES = ["unet", "fpn", "linknet", "pspnet", "deeplabv3"]


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


@pytest.mark.parametrize("size,rates", [(32, [1, 2, 3]), (128, [1, 3, 4])])
def test_deeplab_rates_rescale_with_the_feature_size(reference, size, rates):
    # 32^2 and 128^2 inputs give 2x2 and 8x8 feature maps; the rates (6,
    # 12, 18) on the 33x33 canvas become (1, 2, 3) and (1, 3, 4), so a
    # fixed-rate shortcut misses one of the two sizes.
    case = reference("deeplabv3", size)
    fm = size // 16
    cfg = tdeeplab.DeepLabV3Config()
    assert tdeeplab.atrous_rates(cfg, fm, fm) == rates
    check_logits("deeplabv3", case)


def test_deeplab_rates_round_half_to_even():
    # Python's round: 2.5 -> 2, 3.5 -> 4 (the TPU package's rule).
    cfg = tdeeplab.DeepLabV3Config(atrous_rates=(5, 7), rate_canvas=2)
    assert tdeeplab.atrous_rates(cfg, 1, 1) == [2, 4]
    assert tdeeplab.atrous_rates(cfg, 1, 9) == [2, 4]


@pytest.mark.parametrize("shape", [(2, 7, 7, 8), (2, 14, 9, 16), (1, 6, 5, 4)])
def test_adaptive_pool_matches_jax(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for bins in (1, 2, 3, 6):
        want = np.asarray(jpspnet.adaptive_avg_pool(jnp.asarray(x), bins))
        got = tpspnet.adaptive_avg_pool(xt, bins).permute(0, 2, 3, 1)
        # The same products in another sum order.
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        # The bins are torch's adaptive pool's.
        ref = F.adaptive_avg_pool2d(xt, bins).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("shape", [(2, 7, 7, 8), (2, 14, 9, 16)])
def test_adaptive_pool_bf16_rounds_as_jax(shape):
    # At bf16 the averaging matrix is cast to bf16 (1/3, 1/7 ... round)
    # and each stage rounds its product, as in the TPU package.
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    for bins in (1, 2, 3, 6):
        want = np.asarray(jpspnet.adaptive_avg_pool(
            jnp.asarray(x, jnp.bfloat16), bins).astype(jnp.float32))
        got = tpspnet.adaptive_avg_pool(xt, bins)
        assert got.dtype == torch.bfloat16
        got = got.float().permute(0, 2, 3, 1).numpy()
        equal = float(np.mean(got == want))
        print(f"{shape} bins {bins}: bf16 equal to JAX on {equal:.4f}")
        np.testing.assert_allclose(got, want, atol=2.0 ** -8, rtol=2.0 ** -7)
        assert equal >= 0.99  # measured: 1.0 at every case
