"""PyTorch port vs the JAX package: the PAED crack path's building blocks.

The exact EDT and the SDF targets, the gather-form bilinear resize and the
PIL-nearest resize, the PAED losses (soft, binary composite, multiclass,
hard), skeletonize and the binary metrics, each held against its JAX
counterpart on the same numpy inputs, on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visiontransformer_tpu import native as jnative
from visiontransformer_tpu.losses import paed as jpaed
from visiontransformer_tpu.losses import sdf as jsdf
from visiontransformer_tpu.metrics import segmentation as jmetrics
from visiontransformer_tpu.ops import edt as jedt_module
from visiontransformer_tpu.ops import resize as jresize
from visiontransformer_tpu.ops.morphology import skeletonize_np as jskeleton_np
from visiontransformer_tpu_torch import native as tnative
from visiontransformer_tpu_torch.ops import morphology as tmorph
from visiontransformer_tpu_torch.losses import paed as tpaed
from visiontransformer_tpu_torch.losses.sdf import compute_sdf_batch
from visiontransformer_tpu_torch.metrics import segmentation as tmetrics
from visiontransformer_tpu_torch.ops.edt import edt
from visiontransformer_tpu_torch.ops.resize import (
    resize_bilinear,
    resize_nearest_pil,
)

scipy_ndimage = pytest.importorskip("scipy.ndimage")

# The JAX functions jitted, as the JAX package runs them in its programs
# (one compile a shape instead of one an operation); but the bilinear
# resize op by op: jitted, XLA on the CPU contracts its lerp into an FMA,
# one ulp away from the two roundings the TPU package's code spells out
# (and the port computes).
jedt = jax.jit(jax.vmap(jedt_module.edt))
jsdf_batch = jax.jit(jsdf.compute_sdf_batch)
jbilinear = jresize.resize_bilinear
jnearest_pil = jax.jit(jresize.resize_nearest_pil,
                       static_argnames=("size", "h_axis", "w_axis"))

# The losses sum a few hundred fp32 terms in another order on each side.
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _masks(rng, shape):
    """Three (H, W) masks: random, all zero (no foreground) and all one."""
    return np.stack([rng.random(shape) > 0.6, np.zeros(shape, bool),
                     np.ones(shape, bool)])


# ---------------------------------------------------------------------- EDT
@pytest.mark.parametrize("shape", [(32, 32), (48, 24), (17, 31), (1, 7)])
def test_edt_matches_jax_and_scipy(rng, shape):
    masks = _masks(rng, shape)
    got = edt(_t(masks)).numpy()
    want = np.asarray(jedt(jnp.asarray(masks)))
    # The same fp32 integer arithmetic and one sqrt: equal bit for bit.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, want)
    # scipy, where a zero pixel exists (the full mask saturates at _BIG).
    for m, g in zip(masks[:2], got[:2]):
        np.testing.assert_allclose(
            g, scipy_ndimage.distance_transform_edt(m), atol=1e-4)
    assert (got[2] == np.float32(1e6)).all()


@pytest.mark.parametrize("shape", [(32, 32), (40, 24), (23, 23)])
def test_compute_sdf_batch_matches_jax_and_scipy(rng, shape):
    masks = _masks(rng, shape)
    ext, interior = compute_sdf_batch(_t(masks))
    jext, jint = jsdf_batch(jnp.asarray(masks))
    np.testing.assert_allclose(ext.numpy(), np.asarray(jext), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(interior.numpy(), np.asarray(jint), rtol=0,
                               atol=1e-6)
    m = masks[0]
    for got, want in ((ext[0], scipy_ndimage.distance_transform_edt(~m)),
                      (interior[0], scipy_ndimage.distance_transform_edt(m))):
        want = want.astype(np.float32)
        np.testing.assert_allclose(got.numpy(), want / want.max(), atol=1e-5)
    # No foreground: the interior is 0 and left unnormalised; the exterior
    # saturates and normalises to 1. All foreground: the mirror image.
    assert interior[1].max() == 0 and (ext[1] == 1).all()
    assert ext[2].max() == 0 and (interior[2] == 1).all()
    assert not ext.requires_grad


# ------------------------------------------------------------------- resize
RESIZE_CASES = [((14, 14), (224, 224)), ((7, 9), (13, 5)),
                ((40, 33), (32, 32)), ((224, 224), (56, 70))]


@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_resize_bilinear_matches_jax_bit_for_bit(rng, src, dst):
    x = rng.standard_normal((2,) + src).astype(np.float32)
    got = resize_bilinear(_t(x), dst).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jbilinear(jnp.asarray(x), size=dst)), rtol=0, atol=0)
    # Other axes, and an integer input (fp32 out, as in JAX).
    y = rng.integers(0, 9, (3,) + src + (2,)).astype(np.int32)
    got = resize_bilinear(_t(y), dst, h_axis=1, w_axis=2)
    want = jbilinear(jnp.asarray(y), size=dst, h_axis=1, w_axis=2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("src,dst", RESIZE_CASES + [((256, 256), (224, 224)),
                                                    ((3, 1000), (7, 333))])
def test_resize_nearest_pil_matches_jax(rng, src, dst):
    x = rng.integers(0, 17, (2,) + src).astype(np.int32)
    got = resize_nearest_pil(_t(x), dst)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnearest_pil(jnp.asarray(x), size=dst)))


# ------------------------------------------------------------------- losses
def _paed_inputs(rng, b=2, h=24, w=20, hs=32, ws=28):
    preds = rng.random((b, h, w, 1)).astype(np.float32)
    sdf_ext = rng.random((b, hs, ws)).astype(np.float32)
    sdf_int = rng.random((b, hs, ws)).astype(np.float32)
    masks = (rng.random((b, h, w, 1)) > 0.7).astype(np.float32)
    return preds, masks, sdf_ext, sdf_int


def test_paed_loss_soft_and_its_gradient_match(rng):
    preds, _, sdf_ext, sdf_int = _paed_inputs(rng)
    p = _t(preds).requires_grad_()
    loss = tpaed.paed_loss_soft(_t(sdf_ext), _t(sdf_int), p)
    loss.backward()
    jfn = lambda x: jpaed.paed_loss_soft(jnp.asarray(sdf_ext),
                                         jnp.asarray(sdf_int), x)
    jloss, jgrad = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(preds))
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("value", [0.3, 1.0])
def test_paed_loss_soft_gradient_at_an_edge_map_tie(rng, value):
    # A constant prediction: the zero padding makes the four corners the
    # edge map's maxima, tied exactly. jnp.max's gradient splits evenly
    # among them, as torch.amax's does; torch.max(dim=) would send it all
    # to one corner.
    preds = np.full((2, 16, 16, 1), value, np.float32)
    _, _, sdf_ext, sdf_int = _paed_inputs(rng)
    p = _t(preds).requires_grad_()
    tpaed.paed_loss_soft(_t(sdf_ext), _t(sdf_int), p).backward()
    jgrad = jax.jit(jax.grad(lambda x: jpaed.paed_loss_soft(
        jnp.asarray(sdf_ext), jnp.asarray(sdf_int), x)))(jnp.asarray(preds))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-7)


def test_paed_binary_total_loss_matches_every_part(rng):
    preds, masks, sdf_ext, sdf_int = _paed_inputs(rng)
    preds[0, :2, :2, 0] = [[0.0, 1.0], [1.0, 0.0]]  # BCE's -100 clamp
    total, parts = tpaed.paed_binary_total_loss(
        *(_t(a) for a in (preds, masks, sdf_ext, sdf_int)))
    jtotal, jparts = jax.jit(jpaed.paed_binary_total_loss)(
        *(jnp.asarray(a) for a in (preds, masks, sdf_ext, sdf_int)))
    np.testing.assert_allclose(float(total), float(jtotal), **LOSS_TOL)
    assert set(parts) == set(jparts) == {"bce", "dice", "paed"}
    for key in parts:
        np.testing.assert_allclose(float(parts[key]), float(jparts[key]),
                                   err_msg=key, **LOSS_TOL)


@pytest.mark.parametrize("class_penalty", [True, False])
def test_paed_loss_multiclass_soft_matches(rng, class_penalty):
    one_hot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (2, 30, 26))]
    probs = rng.random((2, 30, 26, 5)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    p = _t(probs).requires_grad_()
    loss = tpaed.paed_loss_multiclass_soft(_t(one_hot), p,
                                           class_penalty=class_penalty)
    loss.backward()
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda x: jpaed.paed_loss_multiclass_soft(
            jnp.asarray(one_hot), x, class_penalty=class_penalty)))(
        jnp.asarray(probs))
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-9)


@pytest.fixture(params=["native", "numpy"])
def native_mode(request, monkeypatch):
    """Both packages' host helpers with the C++ library (when it builds)
    and with their numpy fallbacks (VITSEG_NATIVE=0)."""
    if request.param == "numpy":
        monkeypatch.setenv("VITSEG_NATIVE", "0")
    for module in (tnative, jnative):  # load again, as the env now says
        monkeypatch.setattr(module, "_TRIED", False)
        monkeypatch.setattr(module, "_LIB", None)
    return request.param


def _crack_masks(rng, n=3, size=40):
    masks = rng.random((n, size, size)) > 0.55
    masks[0, 10:30, 5:35] = True
    masks[1, :, 18:23] = True
    return masks


def test_skeletonize_matches_jax(rng, native_mode):
    for mask in _crack_masks(rng):
        got = tnative.skeletonize(mask)
        assert got.dtype == bool
        np.testing.assert_array_equal(got, jnative.skeletonize(mask))
        np.testing.assert_array_equal(tmorph.skeletonize_np(mask),
                                      jskeleton_np(mask))


def test_paed_loss_hard_matches(rng, native_mode):
    probs = (0.3 + 0.4 * _crack_masks(rng)).astype(np.float32)
    probs += rng.normal(0, 0.05, probs.shape).astype(np.float32)
    sdf_ext = rng.random((3, 52, 52)).astype(np.float32)
    sdf_int = rng.random((3, 52, 52)).astype(np.float32)
    got = tpaed.paed_loss_hard(probs, sdf_ext, sdf_int)
    want = jpaed.paed_loss_hard(probs, sdf_ext, sdf_int)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------------------ metrics
BINARY_METRICS = ("pixel_accuracy_binary", "iou_binary", "dice_score_binary",
                  "precision_binary", "recall_binary")


@pytest.mark.parametrize("case", ["random", "no_gt", "both_empty", "all_one",
                                  "float_gt"])
def test_binary_metrics_match(rng, case):
    gt = (rng.random((3, 20, 20)) > 0.7).astype(np.int32)
    pred = (rng.random((3, 20, 20)) > 0.6).astype(np.int32)
    if case == "no_gt":
        gt[:] = 0
    elif case == "both_empty":
        gt[:], pred[:] = 0, 0
    elif case == "all_one":
        gt[:], pred[:] = 1, 1
    elif case == "float_gt":
        gt = gt * rng.uniform(0.2, 1.0, gt.shape).astype(np.float32)
    for name in BINARY_METRICS:
        got = float(getattr(tmetrics, name)(_t(gt), _t(pred)))
        want = float(getattr(jmetrics, name)(jnp.asarray(gt),
                                             jnp.asarray(pred)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    got = [int(x) for x in tmetrics.binary_stats(_t(gt), _t(pred))]
    want = [int(x) for x in jmetrics.binary_stats(jnp.asarray(gt),
                                                  jnp.asarray(pred))]
    assert got == want


@pytest.mark.parametrize("case", ["random", "perfect", "one_class"])
def test_soft_iou_score_matches(rng, case):
    targets = rng.integers(0, 6, (3, 16, 16)).astype(np.int32)
    preds = {"random": rng.integers(0, 6, targets.shape).astype(np.int32),
             "perfect": targets,
             "one_class": np.zeros_like(targets)}[case]
    got = tmetrics.soft_iou_score(_t(preds), _t(targets), 6)
    want = jmetrics.soft_iou_score(jnp.asarray(preds), jnp.asarray(targets), 6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
