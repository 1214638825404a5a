"""PyTorch port vs the JAX package: the fused upsample+argmax epilogue.

On the CPU the port's wrapper runs its plain version; both are held to
exact mask equality against JAX's Pallas kernel (interpret mode) and
``argmax(resize_bilinear_mm)`` on the shapes and the tie case of
tests/test_upsample_argmax.py, in int32 and in uint8 (the serving path's
mask type), from fp32 and from bf16 logits. The CUDA kernel runs only on
the card (chip_smoke.py); here its arithmetic (its taps and its unfused
fp32 products and sums) is replayed in numpy (``_kernel_replay``), and its
argmax rule over class chunks is held to ``np.argmax`` (``_chunk_argmax``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visiontransformer_tpu.models.vitseg import _upsample_argmax_epilogue
from visiontransformer_tpu.ops.resize import (
    bilinear_matrix,
    resize_bilinear_mm,
)
from visiontransformer_tpu.ops.upsample_argmax import (
    upsample_argmax as jax_upsample_argmax,
)
from visiontransformer_tpu_torch.ops.upsample_argmax import (
    epilogue_path,
    interpolation_taps,
    upsample_argmax,
    upsample_argmax_plain,
    upsample_argmax_tap_plain,
)
from visiontransformer_tpu_torch.utils import spans

SHAPES = [
    ((2, 14, 14, 17), (96, 96)),
    ((1, 7, 9, 5), (64, 96)),
    ((1, 8, 8, 3), (8, 8)),
    ((2, 16, 16, 17), (40, 40)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kernel_replay(x: np.ndarray, size) -> np.ndarray:
    """csrc/upsample_argmax.cu's per-pixel arithmetic in numpy float32
    (every product and sum rounded on its own, as __fmul_rn/__fadd_rn)."""
    hi, hw = interpolation_taps(size[0], x.shape[1])
    wi, ww = interpolation_taps(size[1], x.shape[2])
    t = [x[:, hi[:, 0]] * hw[:, 0, None, None], x[:, hi[:, 1]] * hw[:, 1, None, None]]
    y = t[0] + t[1]                                    # (B, H, w, C)
    z = (y[:, :, wi[:, 0]] * ww[None, None, :, 0, None]
         + y[:, :, wi[:, 1]] * ww[None, None, :, 1, None])
    return np.argmax(z, axis=-1).astype(np.int32)


@pytest.mark.parametrize("shape,size", SHAPES)
@pytest.mark.parametrize("port_fn", ["wrapper", "plain", "kernel_replay"])
def test_masks_match_jax(rng, shape, size, port_fn):
    x = rng.standard_normal(shape).astype(np.float32)
    if port_fn == "kernel_replay":
        got = _kernel_replay(x, size)
    else:
        fn = upsample_argmax if port_fn == "wrapper" else upsample_argmax_plain
        got = fn(torch.from_numpy(x), size)
        assert got.dtype == torch.int32
        got = got.numpy()
    jx = jnp.asarray(x)
    np.testing.assert_array_equal(
        got, np.asarray(jnp.argmax(resize_bilinear_mm(jx, size), axis=-1)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_upsample_argmax(jx, size, interpret=True)))


@pytest.mark.parametrize("port_fn", ["wrapper", "kernel_replay"])
def test_tie_breaking_first_index(rng, port_fn):
    plane = rng.standard_normal((1, 6, 6, 1)).astype(np.float32)
    x = np.concatenate([plane, plane - 1.0, plane], axis=-1)
    if port_fn == "kernel_replay":
        got = _kernel_replay(x, (24, 24))
    else:
        got = upsample_argmax(torch.from_numpy(x), (24, 24)).numpy()
    want = np.asarray(jax_upsample_argmax(jnp.asarray(x), (24, 24),
                                          interpret=True))
    assert (got == 0).all() and (want == 0).all()


@pytest.mark.parametrize("out_size,in_size", [(512, 14), (224, 14), (14, 14),
                                              (37, 100), (8, 8), (5, 1)])
def test_taps_rebuild_the_matrix(out_size, in_size):
    idx, wts = interpolation_taps(out_size, in_size)
    mat = np.zeros((out_size, in_size), np.float32)
    for r in range(out_size):
        for t in range(2):
            mat[r, idx[r, t]] += wts[r, t]
    np.testing.assert_array_equal(mat, bilinear_matrix(out_size, in_size))


def _jax_masks(x: np.ndarray, size, np_dtype):
    """argmax(resize_bilinear_mm) and the Pallas kernel (interpret mode),
    both cast to the mask type as the JAX serving program casts."""
    jx = jnp.asarray(x)
    return (np.asarray(jnp.argmax(resize_bilinear_mm(jx, size), axis=-1)
                       .astype(np_dtype)),
            np.asarray(jax_upsample_argmax(jx, size, interpret=True)
                       .astype(np_dtype)))


def _port_masks(port_fn, x: np.ndarray, size, out_dtype, in_dtype=None):
    xt = torch.from_numpy(x)
    if in_dtype is not None:
        xt = xt.to(in_dtype)
    if port_fn == "wrapper":
        got = upsample_argmax(xt, size, out_dtype=out_dtype)
    elif port_fn == "plain":
        got = upsample_argmax_plain(xt, size, out_dtype)
    else:
        got = upsample_argmax_tap_plain(xt, size, out_dtype)
    assert got.dtype == out_dtype
    return got.numpy()


PORT_FNS = ["wrapper", "plain", "tap_plain"]


@pytest.mark.parametrize("shape,size", SHAPES)
@pytest.mark.parametrize("port_fn", PORT_FNS)
def test_uint8_masks_match_jax(rng, shape, size, port_fn):
    x = rng.standard_normal(shape).astype(np.float32)
    got = _port_masks(port_fn, x, size, torch.uint8)
    assert got.dtype == np.uint8
    for want in _jax_masks(x, size, jnp.uint8):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.uint8])
@pytest.mark.parametrize("port_fn", PORT_FNS)
def test_bf16_logits_match_jax_epilogue(rng, out_dtype, port_fn):
    shape, size = (2, 14, 14, 17), (96, 96)
    xb = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                          ).bfloat16()
    x = xb.float().numpy()                     # bf16 values, exactly
    got = _port_masks(port_fn, x, size, out_dtype, in_dtype=torch.bfloat16)
    want = _upsample_argmax_epilogue(jnp.asarray(x).astype(jnp.bfloat16),
                                     size, "xla")
    np_dtype = np.uint8 if out_dtype == torch.uint8 else np.int32
    np.testing.assert_array_equal(got, np.asarray(want).astype(np_dtype))


EDGE_CASES = [((1, 5, 7, 17), (4, w)) for w in (1, 3, 17, 33, 513)] + [
    ((1, 100, 100, 17), (37, 37)),             # downsampling
    ((2, 9, 11, 40), (19, 37)),                # chunked, two images
]


@pytest.mark.parametrize("shape,size", EDGE_CASES)
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.uint8])
def test_edge_shapes_match_jax(rng, shape, size, out_dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    np_dtype = jnp.uint8 if out_dtype == torch.uint8 else jnp.int32
    want = _jax_masks(x, size, np_dtype)
    for port_fn in PORT_FNS:
        got = _port_masks(port_fn, x, size, out_dtype)
        for w in want:
            np.testing.assert_array_equal(got, w, err_msg=port_fn)
    np.testing.assert_array_equal(want[0], _kernel_replay(x, size))


@pytest.mark.parametrize("classes", [1, 3, 17, 40])
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.uint8])
def test_tie_across_chunk_goes_to_class_0(rng, classes, out_dtype):
    """Class 0 ties class 8 (the first of the second chunk of 8; the last
    class where there are fewer) everywhere; the others lie below."""
    plane = rng.standard_normal((1, 6, 6, 1)).astype(np.float32)
    x = np.concatenate([plane - 1.0 - 0.1 * k for k in range(classes)], -1)
    twin = 8 if classes > 8 else classes - 1
    x[..., 0] = x[..., twin] = plane[..., 0]
    np_dtype = jnp.uint8 if out_dtype == torch.uint8 else jnp.int32
    for port_fn in PORT_FNS:
        got = _port_masks(port_fn, x, (24, 20), out_dtype)
        assert (got == 0).all(), port_fn
    for want in _jax_masks(x, (24, 20), np_dtype):
        assert (want == 0).all()


@pytest.mark.parametrize("args,path", [
    ((32, 14, 14, 17, 512, 512, torch.uint8), "c17/uint8/vec"),
    ((32, 14, 14, 17, 512, 512, torch.int32), "c17/int32/vec"),
    ((32, 56, 56, 17, 512, 512, torch.uint8), "c17/uint8/vec"),
    ((32, 14, 14, 17, 224, 224, torch.uint8), "c17/uint8/vec"),
    ((1, 14, 14, 17, 224, 224, torch.uint8), "c17/uint8/vec"),
    ((8, 16, 16, 17, 256, 256, torch.int32), "c17/int32/vec"),
    ((32, 14, 14, 17, 512, 513, torch.int32), "c17/int32/scalar"),
    ((1, 100, 100, 17, 37, 37, torch.uint8), "c17/uint8/scalar"),
    ((2, 9, 11, 40, 19, 36, torch.int32), "chunked/int32/vec"),
    ((32, 56, 700, 40, 512, 512, torch.int32), "chunked/int32/vec"),
    ((32, 56, 200, 17, 512, 512, torch.uint8), "c17/uint8/vec"),
])
def test_epilogue_path(args, path):
    launches = spans.counters().get("upsample_argmax", 0)
    assert epilogue_path(*args) == path
    assert spans.counters().get("upsample_argmax", 0) == launches


@pytest.mark.parametrize("shape,kwargs,error", [
    ((1, 4, 4, 257), {"out_dtype": torch.uint8}, ValueError),
    ((1, 4, 4, 3), {"out_dtype": torch.int64}, TypeError),
    ((1, 4, 4, 3), {"dtype": torch.float16}, TypeError),
    ((1, 4, 4, 3), {"transpose": True}, ValueError),
    ((4, 4, 3), {}, ValueError),                # not (B, h, w, C)
])
def test_wrapper_refuses(shape, kwargs, error):
    x = torch.zeros(shape, dtype=kwargs.get("dtype", torch.float32))
    if kwargs.get("transpose"):
        x = x.transpose(1, 2)
    with pytest.raises(error):
        upsample_argmax(x, (8, 8),
                        out_dtype=kwargs.get("out_dtype", torch.int32))


def _chunk_argmax(z: np.ndarray, chunk: int) -> int:
    """csrc/upsample_argmax.cu:pixel_argmax's rule on one pixel's class
    scores: classes in ascending chunks, the chunk's max by fmax from -inf,
    and where it is strictly above the running best, the chunk's first
    class equal to it."""
    best, arg = np.float32(-np.inf), 0
    for c0 in range(0, len(z), chunk):
        part = z[c0:c0 + chunk]
        m = np.float32(-np.inf)
        for v in part:
            m = np.fmax(m, v)
        if m > best:
            best, arg = m, c0 + int(np.flatnonzero(part == m)[0])
    return arg


def _scores(case: str, classes: int, rng) -> np.ndarray:
    z = rng.standard_normal((64, classes)).astype(np.float32)
    if case == "tie":            # class 0 ties a later class
        z[:, 0] = z[:, classes // 2 + 3] = z.max(-1) + 1.0
    elif case == "nan":          # NaN never wins, at class 0 too
        z[::2, 0] = np.nan
        z[1::3, classes - 1] = np.nan
    elif case == "all_nan":
        z[:] = np.nan
    elif case == "neg_inf":      # all -inf, or -inf but one class
        z[:] = -np.inf
        z[1::2, classes - 2] = 0.0
    return z


@pytest.mark.parametrize("case,classes,chunk", [
    ("random", 17, 17), ("random", 40, 8), ("random", 3, 8),
    ("tie", 17, 17), ("tie", 40, 8), ("nan", 17, 17), ("nan", 40, 8),
    ("all_nan", 17, 8), ("neg_inf", 40, 8),
])
def test_chunk_argmax_rule(rng, case, classes, chunk):
    """The chunked rule is argmax with the first index winning ties and NaN
    never winning, across chunk boundaries."""
    z = _scores(case, classes, rng)
    want = np.argmax(np.where(np.isnan(z), -np.inf, z), axis=-1)
    got = [_chunk_argmax(row, chunk) for row in z]
    np.testing.assert_array_equal(got, want)
