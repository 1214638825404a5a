"""PyTorch port vs the JAX package: the fused upsample+argmax epilogue.

On the CPU the port's wrapper runs its plain version; both are held to
exact mask equality against JAX's Pallas kernel (interpret mode) and
``argmax(resize_bilinear_mm)`` on the shapes and the tie case of
tests/test_upsample_argmax.py. The CUDA kernel's arithmetic (its taps and
its unfused fp32 products and sums) is replayed here in numpy, since the
kernel itself runs only on the card (chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visiontransformer_tpu.ops.resize import (
    bilinear_matrix,
    resize_bilinear_mm,
)
from visiontransformer_tpu.ops.upsample_argmax import (
    upsample_argmax as jax_upsample_argmax,
)
from visiontransformer_tpu_torch.ops.upsample_argmax import (
    interpolation_taps,
    upsample_argmax,
    upsample_argmax_plain,
)

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
