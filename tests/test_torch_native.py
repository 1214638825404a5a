"""PyTorch port vs the JAX package: the host library's bindings.

``label``, ``bounding_boxes`` and ``edt`` of the port's ``native.py``, and
``bounding_boxes_np`` of its ``ops/morphology.py``, against the JAX
package's on the same seeded masks, bit for bit, with the C++ library and
with the numpy fallbacks (``VITSEG_NATIVE=0``); ``edt`` also against
scipy. The port builds its own copy of the library under a file lock, so
processes that start together all load it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from scipy import ndimage

from visiontransformer_tpu import native as jnative
from visiontransformer_tpu.ops import morphology as jmorph
from visiontransformer_tpu_torch import native as tnative
from visiontransformer_tpu_torch.ops import morphology as tmorph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(48, 48), (31, 57), (1, 9)]


@pytest.fixture(params=["native", "numpy"])
def native_mode(request, monkeypatch):
    """Both packages with the C++ library and with their fallbacks."""
    if request.param == "numpy":
        monkeypatch.setenv("VITSEG_NATIVE", "0")
    for module in (tnative, jnative):  # load again, as the env now says
        monkeypatch.setattr(module, "_TRIED", False)
        monkeypatch.setattr(module, "_LIB", None)
    if request.param == "native":
        assert tnative.available()
    return request.param


def _masks(rng, shape):
    mask = rng.random(shape) > 0.6
    yield mask
    yield np.zeros(shape, bool)
    yield np.ones(shape, bool)


@pytest.mark.parametrize("shape", SHAPES)
def test_label_matches_jax(rng, native_mode, shape):
    for mask in _masks(rng, shape):
        labels, n = tnative.label(mask)
        jlabels, jn = jnative.label(mask)
        assert labels.dtype == np.int32 and n == jn
        np.testing.assert_array_equal(labels, jlabels)
        slabels, sn = ndimage.label(mask)
        assert n == sn


@pytest.mark.parametrize("shape", SHAPES)
def test_bounding_boxes_match_jax(rng, native_mode, shape):
    for mask in _masks(rng, shape):
        boxes = tnative.bounding_boxes(mask)
        assert boxes == jnative.bounding_boxes(mask)
        assert tmorph.bounding_boxes_np(mask) == jmorph.bounding_boxes_np(mask)
        assert sorted(tmorph.bounding_boxes_np(mask)) == sorted(boxes)


@pytest.mark.parametrize("shape", SHAPES)
def test_edt_matches_jax_and_scipy(rng, native_mode, shape):
    for mask in _masks(rng, shape):
        got = tnative.edt(mask)
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got, jnative.edt(mask))
        if not mask.all():  # scipy has no convention of its own for no zero
            np.testing.assert_allclose(
                got, ndimage.distance_transform_edt(mask), atol=1e-4)


def test_morphology_is_a_copy_of_jax(rng):
    mask = rng.random((30, 30)) > 0.5
    labels, n = tmorph.connected_components_np(mask)
    jlabels, jn = jmorph.connected_components_np(mask)
    assert n == jn
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(tmorph.skeletonize_np(mask),
                                  jmorph.skeletonize_np(mask))


_LOAD = """
import sys
from pathlib import Path
import visiontransformer_tpu_torch.native as native
native.BUILD_DIR = Path(sys.argv[1])
print(native.library_path().name if native.available() else "none")
"""


def test_processes_started_together_both_load_the_library(tmp_path):
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, str(build)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1 and names.pop().startswith("libvitseg_native.")
    # One library, no temporary file left behind, nothing written into
    # the repository's native/ directory by the port.
    assert sorted(p.name for p in build.iterdir()
                  if p.name != ".lock") == [tnative.library_path().name]


def test_a_failed_build_raises_and_is_tried_again(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setenv("CXX", "false")
    for _ in range(2):  # not remembered as "no library"
        with pytest.raises(RuntimeError, match="VITSEG_NATIVE=0"):
            tnative.label(np.ones((2, 2), bool))
    assert not tnative._TRIED
    monkeypatch.setenv("VITSEG_NATIVE", "0")
    labels, n = tnative.label(np.ones((2, 2), bool))
    assert n == 1 and os.listdir(tmp_path / "build") == [".lock"]
