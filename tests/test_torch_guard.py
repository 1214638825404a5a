"""Guards of the PyTorch port's rules.

- No file of the port, nor chip_smoke.py, imports JAX or any module of the
  JAX package (``visiontransformer_tpu`` and its submodules; the port's own
  name shares that prefix and is allowed).
- The port's entry points default to CUDA and raise on a host without it
  instead of falling back to the CPU.
- Importing the package builds no kernel.
"""

import ast
import importlib
import os
import pkgutil

import pytest
import torch

import visiontransformer_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "visiontransformer_tpu_torch")
FILES = sorted(
    os.path.relpath(os.path.join(root, f), REPO)
    for root, _, files in os.walk(PORT) for f in files if f.endswith(".py")
) + ["chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "visiontransformer_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_scan_finds_the_port():
    assert len(FILES) > 20
    assert not _forbidden("visiontransformer_tpu_torch.ops.attention")
    assert _forbidden("visiontransformer_tpu.ops.attention")
    assert _forbidden("jax.numpy")


@pytest.mark.parametrize("path", FILES)
def test_no_jax_or_jax_package_import(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_builds_nothing():
    from visiontransformer_tpu_torch.ops import _build

    for mod in pkgutil.walk_packages(visiontransformer_tpu_torch.__path__,
                                     "visiontransformer_tpu_torch."):
        importlib.import_module(mod.name)
    assert _build._LIBS == {}


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")


def test_model_runner_defaults_to_cuda(no_cuda):
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    with pytest.raises(RuntimeError, match="CUDA"):
        ModelRunner({"input_size": 224, "config_name": "P16H768A12",
                     "num_classes": 17})


def test_worker_registry_and_server_default_to_cuda(no_cuda, tmp_path):
    from visiontransformer_tpu_torch.models.registry import resolve_model
    from visiontransformer_tpu_torch.serve import server
    from visiontransformer_tpu_torch.serve.store import JobStore
    from visiontransformer_tpu_torch.serve.worker import InferenceWorker

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_model("vitseg", "P16H768A12", num_classes=17)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceWorker(JobStore(":memory:", media_root=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA"):
        server.main(["--db", str(tmp_path / "serving.db"),
                     "--media-root", str(tmp_path / "media"), "--port", "0"])
