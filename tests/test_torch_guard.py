"""Guards of the PyTorch port's rules.

- No file of the port, nor chip_smoke.py, imports JAX, Orbax (which
  imports JAX) or any module of the JAX package (``visiontransformer_tpu`` and its submodules; the port's own
  name shares that prefix and is allowed), nor ``transformers`` or
  ``safetensors``, which the GPU machine lacks.
- The port's entry points default to CUDA and raise on a host without it
  instead of falling back to the CPU; chip_smoke.py exits non-zero there
  and prints no result.
- Importing the package builds no kernel.
- tensorstore (the Orbax reader's, ``ckpt/orbax_read.py``), matplotlib and
  pandas (the reports', ``evaluation/``) are imported only inside the
  functions that need them, which the GPU machine may lack: importing the
  package, parsing the CLI and ``doctor`` load none of them.
"""

import ast
import importlib
import os
import pkgutil
import subprocess
import sys

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
    # transformers and safetensors: the GPU machine has neither, so a port
    # file importing them would fail there only (tests may import them).
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "orbax",
                   "visiontransformer_tpu", "transformers", "safetensors")


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
    assert _forbidden("orbax.checkpoint")
    assert _forbidden("transformers")
    assert _forbidden("safetensors.torch")


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


@pytest.mark.parametrize("sweep", ["tune_flash2", "tune_flash3"])
def test_flash_sweeps_default_to_cuda(no_cuda, sweep):
    module = importlib.import_module(
        f"visiontransformer_tpu_torch.scripts.{sweep}")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(["200", "2"])


def test_chip_smoke_fails_without_cuda(no_cuda):
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert '"ok"' not in proc.stdout


# Optional packages: module -> the port files that may import it, inside a
# function body only.
OPTIONAL = {"tensorstore": ("visiontransformer_tpu_torch/ckpt/orbax_read.py",),
            "matplotlib": ("visiontransformer_tpu_torch/evaluation/",),
            "pandas": ("visiontransformer_tpu_torch/evaluation/",)}


def _optional_imports(tree):
    """(module, inside a function) of each import of an OPTIONAL module."""
    def walk(node, in_function):
        for child in ast.iter_child_nodes(node):
            inside = in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                names = [child.module or ""]
            else:
                names = []
            for name in names:
                if name.split(".")[0] in OPTIONAL:
                    yield name.split(".")[0], inside
            yield from walk(child, inside)

    return list(walk(tree, False))


@pytest.mark.parametrize("path", FILES)
def test_optional_packages_only_inside_functions(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    for module, inside in _optional_imports(tree):
        assert path.startswith(OPTIONAL[module]), f"{path} imports {module}"
        assert inside, f"{path} imports {module} at module level"


def test_optional_import_scan_finds_them():
    found = {}
    for path in FILES:
        with open(os.path.join(REPO, path)) as f:
            for module, _ in _optional_imports(ast.parse(f.read(), path)):
                found.setdefault(module, set()).add(path)
    assert set(found) == set(OPTIONAL)
    assert _optional_imports(ast.parse("import pandas as pd")) == [
        ("pandas", False)]
    assert _optional_imports(ast.parse(
        "def f():\n    from matplotlib import pyplot")) == [
            ("matplotlib", True)]


_IMPORT_PARSE_DOCTOR = """
import contextlib, io, json, sys
import visiontransformer_tpu_torch
from visiontransformer_tpu_torch import cli
for command in cli.COMMANDS:  # each command's parser
    with contextlib.suppress(SystemExit), contextlib.redirect_stdout(
            io.StringIO()):
        cli.main([command, "--help"])
with contextlib.redirect_stdout(io.StringIO()) as out:
    rc = cli.main(["doctor", "--cpu"])
json.loads(out.getvalue())
loaded = sorted({m.split(".")[0] for m in sys.modules} &
                {"tensorstore", "matplotlib", "pandas"})
print(rc, loaded)
"""


def test_package_cli_and_doctor_load_no_optional_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_PARSE_DOCTOR],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[-2] == "0 []", proc.stdout
