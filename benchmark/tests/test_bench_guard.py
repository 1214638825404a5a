"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program either. Names are compared by
their top-level part, whole: the port's name begins with the JAX
package's."""

import ast
import os
import subprocess
import sys

from benchmark import harness

JAX = {"jax", "jaxlib", "flax", "visiontransformer_tpu"}
PORT = "visiontransformer_tpu_torch"


def _imports(path: str):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub: str = ""):
    base = os.path.join(harness.BENCH_DIR, sub)
    for d, _, names in os.walk(base):
        if os.sep + "tests" in d[len(str(harness.BENCH_DIR)):]:
            continue
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def test_no_file_of_the_benchmark_imports_jax():
    found = {(f, m) for f in _files() for m in _imports(f) if m in JAX}
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    found = {(f, m) for f in _files("reference") for m in _imports(f)
             if m in JAX | {PORT}}
    assert not found


def test_the_names_are_compared_whole():
    assert "visiontransformer_tpu_torch".split(".")[0] not in JAX
    assert harness.forbidden_loaded() == sorted(
        n for n in sys.modules if n.split(".")[0] in harness.FORBIDDEN)
    assert set(harness.FORBIDDEN) == JAX


def test_loading_every_driver_loads_no_jax():
    """In a fresh process: the harness, every driver and reader, the
    port's modules they import, and the reference."""
    code = (
        "import sys, os; sys.path.insert(0, os.getcwd())\n"
        "from benchmark import harness, run\n"
        "spec = harness.bench_spec()\n"
        "for w in spec['workloads']:\n"
        "    t = harness.load_traffic(w['traffic'])\n"
        "    harness.load_driver(t['driver'])\n"
        "for m in spec['per_layer'] + spec['end_to_end']:\n"
        "    if os.path.exists(f\"benchmark/metrics/{m['name']}.py\"):\n"
        "        harness.load_reader(m['name'])\n"
        "import benchmark.reference.vitseg\n"
        "import visiontransformer_tpu_torch.serve.worker\n"
        "print(harness.forbidden_loaded())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO_ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
