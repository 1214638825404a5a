"""The harness finds every part of a cell by name, BENCHMARK.json keeps
to its contract, and run.py refuses a host without a card."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return harness.bench_spec()


def test_spec_keys_and_names(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    names = ([c["name"] for c in spec["configs"]]
             + [w["name"] for w in spec["workloads"]]
             + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]])
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in spec[group]}) == len(spec[group])
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len(json.dumps(spec)) < 64 * 1024


def test_configs_and_cells_resolve(spec):
    used = {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and os.path.isfile(
            os.path.join(harness.REPO_ROOT, c["file"]))
        assert harness.load_config(c["name"])["reduced"] == c["reduced"]
        assert not [k for k in c["reduced"] if k.endswith(("_dim", "_rank",
                                                           "_size"))]
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = harness.load_traffic(w["traffic"])
        assert os.path.isfile(os.path.join(
            harness.BENCH_DIR, "drivers", f"{traffic['driver']}.py"))
        assert harness.load_limits(w["name"])


def test_metrics_resolve_and_every_cell_reports(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert callable(harness.load_reader(m["name"]))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in spec["workloads"]:
        ends = harness.cell_metrics(spec, w["name"], "end_to_end")
        layers = harness.cell_metrics(spec, w["name"], "per_layer")
        assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2
        assert layers and all(m["moves"] in {e["name"] for e in ends}
                              for m in layers)
        assert any("mfu" in m["name"] for m in layers)


def test_a_new_cell_takes_only_new_files(tmp_path):
    """A configuration, a traffic mix, a limits file and a per-layer
    metric added as files are found by their names, with no edit."""
    root = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = harness.load_config("vitseg_b16")
    cfg.update(name="vitseg_l16", hidden_size=1024, num_hidden_layers=24)
    (root / "configs" / "vitseg_l16.json").write_text(json.dumps(cfg))
    (root / "traffic" / "bulk8.json").write_text(json.dumps(
        dict(harness.load_traffic("bulk32"), batch=8)))
    (root / "limits" / "serve_l16_bulk8.json").write_text(
        json.dumps({"mask_gap_max": 0.06}))
    (root / "metrics" / "launches.serve.py").write_text(
        "def read(outcome):\n    return outcome.layer.get('launches')\n")
    assert harness.load_config("vitseg_l16", root)["hidden_size"] == 1024
    traffic = harness.load_traffic("bulk8", root)
    assert traffic["batch"] == 8
    assert harness.load_driver(traffic["driver"], root).run
    assert harness.load_limits("serve_l16_bulk8", root)
    out = harness.Outcome()
    out.layer["launches"] = 12
    assert harness.load_reader("launches.serve", root)(out) == 12
    spec = harness.bench_spec()
    spec["workloads"].append({"name": "serve_l16_bulk8",
                              "config": "vitseg_l16", "traffic": "bulk8",
                              "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "launches.serve", "unit": "launches",
                              "better": "lower", "source": "program_counter",
                              "layer": "model step", "moves": "masks_per_s"})
    spec["end_to_end"][0]["workloads"].append("serve_l16_bulk8")
    names = {m["name"] for m in harness.cell_metrics(spec, "serve_l16_bulk8",
                                                     "per_layer")}
    assert "launches.serve" in names and "mfu.serve" not in names


def test_quantile_and_spread():
    assert harness.quantile([3, 1, 2], 0.5) == 2
    assert harness.quantile([1, 2, 3, 4], 0.25) == 1.75
    assert harness.quantile([], 0.5) is None
    vals = [10.0, 10.2, 9.8, 10.1, 9.9, 10.0]
    assert 0.0 < harness.spread(vals) < 0.05


def test_check_holds_numbers_to_their_limits():
    import math
    ctx = harness.Context(cell={"name": "x", "chips": 1}, config={},
                          traffic={}, limits={"a": 0.5, "b": 0.0}, seed=1,
                          seconds=1, trace=False, device=None, t0=0.0,
                          tmpdir="")
    assert ctx.check("a", 0.4) and not ctx.check("b", 1.0)
    assert not ctx.check("a", math.nan) and not ctx.check("a", math.inf)


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "serve_b16_bulk",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=harness.REPO_ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_run_alone_in_a_bare_directory_exits_nonzero(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark: the
    program is missing, so no result."""
    shutil.copy(harness.SPEC_FILE, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "serve_b16_bulk",
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
