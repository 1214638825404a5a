"""PyTorch port vs the JAX package: every parallel mode's train step.

The JAX package's own suite holds its meshes to its single-device step
(tests/test_mesh.py, test_fsdp.py, test_seq_parallel.py, test_pipeline.py,
test_multihost.py); here each of the port's modes is held to that same
JAX single-device step, on the tests' TINY config (N = 5 tokens, which no
tp > 1 divides) with dropout off, at the port's trainer tolerances (loss
rtol 1e-5; the mean gradient of the step's micro-batches atol 5e-5, rtol
5e-4, as tests/test_torch_train.py). The ranks are gloo processes on the
CPU (``parallel/launch.py:spawn``), two and four of them, one job each
for all the cases of its size, plus a multi-host job of two OS processes
with two ranks each; their functions are in tests/torch_parallel_ranks.py.
Under dp the batch-global tasks (smp_multiclass, paed_binary) match only
with their sums reduced over the data ranks, metrics included. The GPipe
schedule is also held to the sequential stack on the toy layers of
tests/test_pipeline.py, forward bit for bit and gradients, and the
pipelined and sequence-parallel vitseg forwards to the plain one.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.models.vitseg import vitseg_init
from visiontransformer_tpu.train import tasks as jtasks
from visiontransformer_tpu.train.trainer import Trainer as JaxTrainer
from visiontransformer_tpu_torch.ckpt.convert import vitseg_params_from_jax
from visiontransformer_tpu_torch.parallel import launch

import torch_parallel_ranks as R

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
# Metrics from counts over argmax/threshold decisions: equal up to the
# losses' rounding.
METRIC_TOL = dict(atol=1e-6, rtol=1e-5)

TASKS = {"ce": R.ce_batch, "smp_multiclass": R.ce_batch,
         "paed_binary": R.binary_batch}

MODES_2 = {
    "dp2": {"mesh_shape": (2,)},
    "tp2": {"mesh_shape": (1, 2)},
    "fsdp2": {"mesh_shape": (2,), "fsdp": True, "fsdp_min_size": 0},
    "sp2": {"mesh_shape": (1, 2), "seq_parallel": True},
    "pp2_m1": {"mesh_shape": (1, 2), "pipeline_stages": 2,
               "pipeline_microbatches": 1},
    "pp2_m4": {"mesh_shape": (1, 2), "pipeline_stages": 2,
               "pipeline_microbatches": 4},
}
MODES_4 = {
    "dp2xtp2": {"mesh_shape": (2, 2)},
    "fsdp4": {"mesh_shape": (4,), "fsdp": True, "fsdp_min_size": 0},
    "fsdp2xtp2": {"mesh_shape": (2, 2), "fsdp": True, "fsdp_min_size": 0},
    "fsdp2xtp2_sp": {"mesh_shape": (2, 2), "fsdp": True,
                     "fsdp_min_size": 0, "seq_parallel": True},
    "dp2xpp2": {"mesh_shape": (2, 2), "pipeline_stages": 2,
                "pipeline_microbatches": 2},
}
# Two steps: the sharded Adam moments carry into a second step.
TWO_STEPS = ("dp2xtp2", "fsdp4")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(classes):
    return jcfg.ViTSegConfig(vit=jcfg.ViTConfig(**R.TINY_VIT, **R.NO_DROPOUT),
                             num_classes=classes)


@pytest.fixture(scope="module")
def jax_params():
    """{classes: the JAX init of TINY (numpy leaves)}."""
    return {c: jax.tree_util.tree_map(np.asarray, vitseg_init(
        jax.random.PRNGKey(0), _jcfg(c))) for c in (R.CLASSES, 1)}


@pytest.fixture(scope="module")
def jax_steps(jax_params):
    """task -> the JAX single-device step (batch 16 = 2 x 8, dropout off):
    loss, metrics, and the mean gradient of its micro-batches in the
    port's names."""
    out = {}
    for task, make in TASKS.items():
        classes = 1 if task == "paed_binary" else R.CLASSES
        j, params, batch = _jcfg(classes), jax_params[classes], make()
        trainer = JaxTrainer(j, jcfg.TrainConfig(
            batch_size=16, accumulate_grad_batches=2,
            learning_rate=R.LR, early_stopping_monitor=None),
            task=task, use_mesh=False)
        _, metrics = trainer.train_step(trainer.state_from_params(params),
                                        batch, jax.random.PRNGKey(0))
        grad_fn = jax.jit(jax.grad(lambda p, b: jtasks.TASKS[task](
            p, b, j, rng=jax.random.PRNGKey(0), deterministic=False)[0]))
        grads = [grad_fn(params, {k: jnp.asarray(v[i:i + 8])
                                  for k, v in batch.items()})
                 for i in (0, 8)]
        mean = jax.tree_util.tree_map(lambda a, b: np.asarray((a + b) / 2),
                                      *grads)
        out[task] = {"loss": float(metrics["loss"]),
                     "metrics": {k: float(v) for k, v in metrics.items()},
                     "grads": {k: v.numpy() for k, v in
                               vitseg_params_from_jax(mean).items()}}
    return out


def _spawn(world, calls):
    return launch.spawn(R.run_all, world, (calls,), device_type="cpu",
                        threads=1, timeout=600)[0]


@pytest.fixture(scope="module")
def job2(jax_params):
    """Every two-rank case in one job."""
    steps = [(("ce", k), "ce", m, R.ce_batch(), 1)
             for k, m in MODES_2.items()]
    steps += [((task, "dp2"), task, MODES_2["dp2"], TASKS[task](), 1)
              for task in ("smp_multiclass", "paed_binary")]
    rng = np.random.default_rng(1)
    images = rng.random((8, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, R.CLASSES, (8, 32, 32)).astype(np.int64)
    return _spawn(2, [
        ("steps", "run_steps", (steps, jax_params)),
        ("toy_m1", "toy_pipeline", ((1, 2), 1)),
        ("toy_m2", "toy_pipeline", ((1, 2), 2)),
        ("toy_m3", "toy_pipeline", ((1, 2), 3, True)),
        ("vitseg_pipe", "pipelined_vitseg",
         (jax_params[R.CLASSES], images, labels)),
        ("sp_forward", "seq_parallel_forward",
         (jax_params[R.CLASSES], images)),
        ("pipe_dropout", "pipeline_dropout", ()),
        ("dropout", "dropout_rules", ()),
        ("errors", "shape_errors", ()),
    ])


@pytest.fixture(scope="module")
def job4(jax_params):
    """Every four-rank case in one job."""
    steps = [(("ce", k), "ce", m, R.ce_batch(), 2 if k in TWO_STEPS else 1)
             for k, m in MODES_4.items()]
    return _spawn(4, [
        ("steps", "run_steps", (steps, jax_params)),
        ("toy_2x2", "toy_pipeline", ((2, 2), 3, True)),
        ("toy_1x4", "toy_pipeline", ((1, 4), 6)),
        ("pod", "pod_mesh_dims", ()),
    ])


def _check_step(got, want, *, metrics=False):
    np.testing.assert_allclose(got["losses"][0], want["loss"],
                               rtol=LOSS_RTOL)
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name], g, err_msg=name,
                                   **GRAD_TOL)
    if metrics:
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, err_msg=k,
                                       **METRIC_TOL)


# ------------------------------------------------------------ the steps
@pytest.mark.parametrize("mode", list(MODES_2))
def test_two_rank_step_matches_jax_single_device(job2, jax_steps, mode):
    """dp, tp, FSDP, sequence parallelism and the pipeline at M = 1 and
    M > S on two ranks (counterparts of test_mesh.py's, test_fsdp.py's,
    test_seq_parallel.py's and test_pipeline.py's single-device parity)."""
    got = job2["steps"][("ce", mode)]
    _check_step(got, jax_steps["ce"])


@pytest.mark.parametrize("mode", list(MODES_4))
def test_four_rank_step_matches_jax_single_device(job4, jax_steps, mode):
    """dp x tp, FSDP (alone, with tp and with sequence parallelism) and
    dp x pipeline on four ranks."""
    got = job4["steps"][("ce", mode)]
    _check_step(got, jax_steps["ce"])
    if mode in TWO_STEPS:  # test_mesh.py:test_second_step_with_sharded_moments
        assert len(got["losses"]) == 2 and np.isfinite(got["losses"][1])


@pytest.mark.parametrize("task", ["smp_multiclass", "paed_binary"])
def test_batch_global_tasks_under_dp_match_jax(job2, jax_steps, task):
    """smp_multiclass's tp/fp/fn/tn and paed_binary's dice, |PAED| and
    pixel counts are sums over the global batch: with each data rank's
    sums reduced over "data" the loss, gradients and metrics are the
    single-device step's."""
    _check_step(job2["steps"][(task, "dp2")], jax_steps[task], metrics=True)


def test_fsdp_state_stays_sharded_across_steps(job4):
    """test_fsdp.py's counterpart: after two steps the qkv kernel and its
    Adam moment hold 1/dp of their rows on each rank; under FSDP x tp the
    kernel is split 2 x 2 (rows over "data", heads over "model")."""
    steps = job4["steps"]
    hidden = R.TINY_VIT["hidden_size"]
    assert steps[("ce", "fsdp4")]["qkv_local"] == (hidden // 4, 3 * hidden)
    assert steps[("ce", "fsdp4")]["moment_local"] == (hidden // 4,
                                                      3 * hidden)
    assert steps[("ce", "fsdp2xtp2")]["qkv_local"] == (hidden // 2,
                                                       3 * hidden // 2)
    assert steps[("ce", "dp2xtp2")]["moment_local"] == (hidden,
                                                        3 * hidden // 2)


def test_pod_mesh(job4):
    """test_mesh.py:test_pod_mesh on a four-rank job."""
    pod = job4["pod"]
    assert pod["dims"] == {"data": 2, "model": 2} and pod["dp"] == 2
    assert "must divide" in pod["error"]


# ------------------------------------------------------------- pipeline
@pytest.mark.parametrize("case,world", [("toy_m1", 2), ("toy_m2", 2),
                                        ("toy_m3", 2), ("toy_2x2", 4),
                                        ("toy_1x4", 4)])
def test_pipeline_forward_matches_sequential(job2, job4, case, world):
    """The GPipe schedule computes exactly the sequential stack for every
    dp x S split and microbatch counts below, at and above S."""
    got = (job2 if world == 2 else job4)[case]
    np.testing.assert_array_equal(got["out"], R.toy_reference()["out"])


@pytest.mark.parametrize("case", ["toy_m3", "toy_2x2"])
def test_pipeline_gradients_match(job2, job4, case):
    """Gradients through the schedule's sends (and, at dp = 2, summed
    over "data") equal the sequential ones."""
    got = (job2 if case == "toy_m3" else job4)[case]
    want = R.toy_reference()
    for key in ("w", "b"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-5)


def test_vitseg_pipelined_matches_plain(job2):
    """vitseg_apply_pipelined reproduces vitseg_apply bit for bit, and a
    CE gradient to the JAX test's tolerance."""
    got = job2["vitseg_pipe"]
    np.testing.assert_array_equal(got["got"], got["want"])
    for name, want in got["want_grads"].items():
        np.testing.assert_allclose(got["grads"][name], want, rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_pipeline_trainer_with_dropout_trains(job2):
    """Dropout on: per-(layer, microbatch, shard) generators through the
    stages; two steps run, finite, and the eval loss differs from the
    train loss."""
    got = job2["pipe_dropout"]
    assert all(np.isfinite(x) for x in got["losses"]) and got["step"] == 2
    assert got["eval_loss"] != got["losses"][-1]


def test_seq_parallel_forward_parity(job2):
    """test_seq_parallel.py:test_act_sharding_forward_parity: the
    token-sharded forward equals the plain one; the shards of N = 5 are 3
    and 2 tokens."""
    got = job2["sp_forward"]
    np.testing.assert_allclose(got["got"], got["want"], rtol=1e-5,
                               atol=1e-5)
    assert [tuple(r) for r in got["ranges"]] == [(0, 3), (3, 5)]


# --------------------------------------------------------- dropout, errors
def test_dropout_rules_under_a_mesh(job2):
    """Dropout draws by rank, the rules of train/trainer.py: identical
    rows on the two data ranks still draw differently (the seed folds the
    data rank in); under tp the hidden dropout of the replicated stream is
    the same on both "model" ranks (their losses stay equal, else the
    replicas would part), as it is under sequence parallelism, whose token
    shards draw from per-rank generators; those generators
    (TensorParallel.fork) differ by rank and are stable within one."""
    rules = job2["dropout"]
    dp0, dp1 = rules["dp"]
    assert all(a != b for a, b in zip(dp0, dp1))
    for mode in ("tp", "sp"):
        r0, r1 = rules[mode]
        assert r0 == r1 and all(np.isfinite(r0))
    (a0, b0, base0), (a1, b1, base1) = rules["fork_seeds"]
    assert a0 == b0 and a1 == b1 and a0 != a1
    assert base0 == base1 and a0 != base0


def test_shape_errors_in_a_job(job2):
    """The TPU package's shape errors inside a two-rank job: the
    micro-batch against the data axis (test_mesh.py:
    test_batch_divisibility_error), the mesh against the ranks, the
    pipeline's layers, microbatches and stages
    (test_pipeline.py:test_pipeline_shape_errors); and the port's own: nh
    must divide by tp (GSPMD needs no such rule)."""
    errors = job2["errors"]
    assert "micro-batch 3" in errors["batch"]
    assert "must be divisible by the data-parallel mesh axis (2 devices)" \
        in errors["batch"]
    assert errors["mesh"] == "mesh shape (3, 1) != 2 devices"
    assert errors["layers"] == ("3 encoder layers must divide over 2 "
                                "pipeline stages")
    assert "must divide into 3 pipeline microbatches" in errors[
        "microbatches"]
    assert errors["stage_pp"] == "3 layers must divide over 2 pipeline stages"
    assert "3 attention heads do not divide" in errors["heads"]


# ------------------------------------------------------------ multi-host
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([REPO, HERE] + parts)
    return env


def test_two_process_pod_matches_jax_single_device(tmp_path, jax_params,
                                                   jax_steps):
    """test_multihost.py's counterpart: two OS processes ("hosts") of two
    gloo ranks each meet at a TCP coordinator; one step over the pod mesh
    as dp = 4 and as dp 2 x tp 2 matches the JAX single-device step."""
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(jax_params[R.CLASSES], f)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"),
         str(pid), "2", str(port), str(tmp_path), "steps"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outputs = []
    try:
        outputs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-4000:]
    with open(tmp_path / "result.pkl", "rb") as f:
        result = pickle.load(f)
    assert set(result) == {"dp", "tp2"}
    for got in result.values():
        _check_step(got, jax_steps["ce"])
    assert result["tp2"]["plan"] == "dp dp=2 tp=2"
