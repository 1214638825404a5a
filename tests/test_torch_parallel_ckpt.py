"""PyTorch port: checkpoints, fit, the train command and multi-host runs
under a mesh.

A checkpoint written under a mesh holds the gathered full state in the
single-device format (rank 0 writes, every rank takes part), with
``backbone.layers`` stacked in pipeline mode, as the TPU package's
pipeline checkpoints are. The counterparts of
test_pipeline.py:test_pipeline_checkpoint_restores_for_plain_serving and
test_pipeline_checkpoint_resume_keeps_adam_moments: a pipeline checkpoint
serves (``resolve_model``) and resumes without the pipeline with its Adam
moments, and a plain one resumes a pipeline (stacked target). A dp, FSDP
or tp checkpoint resumes on one rank with equal moments, and a
single-rank checkpoint resumes under every mode. A two-rank ``fit``
writes the single-rank CSV rows (dropout off), from rank 0 only; the
``train`` command starts its ranks for ``--mesh`` and joins a job for
``--multihost`` (test_multihost.py:test_cli_multihost_train), where only
process 0 writes logs.
"""

import csv
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from visiontransformer_tpu_torch.ckpt.io import (
    restore_checkpoint,
    save_checkpoint,
)
from visiontransformer_tpu_torch.cli import main as cli_main
from visiontransformer_tpu_torch.data.synthetic import generate_multiclass
from visiontransformer_tpu_torch.models.vitseg import ViTSeg, vitseg_apply
from visiontransformer_tpu_torch.parallel import launch
from visiontransformer_tpu_torch.parallel.pipeline import (
    is_stacked,
    stack_stage_params,
)
from visiontransformer_tpu_torch.parallel.state import (
    stack_train_state,
    unstack_train_state,
)
from visiontransformer_tpu_torch.train.trainer import Trainer

import torch_parallel_ranks as R

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

SAVE_MODES = [
    ("pipeline", {"mesh_shape": (1, 2), "pipeline_stages": 2}),
    ("fsdp", {"mesh_shape": (2,), "fsdp": True, "fsdp_min_size": 0}),
    ("tp", {"mesh_shape": (1, 2)}),
    ("dp", {"mesh_shape": (2,)}),
]
RESUME_MODES = SAVE_MODES


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plain_step(tmp_path_factory):
    """A single-rank step from the seeded init and its checkpoint."""
    root = tmp_path_factory.mktemp("plain")
    trainer = Trainer(R.seg_cfg(), R.train_cfg(), device="cpu")
    state = trainer.init_state()
    trainer.train_step(state, R.ce_batch(), seed=0)
    path = trainer.save(state, str(root), epoch=0)
    return path, state


@pytest.fixture(scope="module")
def job(plain_step, tmp_path_factory):
    """One two-rank job: a step and a checkpoint in each mode, each mode
    resumed from the single-rank checkpoint, and a two-epoch fit."""
    root = tmp_path_factory.mktemp("mesh")
    generate_multiclass(str(root / "data"), n_samples=8, image_size=40)
    return launch.spawn(R.run_all, 2, ([
        ("saved", "save_modes", (SAVE_MODES, str(root / "ckpt"), None)),
        ("resumed", "resume_modes", (RESUME_MODES, plain_step[0])),
        ("fit", "fit_csv", ({"mesh_shape": (2,)}, str(root / "data"),
                            str(root / "logs"), None)),
    ],), device_type="cpu", threads=1, timeout=600)[0] | {"root": root}


def _opt_state(optimizer):
    sd = optimizer.state_dict()
    return {i: {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
                for k, v in s.items()} for i, s in sd["state"].items()}


# ------------------------------------------------------------- pipeline
def test_pipeline_checkpoint_restores_for_plain_serving(job):
    """The pipeline checkpoint stores backbone.layers stacked; every plain
    restore path unstacks it: resolve_model serves the gathered weights,
    a targeted restore onto a per-layer target fills it, a stacked target
    takes a plain checkpoint, and a mismatched config still fails."""
    path, gathered, _ = job["saved"]["pipeline"]
    disk = restore_checkpoint(path)
    assert is_stacked(disk["params"])
    layers = R.TINY_VIT["num_hidden_layers"]
    assert tuple(disk["params"]["backbone.layers.qkv.kernel"].shape) == (
        layers, 64, 192)
    model = ViTSeg(R.seg_cfg())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           gathered.items()})
    target = ViTSeg(R.seg_cfg())
    restored = restore_checkpoint(path, {"params": target.state_dict()})
    for k, v in restored["params"].items():
        np.testing.assert_array_equal(v.numpy(), gathered[k], err_msg=k)
    x = torch.from_numpy(R.ce_batch(n=2)["image"])
    with torch.no_grad():
        np.testing.assert_array_equal(vitseg_apply(target, x).numpy(),
                                      vitseg_apply(model, x).numpy())
    # The reverse: a plain checkpoint onto a stacked target.
    plain = save_checkpoint(str(job["root"] / "plain_for_stacked"),
                            {"params": target.state_dict()}, epoch=0, step=1)
    stacked_target = {k: torch.zeros_like(v) for k, v in
                      stack_stage_params(target.state_dict()).items()}
    back = restore_checkpoint(plain, {"params": stacked_target})["params"]
    assert torch.equal(back["backbone.layers.qkv.kernel"][1],
                       target.state_dict()["backbone.layers.1.qkv.kernel"])
    wrong = ViTSeg(R.seg_cfg(hidden_size=32, num_attention_heads=2))
    with pytest.raises(ValueError, match="different model configuration"):
        restore_checkpoint(path, {"params": wrong.state_dict()})


def test_pipeline_checkpoint_serves_through_resolve_model(job):
    """resolve_model on a pipeline checkpoint: the per-layer model with
    the gathered weights (P16H512A8's geometry is not TINY's, so the
    check loads the checkpoint into TINY's model directly as
    resolve_model's loader does: maybe_unstack_params, then strict)."""
    from visiontransformer_tpu_torch.models import registry

    path, gathered, _ = job["saved"]["pipeline"]
    loaded = registry._checkpoint_params(path, "vitseg", R.seg_cfg())
    assert not is_stacked(loaded)
    model = ViTSeg(R.seg_cfg())
    model.load_state_dict(loaded, strict=True)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), gathered[k], err_msg=k)


def test_pipeline_checkpoint_resume_keeps_adam_moments(job):
    """Pipeline -> plain: the stacked moments land on the per-layer
    optimizer, layer by layer, non-zero; plain -> pipeline: a pipeline
    trainer resumed from a plain checkpoint holds its moments (gathered
    back, stacked)."""
    path, _, saved_opt = job["saved"]["pipeline"]
    trainer = Trainer(R.seg_cfg(), R.train_cfg(), device="cpu")
    state = trainer.init_state()
    restore_checkpoint(path, {"params": state.model.state_dict(),
                              "opt_state": state.optimizer, "step": 0})
    disk = restore_checkpoint(path)
    flat, flat_opt = unstack_train_state(disk["params"], disk["opt_state"])
    names = [n for n, _ in state.model.named_parameters()]
    got = _opt_state(state.optimizer)
    i = names.index("backbone.layers.1.qkv.kernel")
    assert np.abs(got[i]["exp_avg"]).sum() > 0
    for j, n in enumerate(names):
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(
                got[j][key], flat_opt["state"][list(flat).index(n)][key]
                .numpy(), err_msg=n)


def test_plain_checkpoint_resumes_a_pipeline(job, plain_step):
    path, state = plain_step
    params, opt, step = job["resumed"]["pipeline"]
    assert step == state.step == 1
    sd = {k: v.detach() for k, v in state.model.state_dict().items()}
    want_params, want_opt = stack_train_state(sd,
                                              state.optimizer.state_dict())
    assert list(params) == list(want_params)
    for k, v in want_params.items():
        np.testing.assert_array_equal(params[k], v.numpy(), err_msg=k)
    for i, s in want_opt["state"].items():
        for key, v in s.items():
            np.testing.assert_array_equal(np.asarray(opt["state"][i][key]),
                                          v.numpy(), err_msg=(i, key))


# ------------------------------------------------------ other modes
@pytest.mark.parametrize("mode", ["fsdp", "tp", "dp"])
def test_mesh_checkpoint_resumes_on_one_rank(job, mode):
    """A dp, FSDP or tp checkpoint is the gathered full state: it resumes
    a single-rank trainer with the params and moments the ranks held."""
    path, gathered, gathered_opt = job["saved"][mode]
    assert not is_stacked(restore_checkpoint(path)["params"])
    trainer = Trainer(R.seg_cfg(), R.train_cfg(), device="cpu")
    state = trainer.init_state()
    restored = restore_checkpoint(path, {"params": state.model.state_dict(),
                                         "opt_state": state.optimizer,
                                         "step": 0})
    assert restored["step"] == 1
    got = _opt_state(state.optimizer)
    assert set(got) == set(gathered_opt["state"])
    for i, s in gathered_opt["state"].items():
        for key, v in s.items():
            np.testing.assert_array_equal(got[i][key], np.asarray(v))
    for n, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), gathered[n])


@pytest.mark.parametrize("mode", ["fsdp", "tp", "dp"])
def test_single_rank_checkpoint_resumes_under_a_mesh(job, plain_step, mode):
    """The reverse: each rank keeps its part of a single-rank checkpoint;
    gathered back, params and moments are the checkpoint's."""
    _, state = plain_step
    params, opt, step = job["resumed"][mode]
    assert step == 1
    for k, v in state.model.state_dict().items():
        np.testing.assert_array_equal(params[k], v.numpy(), err_msg=k)
    want = _opt_state(state.optimizer)
    for i, s in want.items():
        for key, v in s.items():
            np.testing.assert_array_equal(np.asarray(opt["state"][i][key]),
                                          np.asarray(v), err_msg=(i, key))


# ------------------------------------------------------------ fit, CLI
def test_two_rank_fit_writes_the_single_rank_csv_rows(job):
    """fit on two data ranks (dropout off) logs the single-rank run's CSV
    rows (validation counts reduced over the ranks), and only rank 0
    writes."""
    got = job["fit"]
    assert got["wrote"] == [True, False]
    want = R.fit_csv({}, str(job["root"] / "data"),
                     str(job["root"] / "single_logs"), None)
    assert [r.keys() for r in got["rows"]] == [r.keys() for r in want["rows"]]
    for a, b in zip(got["rows"], want["rows"]):
        for key in a:
            if key == "epoch_time_s" or not a[key]:
                assert bool(a[key]) == bool(b[key]), key
                continue
            np.testing.assert_allclose(float(a[key]), float(b[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


def test_train_command_with_mesh(tmp_path):
    """train --mesh 2 starts two ranks (gloo on the CPU): one log
    directory, written by rank 0, and the shared checkpoint directory."""
    generate_multiclass(str(tmp_path / "data"), n_samples=4, image_size=40)
    rc = cli_main(["train", "--data", str(tmp_path / "data"),
                   "--config", "P16H512A8", "--image-size", "32",
                   "--batch-size", "2", "--accumulate", "1",
                   "--max-epochs", "1", "--no-split", "--mesh", "2",
                   "--logs", str(tmp_path / "logs"), "--device", "cpu"])
    assert rc == 0
    assert os.listdir(tmp_path / "logs" / "vit-model") == ["version_0"]
    with open(tmp_path / "logs" / "vit-model" / "version_0"
              / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert np.isfinite(float(rows[-1]["valid_loss"]))
    assert os.listdir(tmp_path / "logs" / "checkpoints") == [
        "epoch=0-step=2"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_multihost_train(tmp_path):
    """train --multihost across two OS processes: both join the job inside
    the command, only process 0 writes logs, both take part in the shared
    checkpoint."""
    generate_multiclass(str(tmp_path / "data"), n_samples=8, image_size=40,
                        seed=1)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, HERE] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"),
         str(pid), "2", str(port), str(tmp_path), "cli"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
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
    assert "[proc 0] cli done" in outputs[0]
    assert (tmp_path / "logs0" / "vit-model" / "version_0"
            / "metrics.csv").exists()
    assert not (tmp_path / "logs1").exists()
    assert os.listdir(tmp_path / "ckpt_shared")
