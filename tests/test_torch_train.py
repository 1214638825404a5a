"""PyTorch port vs the JAX package: the training slice.

Losses, the nearest target resize, the smp multiclass metrics, the five
tasks (ce, smp_multiclass and the three PAED tasks), the optimizers and one
accumulated ``train_step`` (ce and paed_binary) are held against the JAX
package on the tiny config of tests/test_torch_model.py, with weights from
the weight bridge; ``fit``, its CSV log and schedules (the PAED defaults'
``val_`` monitors included), and the ``train`` command run on the CPU
because the tests ask for it (``device="cpu"``).
"""

import csv
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.losses import basic as jlosses
from visiontransformer_tpu.metrics import segmentation as jmetrics
from visiontransformer_tpu.models.vitseg import vitseg_init
from visiontransformer_tpu.ops.resize import resize_nearest_torch as jnearest
from visiontransformer_tpu.train import optim as joptim
from visiontransformer_tpu.train import tasks as jtasks
from visiontransformer_tpu.train.trainer import Trainer as JaxTrainer
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.ckpt.convert import (
    load_jax_params,
    vitseg_params_from_jax,
)
from visiontransformer_tpu_torch.cli import main as cli_main
from visiontransformer_tpu_torch.data import (
    CESegmentationDataset,
    PAEDBinaryDataset,
)
from visiontransformer_tpu_torch.data.synthetic import (
    generate_binary,
    generate_multiclass,
)
from visiontransformer_tpu_torch.losses import basic as tlosses
from visiontransformer_tpu_torch.metrics import segmentation as tmetrics
from visiontransformer_tpu_torch.models.vitseg import ViTSeg, vitseg_apply
from visiontransformer_tpu_torch.nn.layers import dropout
from visiontransformer_tpu_torch.ops.resize import resize_nearest_torch
from visiontransformer_tpu_torch.train import optim as toptim
from visiontransformer_tpu_torch.train import tasks as ttasks
from visiontransformer_tpu_torch.train.trainer import Trainer
from visiontransformer_tpu_torch.utils.csvlog import CSVLogger

VIT = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CLASSES = 5
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(classes=CLASSES, **vit):
    j = jcfg.ViTSegConfig(vit=jcfg.ViTConfig(**VIT, **vit),
                          num_classes=classes)
    t = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**VIT, **vit),
                          num_classes=classes)
    return j, t


def _init(classes):
    return jax.tree_util.tree_map(
        np.asarray, vitseg_init(jax.random.PRNGKey(0), _configs(classes)[0]))


@pytest.fixture(scope="module")
def jax_params():
    return _init(CLASSES)


@pytest.fixture(scope="module")
def jax_params_binary():
    """One output class: the paed_binary task's model."""
    return _init(1)


def _batch(rng, b=4, mask_size=40, binary=False):
    if binary:  # crack masks as PAEDBinaryDataset gives them: {0, 1} fp32
        mask = (rng.random((b, mask_size, mask_size)) > 0.8).astype(
            np.float32)
        mask[0] = 0.0  # an image without a crack: the saturated SDF
    else:
        mask = rng.integers(0, CLASSES, (b, mask_size, mask_size),
                            dtype=np.int32)
    return {"image": rng.random((b, 32, 32, 3), np.float32), "mask": mask}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------ configs
def test_train_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.TrainConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.TrainConfig)]
    assert jf == tf
    for name in ("CE_TRAIN_DEFAULTS", "PAED_TRAIN_DEFAULTS"):
        assert (dataclasses.asdict(getattr(jcfg, name))
                == dataclasses.asdict(getattr(tcfg, name)))
    # The parallelism fields are real: a composition the TPU package
    # refuses, the port refuses with its message.
    kw = dict(pipeline_stages=2, seq_parallel=True)
    j, t = _configs()
    with pytest.raises(ValueError) as want:
        JaxTrainer(j, jcfg.TrainConfig(**kw), use_mesh=False)
    with pytest.raises(ValueError) as got:
        Trainer(t, tcfg.TrainConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value) == (
        "pipeline_stages does not compose with fsdp/seq_parallel")


# ------------------------------------------------------------------- losses
@pytest.mark.parametrize("name", ["cross_entropy_loss", "binary_cross_entropy",
                                  "dice_loss"])
def test_losses_match(rng, name):
    if name == "cross_entropy_loss":
        args = (rng.standard_normal((2, 9, 9, CLASSES)).astype(np.float32),
                rng.integers(0, CLASSES, (2, 9, 9)).astype(np.int32))
    else:
        probs = rng.random((2, 9, 9, 1)).astype(np.float32)
        probs.flat[:4] = [0.0, 1.0, 0.0, 1.0]   # the -100 clamp
        args = (probs, (rng.random((2, 9, 9, 1)) > 0.5).astype(np.float32))
    got = getattr(tlosses, name)(*(torch.from_numpy(a) for a in args))
    want = getattr(jlosses, name)(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("src,dst", [(40, 32), (256, 224), (7, 13)])
def test_resize_nearest_torch_matches(rng, src, dst):
    x = rng.integers(0, 17, (2, src, src + 3)).astype(np.int32)
    got = resize_nearest_torch(torch.from_numpy(x), (dst, dst + 1))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnearest(jnp.asarray(x), (dst, dst + 1))))


# ------------------------------------------------------------------ metrics
@pytest.mark.parametrize("case", ["random", "perfect", "one_class"])
def test_multiclass_metrics_match(rng, case):
    gt = rng.integers(0, CLASSES, (3, 12, 12)).astype(np.int32)
    pred = {"random": rng.integers(0, CLASSES, gt.shape).astype(np.int32),
            "perfect": gt,
            "one_class": np.zeros_like(gt)}[case]
    got = tmetrics.multiclass_confusion_stats(torch.from_numpy(pred),
                                              torch.from_numpy(gt), CLASSES)
    want = jmetrics.multiclass_confusion_stats(jnp.asarray(pred),
                                               jnp.asarray(gt), CLASSES)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for fn in ("smp_iou_micro", "smp_iou_micro_imagewise"):
        np.testing.assert_allclose(float(getattr(tmetrics, fn)(*got)),
                                   float(getattr(jmetrics, fn)(*want)),
                                   rtol=1e-6)


# -------------------------------------------------------------------- tasks
@pytest.mark.parametrize("task", ["ce", "smp_multiclass", "paed_multiclass",
                                  "paed_anchored", "paed_binary"])
def test_task_losses_and_metrics_match(rng, request, task):
    binary = task == "paed_binary"
    jax_params = request.getfixturevalue(
        "jax_params_binary" if binary else "jax_params")
    j, t = _configs(1 if binary else CLASSES)
    batch = _batch(rng, binary=binary)
    model = load_jax_params(ViTSeg(t), jax_params)
    with torch.no_grad():
        loss, metrics = ttasks.get_task(task)(
            model, _torch_batch(batch), t, deterministic=True,
            attn_impl="eager")
    jloss, jmetrics_ = jtasks.TASKS[task](
        jax_params, {k: jnp.asarray(v) for k, v in batch.items()}, j,
        deterministic=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmetrics_)
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics_[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_unknown_task_raises():
    assert set(ttasks.TASKS) == set(jtasks.TASKS)
    with pytest.raises(KeyError, match="paed_binary"):
        ttasks.get_task("nope")


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_optimizer_matches_optax(rng, optimizer):
    cfg = tcfg.TrainConfig(optimizer=optimizer, learning_rate=1e-3)
    params = {"w": (0.02 * rng.standard_normal((5, 7))).astype(np.float32),
              "b": (0.02 * rng.standard_normal(7)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jopt = joptim.build_optimizer(jcfg.TrainConfig(optimizer=optimizer,
                                                   learning_rate=1e-3))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    topt = toptim.build_optimizer(cfg, tparams.values())
    for g in grads:
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in params:
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(jparams[k]), atol=1e-7, rtol=0)
    toptim.set_learning_rate(topt, 5e-4)
    assert all(g["lr"] == 5e-4 for g in topt.param_groups)


def test_schedulers_are_copies():
    values = [3.0, 2.0, 2.5, 2.5, 1.0, 1.2, 1.3, 1.4]
    for mode in ("min", "max"):
        ja, ta = (joptim.PlateauScheduler(1.0, mode=mode, patience=1),
                  toptim.PlateauScheduler(1.0, mode=mode, patience=1))
        jb, tb = (joptim.EarlyStopping(2, mode), toptim.EarlyStopping(2, mode))
        for x in values:
            assert ja.step(x) == ta.step(x)
            assert jb.step(x) == tb.step(x)


# --------------------------------------------------------------- train step
# The step's optimizer: the CE defaults' Adam, the PAED defaults' AdamW.
STEP_OPTIMIZER = {"ce": "adam", "paed_binary": "adamw"}


@pytest.fixture(scope="module")
def jax_steps():
    """task -> one JAX Trainer step (batch 4 = 2 micro-batches of 2,
    dropout off) and the mean gradient of its two micro-batches, made at
    first use."""
    steps = {}

    def get(task, params):
        if task not in steps:
            binary = task == "paed_binary"
            j, _ = _configs(1 if binary else CLASSES, **NO_DROPOUT)
            batch = _batch(np.random.default_rng(7), binary=binary)
            trainer = JaxTrainer(j, jcfg.TrainConfig(
                batch_size=4, accumulate_grad_batches=2, learning_rate=LR,
                optimizer=STEP_OPTIMIZER[task]), task=task, use_mesh=False)
            state = trainer.state_from_params(params)
            new_state, metrics = trainer.train_step(state, batch,
                                                    jax.random.PRNGKey(0))
            grad_fn = jax.jit(jax.grad(lambda p, b: jtasks.TASKS[task](
                p, b, j, rng=jax.random.PRNGKey(0), deterministic=False)[0]))
            grads = [grad_fn(params, {k: jnp.asarray(v[i:i + 2])
                                      for k, v in batch.items()})
                     for i in (0, 2)]
            mean = jax.tree_util.tree_map(
                lambda a, b: np.asarray((a + b) / 2), *grads)
            steps[task] = (batch, float(metrics["loss"]),
                           vitseg_params_from_jax(mean),
                           vitseg_params_from_jax(jax.tree_util.tree_map(
                               np.asarray, new_state.params)))
        return steps[task]

    return get


@pytest.mark.parametrize(
    "task,attn_impl",
    [("ce", "eager"), ("ce", "flash"), ("paed_binary", "eager"),
     ("paed_binary", "flash")],
    ids=["eager", "flash", "paed_binary-eager", "paed_binary-flash"])
def test_train_step_matches_jax_trainer(request, jax_steps, task, attn_impl):
    binary = task == "paed_binary"
    jax_params = request.getfixturevalue(
        "jax_params_binary" if binary else "jax_params")
    batch, jloss, jgrads, jnew = jax_steps(task, jax_params)
    _, t = _configs(1 if binary else CLASSES, **NO_DROPOUT)
    trainer = Trainer(t, tcfg.TrainConfig(
        batch_size=4, accumulate_grad_batches=2, learning_rate=LR,
        optimizer=STEP_OPTIMIZER[task]), task=task, device="cpu",
        attn_impl=attn_impl)
    state = trainer.init_state(jax_params)
    state, metrics = trainer.train_step(state, batch, seed=0)
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-5)
    for name, p in state.model.named_parameters():
        want = jgrads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, atol=5e-5,
                                   rtol=5e-4, err_msg=name)
        # Adam's first step is lr·g/(|g| + eps): rounding at near-zero
        # gradients moves by up to lr, elsewhere within lr·1e-2.
        diff = np.abs(p.detach().numpy() - jnew[name].numpy())
        assert diff.max() <= 2 * LR, name
        big = np.abs(want) > 1e-6
        assert (diff[big] <= LR * 1e-2).all(), name


def test_train_step_dropout_is_seeded(rng, jax_params):
    _, t = _configs()
    trainer = Trainer(t, tcfg.TrainConfig(batch_size=4,
                                          accumulate_grad_batches=2),
                      device="cpu")
    batch = _batch(rng)
    losses = []
    for seed in (3, 3, 4):
        state = trainer.init_state(jax_params)
        losses.append(float(trainer.train_step(state, batch, seed)[1]["loss"]))
    assert losses[0] == losses[1] != losses[2]
    with pytest.raises(ValueError, match="divisible"):
        trainer.train_step(state, _batch(rng, b=3), 0)


@pytest.mark.parametrize("attn_impl", ["eager", "flash"])
def test_training_forward_dropout(rng, jax_params, attn_impl):
    _, t = _configs()
    model = load_jax_params(ViTSeg(t), jax_params)
    x = torch.from_numpy(_batch(rng)["image"])
    run = lambda seed: vitseg_apply(
        model, x, attn_impl=attn_impl, deterministic=False,
        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        a, b, c = run(1), run(1), run(2)
        eval_out = vitseg_apply(model, x, attn_impl=attn_impl)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert float((a - c).abs().max()) > 1e-4
    assert float((a - eval_out).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="Generator"):
        vitseg_apply(model, x, attn_impl=attn_impl, deterministic=False)


def test_dropout_layer():
    x = torch.ones(200, 500)
    y = dropout(x, 0.1, generator=torch.Generator().manual_seed(0),
                deterministic=False)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 4 * (0.09 / x.numel()) ** 0.5
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert dropout(x, 0.1, generator=None, deterministic=True) is x


# ---------------------------------------------------------------------- fit
@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic"))
    generate_multiclass(root, n_samples=8, image_size=40)
    return CESegmentationDataset(f"{root}/image_png", f"{root}/mask_png",
                                 image_size=32, cache=True)


def _rows(path):
    with open(path) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_fit_csv_columns_match_jax(tmp_path, dataset):
    train_cfg = dict(batch_size=4, accumulate_grad_batches=2, max_epochs=2,
                     log_every_n_steps=1)
    j, t = _configs(dataset.num_classes)
    jlog = tmp_path / "jax"
    from visiontransformer_tpu.utils.csvlog import CSVLogger as JaxCSVLogger
    JaxTrainer(j, jcfg.TrainConfig(**train_cfg), use_mesh=False,
               logger=JaxCSVLogger(str(jlog))).fit(dataset,
                                                   val_dataset=dataset)
    trainer = Trainer(t, tcfg.TrainConfig(**train_cfg), device="cpu",
                      logger=CSVLogger(str(tmp_path / "port")))
    state = trainer.fit(dataset, val_dataset=dataset)
    assert state.step == 4
    jfields, jrows = _rows(next(jlog.glob("*/version_0/metrics.csv")))
    fields, rows = _rows(trainer.logger.path)
    assert fields == jfields
    assert ([(r["epoch"], r["step"]) for r in rows]
            == [(r["epoch"], r["step"]) for r in jrows])
    assert all(np.isfinite(float(r["train_loss"])) for r in rows
               if r["train_loss"])


@pytest.mark.parametrize("schedule", ["early_stopping", "plateau"])
def test_fit_schedules_follow_optim_semantics(tmp_path, dataset, schedule):
    # valid_loss falls from epoch to epoch, so in "max" mode every epoch
    # after the first is a bad one: early stopping (patience 1) ends the
    # run after epoch 1; the plateau scheduler (patience 1) drops the LR
    # after epoch 2. The logged values replayed through the TPU package's
    # schedulers give the same decisions.
    _, t = _configs(dataset.num_classes)
    common = dict(batch_size=4, accumulate_grad_batches=2, max_epochs=3,
                  learning_rate=1e-3)
    if schedule == "early_stopping":
        cfg = tcfg.TrainConfig(early_stopping_monitor="valid_loss",
                               early_stopping_mode="max",
                               early_stopping_patience=1, **common)
    else:
        cfg = tcfg.TrainConfig(early_stopping_monitor=None,
                               plateau_patience=1,
                               plateau_monitor="valid_loss",
                               plateau_mode="max", **common)
    trainer = Trainer(t, cfg, device="cpu",
                      logger=CSVLogger(str(tmp_path)))
    state = trainer.fit(dataset, val_dataset=dataset)
    values = [float(r["valid_loss"]) for r in _rows(trainer.logger.path)[1]]
    if schedule == "early_stopping":
        stopper = joptim.EarlyStopping(1, "max")
        epochs = next(i + 1 for i, v in enumerate(values) if stopper.step(v))
        assert len(values) == epochs == 2
    else:
        plateau = joptim.PlateauScheduler(1e-3, mode="max", patience=1)
        lr = [plateau.step(v) for v in values][-1]
        assert len(values) == 3
        assert state.optimizer.param_groups[0]["lr"] == lr
        assert lr == pytest.approx(1e-4)


@pytest.fixture(scope="module")
def crack_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cracks"))
    generate_binary(root, n_samples=8, image_size=32)
    return PAEDBinaryDataset(f"{root}/image_png", f"{root}/mask_png",
                             image_size=32, cache=True)


def test_paed_binary_fit_monitors_val_metrics_as_jax(crack_dataset,
                                                     jax_params_binary):
    # PAED_TRAIN_DEFAULTS watch val_IoU (plateau) and val_loss
    # (EarlyStopping). A learning rate of 1e-12 moves no fp32 weight, so
    # both stay flat: the plateau (patience 1) lowers the rate after epoch
    # 2, and EarlyStopping (patience 3) ends the run after epoch 3, in both
    # packages. Under valid_ names neither would act and all 5 epochs
    # would run at 1e-12.
    paed = dict(batch_size=4, accumulate_grad_batches=2, max_epochs=5,
                learning_rate=1e-12, plateau_patience=1,
                early_stopping_patience=3)
    j, t = _configs(1, **NO_DROPOUT)
    jepochs = []
    jtrainer = JaxTrainer(j, dataclasses.replace(jcfg.PAED_TRAIN_DEFAULTS,
                                                 **paed),
                          task="paed_binary", use_mesh=False)
    jtrainer.fit(crack_dataset, val_dataset=crack_dataset,
                 state=jtrainer.state_from_params(jax_params_binary),
                 on_epoch_end=lambda e, m: jepochs.append(m))
    trainer = Trainer(t, dataclasses.replace(tcfg.PAED_TRAIN_DEFAULTS,
                                             **paed),
                      task="paed_binary", device="cpu")
    state = trainer.init_state(jax_params_binary)
    epochs, rates = [], []

    def on_epoch_end(epoch, metrics):
        epochs.append(metrics)
        rates.append(state.optimizer.param_groups[0]["lr"])

    trainer.fit(crack_dataset, val_dataset=crack_dataset, state=state,
                on_epoch_end=on_epoch_end)
    assert len(epochs) == len(jepochs) == 4
    for metrics, jmetrics_ in zip(epochs, jepochs):
        assert set(metrics) == set(jmetrics_)
        assert {"val_loss", "val_IoU", "val_dice"} <= set(metrics)
        assert not any(k.startswith("valid_") for k in metrics)
        for key in ("val_loss", "val_IoU", "train_loss"):
            np.testing.assert_allclose(metrics[key], jmetrics_[key],
                                       rtol=1e-5, err_msg=key)
    # The rate each epoch trained at, and the JAX trainer's, replayed
    # from its val_IoU through its own scheduler.
    plateau = joptim.PlateauScheduler(1e-12, mode="max", patience=1)
    jrates = [1e-12] + [plateau.step(m["val_IoU"]) for m in jepochs][:-1]
    np.testing.assert_allclose(rates, jrates, rtol=1e-12)
    np.testing.assert_allclose(rates, [1e-12, 1e-12, 1e-12, 1e-13],
                               rtol=1e-12)


def test_train_command_on_cpu(tmp_path):
    root = str(tmp_path / "data")
    generate_multiclass(root, n_samples=4, image_size=40)
    rc = cli_main(["train", "--data", root, "--config", "P16H512A8",
                   "--image-size", "32", "--batch-size", "2",
                   "--accumulate", "2", "--max-epochs", "1", "--no-split",
                   "--logs", str(tmp_path / "logs"), "--device", "cpu"])
    assert rc == 0
    fields, rows = _rows(next((tmp_path / "logs").glob(
        "*/version_0/metrics.csv")))
    assert {"train_loss", "valid_loss", "epoch_time_s"} <= set(fields)
    assert np.isfinite(float(rows[-1]["valid_loss"]))


def test_trainer_rejects_what_is_not_ported(tmp_path):
    """The trainer's refusals are the TPU package's shape errors: the
    batch against the accumulation, a mesh larger than the job (one process
    here, as JAX's one CPU device would be), a pipeline for a conv family;
    a checkpoint directory alone starts no job."""
    j, t = _configs()
    cases = [dict(batch_size=6), dict(mesh_shape=(2, 1))]
    for kw in cases:
        with pytest.raises(ValueError) as got:
            Trainer(t, tcfg.TrainConfig(**kw), device="cpu")
        assert "divisible" in str(got.value) or "!= 1 devices" in str(
            got.value), kw
    with pytest.raises(ValueError, match="divisible"):
        JaxTrainer(j, jcfg.TrainConfig(batch_size=6), use_mesh=False)
    with pytest.raises(ValueError, match="pipeline parallelism is "
                                         "implemented for the vitseg"):
        Trainer(t, tcfg.TrainConfig(pipeline_stages=2), model="unet",
                device="cpu")
    trainer = Trainer(t, tcfg.TrainConfig(checkpoint_dir=str(tmp_path)),
                      device="cpu")
    assert trainer.plan is None


def test_train_command_profile_dir_writes_a_trace(tmp_path):
    """``train --profile-dir``: a torch.profiler trace of steps 2-5 beside
    the CSV log and the tfevents file (tests/test_torch_tbevents.py holds
    both against the JAX trainer's)."""
    root = str(tmp_path / "data")
    generate_multiclass(root, n_samples=6, image_size=40)
    rc = cli_main(["train", "--data", root, "--config", "P16H512A8",
                   "--image-size", "32", "--batch-size", "1",
                   "--accumulate", "1", "--max-epochs", "1", "--no-split",
                   "--logs", str(tmp_path / "logs"),
                   "--profile-dir", str(tmp_path / "prof"),
                   "--device", "cpu"])
    assert rc == 0
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {f"train_step_{i}" for i in range(8)} & names == {
        f"train_step_{i}" for i in (2, 3, 4, 5)}
    (events,) = (tmp_path / "logs").glob("*/version_0/events.out.tfevents.*")
    assert events.stat().st_size > 0


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    _, t = _configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(t, tcfg.TrainConfig())
