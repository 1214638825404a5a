"""PyTorch port vs the JAX package: checkpoints and the Lightning bridge.

The port's ``ckpt/torch_convert.py`` is held against the JAX package's on
the reference network (HF ``ViTModel`` + the conv head, random weights from
a config, no download; tests/test_model_parity.py), its ``ckpt/io.py``
against the JAX naming functions and the partial-restore cases of
tests/test_resume_optstate.py, and the ``.ckpt`` files each package writes
are read by the other. Resume, the registry, the serving runner and the
checkpoint commands run on the CPU because the tests ask for it
(``device="cpu"``).
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_model_parity import CFG, _TorchViTSeg, _hf_backbone
from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.ckpt import io as jio
from visiontransformer_tpu.ckpt import torch_convert as jconvert
from visiontransformer_tpu.models.vitseg import (
    vitseg_apply as jax_vitseg_apply,
    vitseg_init,
    vitseg_logits_nchw as jax_logits_nchw,
)
import visiontransformer_tpu_torch.configs as port_configs
import visiontransformer_tpu_torch.models.registry as port_registry
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.ckpt import io as tio
from visiontransformer_tpu_torch.ckpt import torch_convert as tconvert
from visiontransformer_tpu_torch.ckpt.convert import vitseg_params_from_jax
from visiontransformer_tpu_torch.cli import main as cli_main
from visiontransformer_tpu_torch.data import CESegmentationDataset
from visiontransformer_tpu_torch.data.synthetic import generate_multiclass
from visiontransformer_tpu_torch.models.registry import (
    init_vitseg_,
    resolve_model,
)
from visiontransformer_tpu_torch.models.vit import vit_apply
from visiontransformer_tpu_torch.models.vitseg import (
    ViTSeg,
    vitseg_logits_nchw,
    vitseg_predict,
)
from visiontransformer_tpu_torch.serve.store import JobStore
from visiontransformer_tpu_torch.serve.worker import ModelRunner
from visiontransformer_tpu_torch.train.trainer import Trainer

CLASSES = 5
# A sweep-shaped row small enough for the CPU: patch 8, hidden 64, 2
# layers, 4 heads (intermediate 3072, as every sweep row has).
TINY_ENTRY = (0, 8, 64, 2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(classes=CLASSES):
    vit = {f: getattr(CFG, f) for f in (
        "image_size", "patch_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size")}
    return (jcfg.ViTSegConfig(vit=jcfg.ViTConfig(**vit), num_classes=classes),
            tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**vit), num_classes=classes))


@pytest.fixture(scope="module")
def reference():
    """The reference network with random weights, and its state dict with
    Lightning's ``model.`` prefixes."""
    net = _TorchViTSeg(_hf_backbone(), CLASSES).eval()
    return net, {"model." + k: v for k, v in net.state_dict().items()}


def _port_model(state, cfg):
    model = ViTSeg(cfg)
    model.load_state_dict(state, strict=True)
    return model.eval()


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------- HF bridge
def test_convert_vitseg_state_matches_jax(reference):
    _, state = reference
    j, t = _cfgs()
    want = vitseg_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jconvert.convert_vitseg_state(state, j)))
    _assert_state_equal(tconvert.convert_vitseg_state(state, t), want)
    backbone = {k[len("model.backbone."):]: v for k, v in state.items()
                if k.startswith("model.backbone.")}
    want = vitseg_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jconvert.convert_hf_vit_state(backbone, j.vit)))
    _assert_state_equal(tconvert.convert_hf_vit_state(backbone, t.vit), want)


def test_backbone_matches_hf(rng):
    hf = _hf_backbone().eval()
    _, t = _cfgs()
    model = ViTSeg(t)
    model.backbone.load_state_dict(
        tconvert.convert_hf_vit_state(hf.state_dict(), t.vit), strict=True)
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(x)).last_hidden_state
        got = vit_apply(model.backbone,
                        torch.from_numpy(x.transpose(0, 2, 3, 1)),
                        attn_impl="eager")
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def test_full_model_matches_reference_network(rng, reference):
    net, state = reference
    _, t = _cfgs()
    model = _port_model(tconvert.convert_vitseg_state(state, t), t)
    x = torch.from_numpy(
        rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        want = net(x)
        got = vitseg_logits_nchw(model, x, attn_impl="eager")
    torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-4)
    assert torch.equal(got.argmax(1), want.argmax(1))


def test_vitseg_logits_nchw_matches_jax(rng, reference):
    _, state = reference
    j, t = _cfgs()
    model = _port_model(tconvert.convert_vitseg_state(state, t), t)
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jax_logits_nchw(jconvert.convert_vitseg_state(state, j),
                                      jnp.asarray(x), j, attn_impl="xla"))
    with torch.no_grad():
        got = vitseg_logits_nchw(model, torch.from_numpy(x),
                                 attn_impl="eager").numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


def test_export_vitseg_state_matches_jax(reference):
    net, state = reference
    j, t = _cfgs()
    port_state = tconvert.convert_vitseg_state(state, t)
    got = tconvert.export_vitseg_state(port_state, t)
    want = jconvert.export_vitseg_state(
        jconvert.convert_vitseg_state(state, j), j)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    back = _TorchViTSeg(_hf_backbone(), CLASSES)
    back.load_state_dict(
        {k[len("model."):]: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in got.items()}, strict=True)
    for k, v in net.state_dict().items():
        if "pooler" not in k:
            assert torch.equal(back.state_dict()[k], v), k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lightning_ckpt_crosses_packages(tmp_path, reference, writer):
    _, state = reference
    j, t = _cfgs()
    path = str(tmp_path / "epoch=3-step=100.ckpt")
    port_state = tconvert.convert_vitseg_state(state, t)
    if writer == "jax":
        jconvert.save_lightning_checkpoint(
            path, jconvert.convert_vitseg_state(state, j), j, epoch=3,
            global_step=100)
        _assert_state_equal(tconvert.load_lightning_checkpoint(path, t),
                            port_state)
    else:
        tconvert.save_lightning_checkpoint(path, port_state, t, epoch=3,
                                           global_step=100)
        got = vitseg_params_from_jax(jax.tree_util.tree_map(
            np.asarray, jconvert.load_lightning_checkpoint(path, j)))
        _assert_state_equal(got, port_state)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    assert (ckpt["epoch"], ckpt["global_step"]) == (3, 100)


@pytest.fixture
def tiny_sweep(monkeypatch):
    """Both packages' sweep lookups answer every name with TINY_ENTRY."""
    import visiontransformer_tpu.configs as jax_configs

    monkeypatch.setattr(jax_configs, "sweep_by_name",
                        lambda name: jcfg.SweepEntry(*TINY_ENTRY))
    for module in (port_configs, port_registry):
        monkeypatch.setattr(module, "sweep_by_name",
                            lambda name: tcfg.SweepEntry(*TINY_ENTRY))


def test_jax_orbax_checkpoint_reaches_the_port(tmp_path, rng, tiny_sweep):
    """JAX ``export`` turns an Orbax checkpoint into a .ckpt; the port's
    resolve_model serves it."""
    from visiontransformer_tpu.cli import main as jax_cli

    jseg = jcfg.SweepEntry(*TINY_ENTRY).seg_config(num_classes=CLASSES)
    jseg = dataclasses.replace(
        jseg, vit=dataclasses.replace(jseg.vit, image_size=32))
    params = vitseg_init(jax.random.PRNGKey(3), jseg)
    jio.save_checkpoint(str(tmp_path / "orbax"),
                        {"params": params, "step": np.asarray(5)},
                        epoch=2, step=5)
    out = str(tmp_path / "exported.ckpt")
    assert jax_cli(["export", "--ckpt", str(tmp_path / "orbax"),
                    "--config", "tiny", "--num-classes", str(CLASSES),
                    "--out", out]) == 0
    _, model = resolve_model("vitseg", "tiny", num_classes=CLASSES,
                             input_size=32, compute_dtype="float32",
                             checkpoint_path=out, device="cpu")
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_vitseg_apply(params, jnp.asarray(x), jseg,
                                       attn_impl="xla"))
    with torch.no_grad():
        got = model(torch.from_numpy(x), attn_impl="eager").numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


# ------------------------------------------------------------------ ckpt/io
def _stepped(cfg, lr=1e-2):
    """A model and an Adam optimizer after one step (non-zero moments)."""
    model = init_vitseg_(ViTSeg(cfg), torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    model(x).square().mean().backward()
    opt.step()
    return model, opt


def test_save_restore_round_trip(tmp_path):
    _, t = _cfgs()
    model, opt = _stepped(t)
    tree = {"params": model.state_dict(), "opt_state": opt.state_dict(),
            "step": 7}
    path = tio.save_checkpoint(str(tmp_path), tree, epoch=2, step=7)
    assert path == os.path.join(str(tmp_path), "epoch=2-step=7")
    raw = tio.restore_checkpoint(path)
    _assert_state_equal(raw["params"], model.state_dict())
    assert raw["step"] == 7
    assert raw["opt_state"]["param_groups"] == opt.state_dict()["param_groups"]
    for index, moments in opt.state_dict()["state"].items():
        for key, value in moments.items():
            assert torch.equal(raw["opt_state"]["state"][index][key], value)

    fresh = ViTSeg(t)
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-2)
    target = {"params": fresh.state_dict(), "opt_state": fresh_opt,
              "step": 0}
    restored = tio.restore_checkpoint(path, target)
    assert restored["params"] is target["params"]    # written in place
    assert restored["opt_state"] is fresh_opt
    _assert_state_equal(fresh.state_dict(), model.state_dict())
    for p, q in zip(fresh.parameters(), model.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(fresh_opt.state[p][key], opt.state[q][key])
    assert restored["step"] == 7


NAMES = [["epoch=1-step=10", "epoch=12-step=120", "epoch=3-step=30"],
         ["epoch=0-step=5", "notes.txt", "epoch=x-step=1", "last"],
         ["epoch=2-step=1", "epoch=2-step=9"],
         ["junk"], []]


@pytest.mark.parametrize("names", NAMES)
def test_latest_checkpoint_and_epoch_match_jax(tmp_path, names):
    for name in names:
        os.makedirs(tmp_path / name)
    assert (tio.get_latest_checkpoint(str(tmp_path))
            == jio.get_latest_checkpoint(str(tmp_path)))
    for name in names + ["/a/b/epoch=7-step=3.ckpt", "epoch=7", "x"]:
        assert tio.parse_epoch(name) == jio.parse_epoch(name)


def test_latest_checkpoint_of_a_missing_directory(tmp_path):
    missing = str(tmp_path / "missing")
    assert tio.get_latest_checkpoint(missing) is None
    assert jio.get_latest_checkpoint(missing) is None


def test_full_checkpoint_onto_params_only_target(tmp_path):
    _, t = _cfgs()
    model, opt = _stepped(t)
    path = tio.save_checkpoint(
        str(tmp_path), {"params": model.state_dict(),
                        "opt_state": opt.state_dict(), "step": 1},
        epoch=0, step=1)
    fresh = ViTSeg(t)
    restored = tio.restore_checkpoint(path, {"params": fresh.state_dict(),
                                             "step": 0})
    assert sorted(restored) == ["params", "step"] and restored["step"] == 1
    _assert_state_equal(fresh.state_dict(), model.state_dict())
    with pytest.raises(ValueError, match="keys"):
        tio.restore_checkpoint(path, {"params": fresh.state_dict()},
                               partial=False)


def test_shape_mismatch_raises(tmp_path):
    _, t = _cfgs()
    _, other = _cfgs(classes=CLASSES + 1)
    path = tio.save_checkpoint(
        str(tmp_path), {"params": ViTSeg(other).state_dict()}, epoch=0,
        step=0)
    with pytest.raises(ValueError, match="different model configuration"):
        tio.restore_checkpoint(path, {"params": ViTSeg(t).state_dict()})


def test_optimizer_mismatch_warns_and_keeps_fresh_state(tmp_path):
    _, t = _cfgs()
    model, opt = _stepped(t)
    path = tio.save_checkpoint(
        str(tmp_path), {"params": model.state_dict(),
                        "opt_state": opt.state_dict()}, epoch=0, step=1)
    other = torch.optim.AdamW(model.parameters(), lr=1e-2)
    with pytest.warns(UserWarning, match="freshly-initialized"):
        restored = tio.restore_checkpoint(
            path, {"params": model.state_dict(), "opt_state": other})
    assert restored["opt_state"] is other and not other.state


def test_restore_refuses_what_it_cannot_read(tmp_path):
    _, t = _cfgs()
    path = tio.save_checkpoint(str(tmp_path / "list"), [torch.zeros(2)],
                               epoch=0, step=0)
    with pytest.raises(ValueError, match="dict-rooted"):
        tio.restore_checkpoint(path, {"params": ViTSeg(t).state_dict()})
    # A stacked (pipeline) checkpoint is unstacked onto a per-layer target
    # (tests/test_torch_parallel_ckpt.py); one missing leaves still fails.
    stacked = {"backbone.layers.qkv.kernel": torch.zeros(2, 64, 192)}
    path = tio.save_checkpoint(str(tmp_path / "stacked"),
                               {"params": stacked}, epoch=0, step=0)
    with pytest.raises(ValueError, match="different model configuration"):
        tio.restore_checkpoint(path, {"params": ViTSeg(t).state_dict()})
    with pytest.raises(FileNotFoundError):
        tio.restore_checkpoint(str(tmp_path))
    # The port's own format reads with weights_only=True: a pickled object
    # that is not plain data is refused.
    path = tmp_path / "epoch=0-step=0"
    path.mkdir()
    torch.save({"params": _NotData()}, path / "checkpoint.pt")
    with pytest.raises(pickle.UnpicklingError):
        tio.restore_checkpoint(str(path))


class _NotData:
    pass


# ------------------------------------------------------------------ Trainer
@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic"))
    generate_multiclass(root, n_samples=8, image_size=40)
    return CESegmentationDataset(f"{root}/image_png", f"{root}/mask_png",
                                 image_size=32, cache=True)


def _trainer(dataset, **overrides):
    _, t = _cfgs(dataset.num_classes)
    cfg = tcfg.TrainConfig(batch_size=4, accumulate_grad_batches=2,
                           learning_rate=1e-3, early_stopping_monitor=None,
                           **overrides)
    return Trainer(t, cfg, device="cpu")


def _optimizer_tensors(optimizer):
    state = optimizer.state_dict()
    return state["param_groups"], {
        (i, k): v for i, s in state["state"].items() for k, v in s.items()}


def test_resume_restores_step_and_adam_moments(tmp_path, dataset):
    ckpt_dir = str(tmp_path / "ckpts")
    state = _trainer(dataset).fit(dataset, max_epochs=1,
                                  checkpoint_dir=ckpt_dir)
    assert os.listdir(ckpt_dir) == [f"epoch=0-step={state.step}"]
    resumed = _trainer(dataset).fit(dataset, resume_from=ckpt_dir,
                                    max_epochs=1)
    assert resumed.step == state.step == 2
    _assert_state_equal(resumed.model.state_dict(), state.model.state_dict())
    groups, saved = _optimizer_tensors(state.optimizer)
    got_groups, got = _optimizer_tensors(resumed.optimizer)
    assert got_groups == groups and sorted(got) == sorted(saved)
    for key, value in saved.items():
        assert torch.equal(got[key], value), key
    assert sum(bool(v.abs().sum()) for (_, k), v in saved.items()
               if k.startswith("exp_avg")) > 2


def test_resume_continues_an_uninterrupted_run(tmp_path, dataset):
    """1 epoch, then 1 resumed epoch, equals 2 epochs bit for bit: the
    dropout seeds follow the restored step, the shuffle the epoch."""
    whole = _trainer(dataset).fit(dataset, max_epochs=2)
    ckpt_dir = str(tmp_path / "ckpts")
    _trainer(dataset).fit(dataset, max_epochs=1, checkpoint_dir=ckpt_dir)
    resumed = _trainer(dataset).fit(dataset, max_epochs=2,
                                    resume_from=ckpt_dir,
                                    checkpoint_dir=ckpt_dir)
    assert resumed.step == whole.step == 4
    assert sorted(os.listdir(ckpt_dir)) == ["epoch=0-step=2",
                                            "epoch=1-step=4"]
    _assert_state_equal(resumed.model.state_dict(), whole.model.state_dict())
    groups, want = _optimizer_tensors(whole.optimizer)
    got_groups, got = _optimizer_tensors(resumed.optimizer)
    assert got_groups == groups
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def test_resume_from_params_only_checkpoint_keeps_fresh_moments(tmp_path,
                                                                 dataset):
    trainer = _trainer(dataset)
    state = trainer.init_state()
    tio.save_checkpoint(str(tmp_path), {"params": state.model.state_dict(),
                                        "step": 7}, epoch=3, step=7)
    resumed = _trainer(dataset).fit(dataset, resume_from=str(tmp_path),
                                    max_epochs=4)
    assert resumed.step == 7    # epoch 3 was the checkpoint's: nothing ran
    assert resumed.optimizer.state_dict()["state"] == {}
    _assert_state_equal(resumed.model.state_dict(), state.model.state_dict())


def test_plateau_learning_rate_travels_with_the_checkpoint(tmp_path,
                                                           dataset):
    ckpt_dir = str(tmp_path / "ckpts")
    state = _trainer(dataset).fit(dataset, max_epochs=1,
                                  checkpoint_dir=ckpt_dir)
    path = tio.get_latest_checkpoint(ckpt_dir)
    tree = tio.restore_checkpoint(path)
    tree["opt_state"]["param_groups"][0]["lr"] = 1e-4   # a lowered LR
    tio.save_checkpoint(ckpt_dir, tree, epoch=0, step=state.step)
    resumed = _trainer(dataset).fit(dataset, resume_from=ckpt_dir,
                                    max_epochs=1)
    assert resumed.optimizer.param_groups[0]["lr"] == 1e-4


def test_resumed_plateau_schedule_starts_afresh(tmp_path, dataset):
    """The schedule's own state is not in the checkpoint (the JAX trainer
    keeps none either): the resumed epoch trains at the restored, lowered
    learning rate, and at its end a fresh PlateauScheduler, whose first
    reading is its best, sets the configured rate again."""
    ckpt_dir = str(tmp_path / "ckpts")
    plateau = dict(plateau_patience=1, plateau_monitor="valid_loss",
                   plateau_mode="min")
    state = _trainer(dataset, **plateau).fit(dataset, max_epochs=1,
                                             checkpoint_dir=ckpt_dir)
    tree = tio.restore_checkpoint(tio.get_latest_checkpoint(ckpt_dir))
    tree["opt_state"]["param_groups"][0]["lr"] = 1e-4   # a lowered LR
    tio.save_checkpoint(ckpt_dir, tree, epoch=0, step=state.step)
    resumed = _trainer(dataset, **plateau).fit(
        dataset, dataset, resume_from=ckpt_dir, max_epochs=2,
        checkpoint_dir=ckpt_dir)
    saved = tio.restore_checkpoint(tio.get_latest_checkpoint(ckpt_dir))
    assert os.path.basename(tio.get_latest_checkpoint(ckpt_dir)) == (
        f"epoch=1-step={resumed.step}")
    assert saved["opt_state"]["param_groups"][0]["lr"] == 1e-4
    assert resumed.optimizer.param_groups[0]["lr"] == 1e-3


# --------------------------------------------------------- registry, worker
def _trained_checkpoint(tmp_path, kind, cfg):
    """A "trained" model (cls token 0.5) saved as a port checkpoint
    directory or as a reference .ckpt file."""
    model = init_vitseg_(ViTSeg(cfg), torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.backbone.cls_token.fill_(0.5)
    if kind == "dir":
        return model, tio.save_checkpoint(
            str(tmp_path / "ckpts"), {"params": model.state_dict(),
                                      "step": 7}, epoch=1, step=7)
    path = str(tmp_path / "trained.ckpt")
    tconvert.save_lightning_checkpoint(path, model.state_dict(), cfg)
    return model, path


@pytest.mark.parametrize("kind", ["dir", "ckpt"])
def test_resolve_model_loads_trained_weights(tmp_path, tiny_sweep, kind):
    cfg = port_registry.vitseg_config("tiny", num_classes=3, input_size=32,
                                      compute_dtype="float32")
    trained, path = _trained_checkpoint(tmp_path, kind, cfg)
    _, model = resolve_model("vitseg", "tiny", num_classes=3, input_size=32,
                             compute_dtype="float32", checkpoint_path=path,
                             device="cpu")
    assert bool((model.backbone.cls_token == 0.5).all())
    _assert_state_equal(model.state_dict(), trained.state_dict())


@pytest.mark.parametrize("kind,error", [
    ("missing", FileNotFoundError), ("missing.ckpt", FileNotFoundError),
    ("file", ValueError), ("empty_dir", FileNotFoundError)])
def test_resolve_model_refuses_a_path_it_cannot_load(tmp_path, kind, error):
    path = tmp_path / kind
    if kind == "file":
        path.write_text("not a checkpoint")
    elif kind == "empty_dir":
        path.mkdir()
    with pytest.raises(error):
        resolve_model("vitseg", "P16H512A8", num_classes=3, input_size=32,
                      checkpoint_path=str(path), device="cpu")


@pytest.mark.parametrize("kind", ["dir", "ckpt"])
def test_worker_serves_trained_checkpoint(tmp_path, tiny_sweep, rng, kind):
    cfg = port_registry.vitseg_config("tiny", num_classes=3, input_size=32,
                                      compute_dtype="float32")
    trained, path = _trained_checkpoint(tmp_path, kind, cfg)
    store = JobStore(":memory:", media_root=str(tmp_path / "media"))
    store.register_model("trained", num_classes=3, config_name="tiny",
                         input_size=32, checkpoint_path=path)
    runner = ModelRunner(store.get_model(1), compute_dtype="float32",
                         device="cpu")
    assert bool((runner.model.backbone.cls_token == 0.5).all())
    images = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    with torch.no_grad():
        want = vitseg_predict(trained.eval(),
                              torch.from_numpy(images).float() / 255.0,
                              mask_dtype=torch.uint8).numpy()
    np.testing.assert_array_equal(runner.predict(images), want)


# ---------------------------------------------------------------------- CLI
def test_train_command_saves_and_resumes(tmp_path, tiny_sweep):
    root = str(tmp_path / "data")
    generate_multiclass(root, n_samples=4, image_size=40)
    ckpt_dir = str(tmp_path / "ckpts")
    base = ["train", "--data", root, "--config", "tiny", "--image-size",
            "32", "--batch-size", "2", "--accumulate", "2", "--no-split",
            "--logs", str(tmp_path / "logs"), "--device", "cpu",
            "--ckpt-dir", ckpt_dir]
    assert cli_main(base + ["--max-epochs", "1"]) == 0
    assert os.listdir(ckpt_dir) == ["epoch=0-step=2"]
    assert cli_main(base + ["--max-epochs", "2", "--resume", ckpt_dir]) == 0
    assert sorted(os.listdir(ckpt_dir)) == ["epoch=0-step=2",
                                            "epoch=1-step=4"]
    assert tio.restore_checkpoint(os.path.join(
        ckpt_dir, "epoch=1-step=4"))["step"] == 4
    # Without --ckpt-dir the checkpoints go beside the run's CSV log.
    logs = str(tmp_path / "logs2")
    assert cli_main(base[:-2] + ["--max-epochs", "1", "--logs", logs]) == 0
    assert os.listdir(os.path.join(
        logs, "vit-model", "version_0", "checkpoints")) == ["epoch=0-step=2"]


def test_convert_and_export_commands_round_trip(tmp_path, tiny_sweep):
    """convert: reference .ckpt -> port checkpoint; export: back to a
    .ckpt that the JAX package's loader reads to the same weights."""
    cfg = tcfg.SweepEntry(*TINY_ENTRY).seg_config(num_classes=CLASSES)
    model = init_vitseg_(ViTSeg(cfg), torch.Generator().manual_seed(2))
    ref = str(tmp_path / "ref.ckpt")
    tconvert.save_lightning_checkpoint(ref, model.state_dict(), cfg)
    out_dir = str(tmp_path / "port")
    assert cli_main(["convert", "--ckpt", ref, "--config", "tiny",
                     "--num-classes", str(CLASSES), "--out", out_dir,
                     "--epoch", "3", "--step", "100"]) == 0
    tree = tio.restore_checkpoint(os.path.join(out_dir, "epoch=3-step=100"))
    assert tree["step"] == 100
    _assert_state_equal(tree["params"], model.state_dict())

    out = str(tmp_path / "exported.ckpt")
    assert cli_main(["export", "--ckpt", out_dir, "--config", "tiny",
                     "--num-classes", str(CLASSES), "--out", out]) == 0
    ckpt = torch.load(out, map_location="cpu", weights_only=False)
    assert (ckpt["epoch"], ckpt["global_step"]) == (3, 100)
    assert "model.backbone.encoder.layer.0.attention.attention.query.weight" \
        in ckpt["state_dict"]
    assert ckpt["state_dict"]["model.seg_head.2.weight"].shape[0] == CLASSES
    jseg = jcfg.SweepEntry(*TINY_ENTRY).seg_config(num_classes=CLASSES)
    got = vitseg_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jconvert.load_lightning_checkpoint(out, jseg)))
    _assert_state_equal(got, model.state_dict())


def test_register_model_command(tmp_path):
    _, path = _trained_checkpoint(tmp_path, "dir", _cfgs(classes=3)[1])
    db, media = str(tmp_path / "serving.db"), str(tmp_path / "media")
    base = ["register-model", "--db", db, "--media-root", media,
            "--num-classes", "3", "--input-size", "32"]
    assert cli_main(base + ["--name", "ok", "--config", "P16H768A12",
                            "--ckpt", path]) == 0
    assert cli_main(base + ["--name", "preset", "--config", "vit_b_16"]) == 0
    assert cli_main(base + ["--name", "tome-int8", "--config", "P16H768A12",
                            "--token-merge-r", "8", "--quantize", "int8",
                            "--ckpt", path]) == 0
    for bad in (["--name", "unknown", "--config", "nope"],
                ["--name", "missing", "--config", "P16H768A12", "--ckpt",
                 str(tmp_path / "missing")]):
        assert cli_main(base + bad) == 1, bad
    rows = JobStore(db, media_root=media).list_models()
    assert [(r["name"], r["checkpoint_path"], r["token_merge_r"],
             r["quantize"]) for r in rows] == [
        ("ok", path, 0, ""), ("preset", "", 0, ""),
        ("tome-int8", path, 8, "int8")]
