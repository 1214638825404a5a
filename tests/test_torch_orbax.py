"""PyTorch port vs the JAX package: JAX Orbax checkpoints read without JAX.

Every checkpoint here is written by the JAX package's ``save_checkpoint``
(Orbax): a tiny vitseg after one JAX ``Trainer`` step with its Adam state,
a unet on the ``small`` encoder, a segformer on ``mit_b0`` with a small
decode width, a W8A8 vitseg tree and a pipeline-stacked one
(``stack_stage_params``). The port's ``convert_orbax_checkpoint`` reads
each with tensorstore alone and writes a port checkpoint; the model from
it gives the JAX logits at the suite's seg-logit tolerance (fp32: atol
5e-5, argmax equal; tests/test_model_parity.py:97-99), the Adam moments,
step and learning rate are carried exactly, and one resumed step of the
port matches one resumed JAX step at tests/test_torch_train.py's step
tolerances.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.ckpt import io as jio
from visiontransformer_tpu.models import registry as jregistry
from visiontransformer_tpu.models.vitseg import vitseg_apply as jvitseg_apply
from visiontransformer_tpu.models.vitseg import vitseg_init
from visiontransformer_tpu.ops import quant as jquant
from visiontransformer_tpu.parallel.pipeline import stack_stage_params
from visiontransformer_tpu.train.trainer import Trainer as JaxTrainer
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.ckpt import io as tio
from visiontransformer_tpu_torch.ckpt import orbax_read
from visiontransformer_tpu_torch.ckpt.convert import vitseg_params_from_jax
from visiontransformer_tpu_torch.cli import main as cli_main
from visiontransformer_tpu_torch.models import registry as tregistry
from visiontransformer_tpu_torch.ops.quant import is_quantized
from visiontransformer_tpu_torch.serve.worker import ModelRunner
from visiontransformer_tpu_torch.train.trainer import Trainer

VIT = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CLASSES = 5
LR = 1e-4
LOGITS_ATOL = 5e-5  # fp32 seg logits (tests/test_model_parity.py:97-99)
SEG_WIDTH = 32      # segformer's decode width, small for the CPU


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _vit_configs():
    return (jcfg.ViTSegConfig(vit=jcfg.ViTConfig(**VIT), num_classes=CLASSES),
            tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**VIT), num_classes=CLASSES))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((4, 32, 32, 3), np.float32),
            "mask": rng.integers(0, CLASSES, (4, 32, 32)).astype(np.int32)}


def _tiny_vitseg_entry(monkeypatch):
    """``--config tiny`` names the tiny vitseg in the port's registry."""
    entry = tcfg.SweepEntry(0, VIT["patch_size"], VIT["hidden_size"],
                            VIT["num_hidden_layers"],
                            VIT["num_attention_heads"])
    monkeypatch.setattr(tregistry, "sweep_by_name", lambda name: entry)
    monkeypatch.setattr(tcfg.SweepEntry, "vit_config",
                        lambda self, **kw: tcfg.ViTConfig(**VIT))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A JAX Trainer step (Adam, 2 micro-batches, dropout off), saved with
    the JAX save_checkpoint, and the JAX state after one more step."""
    j, _ = _vit_configs()
    trainer = JaxTrainer(j, jcfg.TrainConfig(
        batch_size=4, accumulate_grad_batches=2, learning_rate=LR),
        task="ce", use_mesh=False)
    state = trainer.state_from_params(vitseg_init(jax.random.PRNGKey(0), j))
    state, _ = trainer.train_step(state, _batch(1), jax.random.PRNGKey(0))
    root = str(tmp_path_factory.mktemp("orbax"))
    path = jio.save_checkpoint(root, {"params": state.params,
                                      "opt_state": state.opt_state,
                                      "step": np.asarray(1)},
                               epoch=0, step=1)
    resumed, metrics = trainer.train_step(state, _batch(2),
                                          jax.random.PRNGKey(1))
    return {"path": path, "state": jax.tree_util.tree_map(np.asarray, state),
            "resumed": vitseg_params_from_jax(_np(resumed.params)),
            "resumed_loss": float(metrics["loss"]), "cfg": j}


def _logits_match(model, apply, images):
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    want = np.asarray(apply(jnp.asarray(images)))
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _convert(tmp_path, src, **kw):
    path = orbax_read.convert_orbax_checkpoint(
        src, str(tmp_path / "port"), num_classes=CLASSES, **kw)
    return path, tio.restore_checkpoint(path)


def test_read_orbax_tree_is_the_saved_tree(trained):
    tree = orbax_read.read_orbax_tree(trained["path"])
    assert set(tree) == {"params", "opt_state", "step"}
    assert int(tree["step"]) == 1
    opt = tree["opt_state"]
    # inject_hyperparams(adam): (count, hyperparams, hyperparams_states,
    # inner_state = (ScaleByAdamState, EmptyState)).
    assert opt["hyperparams_states"] == {} and opt["inner_state"][1] is None
    assert set(opt["inner_state"][0]) == {"count", "mu", "nu"}
    for key, value in jax.tree_util.tree_flatten_with_path(
            trained["state"].params)[0]:
        got_leaf = tree["params"]
        for k in key:
            got_leaf = got_leaf[getattr(k, "key", getattr(k, "idx", None))]
        assert got_leaf.dtype == torch.float32
        np.testing.assert_array_equal(got_leaf.numpy(), value)


def test_vitseg_with_adam_state(tmp_path, trained, monkeypatch):
    _tiny_vitseg_entry(monkeypatch)
    path, ckpt = _convert(tmp_path, trained["path"], family="vitseg",
                          config="tiny")
    assert os.path.basename(path) == "epoch=0-step=1" and ckpt["step"] == 1
    j, t = _vit_configs()
    _, model = tregistry.resolve_model(
        "vitseg", "tiny", num_classes=CLASSES, input_size=32,
        compute_dtype="float32", checkpoint_path=path, device="cpu")
    params = trained["state"].params
    images = np.random.default_rng(3).random((2, 32, 32, 3), np.float32)
    _logits_match(model, lambda x: jvitseg_apply(params, x, j,
                                                 attn_impl="xla"), images)

    # The Adam moments, step and learning rate, exactly.
    adam = trained["state"].opt_state.inner_state[0]
    mu, nu = (vitseg_params_from_jax(_np(m)) for m in (adam.mu, adam.nu))
    opt = ckpt["opt_state"]
    (group,) = opt["param_groups"]
    assert np.float32(group["lr"]) == trained["state"].opt_state.hyperparams[
        "learning_rate"]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    names = [n for n, _ in model.named_parameters()]
    assert group["params"] == list(range(len(names)))
    for i, name in enumerate(names):
        state = opt["state"][i]
        assert float(state["step"]) == int(adam.count) == 1
        assert torch.equal(state["exp_avg"], mu[name]), name
        assert torch.equal(state["exp_avg_sq"], nu[name]), name


def test_adamw_state(tmp_path, monkeypatch):
    """The PAED defaults' AdamW: its chain holds two more empty states and
    the injected weight decay."""
    _tiny_vitseg_entry(monkeypatch)
    j, _ = _vit_configs()
    trainer = JaxTrainer(j, jcfg.TrainConfig(
        batch_size=4, accumulate_grad_batches=1, learning_rate=LR,
        optimizer="adamw"), task="ce", use_mesh=False)
    state = trainer.state_from_params(vitseg_init(jax.random.PRNGKey(2), j))
    state, _ = trainer.train_step(state, _batch(3), jax.random.PRNGKey(0))
    src = jio.save_checkpoint(str(tmp_path / "orbax"),
                              {"params": state.params,
                               "opt_state": state.opt_state,
                               "step": np.asarray(1)}, epoch=0, step=1)
    _, ckpt = _convert(tmp_path, src, family="vitseg", config="tiny")
    (group,) = ckpt["opt_state"]["param_groups"]
    assert group["weight_decay"] == 0.01 and group["lr"] == LR
    adam = state.opt_state.inner_state[0]
    mu = vitseg_params_from_jax(_np(adam.mu))
    model = tregistry.get_model_family("vitseg").init(
        torch.Generator(), _vit_configs()[1])
    optimizer = torch.optim.AdamW(model.parameters(), lr=LR)
    optimizer.load_state_dict(ckpt["opt_state"])  # torch takes it
    for i, (name, _) in enumerate(model.named_parameters()):
        assert torch.equal(ckpt["opt_state"]["state"][i]["exp_avg"],
                           mu[name]), name


def test_vitseg_resumed_step_matches_jax(tmp_path, trained, monkeypatch):
    _tiny_vitseg_entry(monkeypatch)
    path, _ = _convert(tmp_path, trained["path"], family="vitseg",
                       config="tiny")
    _, t = _vit_configs()
    trainer = Trainer(t, tcfg.TrainConfig(
        batch_size=4, accumulate_grad_batches=2, learning_rate=LR),
        device="cpu")
    state = trainer.init_state()
    restored = tio.restore_checkpoint(
        path, {"params": state.model.state_dict(),
               "opt_state": state.optimizer, "step": state.step})
    state.step = restored["step"]
    assert state.optimizer.state  # the moments, not a fresh state
    state, metrics = trainer.train_step(state, _batch(2), seed=0)
    np.testing.assert_allclose(float(metrics["loss"]),
                               trained["resumed_loss"], rtol=1e-5)
    for name, p in state.model.named_parameters():
        want = trained["resumed"][name].numpy()
        # tests/test_torch_train.py's step tolerances.
        diff = np.abs(p.detach().numpy() - want)
        assert diff.max() <= 2 * LR, name
        big = np.abs(p.grad.numpy()) > 1e-6
        assert (diff[big] <= LR * 1e-2).all(), name


def test_pipeline_stacked_vitseg(tmp_path, trained, monkeypatch):
    _tiny_vitseg_entry(monkeypatch)
    params = _np(trained["state"].params)
    stacked = {**params, "backbone": {
        **params["backbone"],
        "layers": _np(stack_stage_params(params["backbone"]["layers"]))}}
    src = jio.save_checkpoint(str(tmp_path / "orbax"),
                              {"params": stacked, "step": np.asarray(7)},
                              epoch=3, step=7)
    tree = orbax_read.read_orbax_tree(src)
    assert tree["params"]["backbone"]["layers"]["qkv"]["kernel"].shape == (
        2, 64, 192)
    path, ckpt = _convert(tmp_path, src, family="vitseg", config="tiny")
    assert os.path.basename(path) == "epoch=3-step=7"
    assert "opt_state" not in ckpt
    j, _ = _vit_configs()
    _, model = tregistry.resolve_model(
        "vitseg", "tiny", num_classes=CLASSES, input_size=32,
        compute_dtype="float32", checkpoint_path=path, device="cpu")
    images = np.random.default_rng(4).random((2, 32, 32, 3), np.float32)
    _logits_match(model, lambda x: jvitseg_apply(params, x, j,
                                                 attn_impl="xla"), images)
    # A serving row naming the Orbax directory itself (tensorstore here)
    # serves the converted model's masks.
    row = {"input_size": 32, "config_name": "tiny", "num_classes": CLASSES,
           "checkpoint_path": src}
    pixels = (images * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        ModelRunner(row, compute_dtype="float32", device="cpu").predict(
            pixels),
        ModelRunner({**row, "checkpoint_path": path},
                    compute_dtype="float32", device="cpu").predict(pixels))


def test_w8a8_vitseg(tmp_path, trained, monkeypatch):
    _tiny_vitseg_entry(monkeypatch)
    qtree = _np(jquant.quantize_vitseg_params(trained["state"].params))
    src = jio.save_checkpoint(str(tmp_path / "orbax"), {"params": qtree},
                              epoch=0, step=0)
    tree = orbax_read.read_orbax_tree(src)
    kq = tree["params"]["backbone"]["layers"][0]["qkv"]["kernel_q"]
    assert kq.dtype == torch.int8
    path, _ = _convert(tmp_path, src, family="vitseg", config="tiny")
    j, _ = _vit_configs()
    _, model = tregistry.resolve_model(
        "vitseg", "tiny", num_classes=CLASSES, input_size=32,
        compute_dtype="float32", checkpoint_path=path, device="cpu")
    assert is_quantized(model)
    images = np.random.default_rng(5).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    _logits_match(model, lambda x: jvitseg_apply(qtree, x, j,
                                                 attn_impl="xla"), images)


@pytest.mark.parametrize("family,encoder,extra", [
    ("unet", "small", {}),
    ("segformer", "mit_b0", {"embed_channels": SEG_WIDTH}),
])
def test_conv_and_segformer_families(tmp_path, family, encoder, extra):
    fam = jregistry.get_model_family(family)
    cfg = fam.config_cls(encoder_name=encoder, num_classes=CLASSES, **extra)
    params = _np(jax.jit(fam.init, static_argnums=1)(
        jax.random.PRNGKey(1), cfg))
    src = jio.save_checkpoint(str(tmp_path / "orbax"),
                              {"params": params, "step": np.asarray(0)},
                              epoch=0, step=0)
    path, ckpt = _convert(tmp_path, src, family=family, encoder=encoder)
    images = np.random.default_rng(6).random((2, 32, 32, 3), np.float32)
    apply = jax.jit(lambda x: fam.apply(params, x, cfg))
    # In memory: the decode width is read from the tree.
    tcfg_, model = tregistry.resolve_model(
        family, encoder, num_classes=CLASSES, compute_dtype="float32",
        checkpoint_path=src, device="cpu")
    assert dataclasses.asdict(tcfg_) == dataclasses.asdict(cfg)
    _logits_match(model, apply, images)
    # The converted directory, into the model of the same config.
    model = tregistry.get_model_family(family).init(torch.Generator(), tcfg_)
    model.load_state_dict(ckpt["params"], strict=True)
    _logits_match(model.eval(), apply, images)


def test_bf16_leaves_are_read_through_their_bits(tmp_path):
    x = jnp.asarray(np.random.default_rng(0).standard_normal(7), jnp.bfloat16)
    src = jio.save_checkpoint(str(tmp_path), {"a": {"b": x}, "c": [None]},
                              epoch=0, step=0)
    tree = orbax_read.read_orbax_tree(src)
    got = tree["a"]["b"]
    assert got.dtype == torch.bfloat16 and tree["c"] == [None]
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))


def test_an_unmappable_tree_raises(tmp_path, trained, monkeypatch):
    _tiny_vitseg_entry(monkeypatch)
    with pytest.raises(ValueError, match="head_conv2.bias has shape"):
        orbax_read.convert_orbax_checkpoint(
            trained["path"], str(tmp_path / "port"), family="vitseg",
            config="tiny", num_classes=CLASSES + 1)
    params = _np(trained["state"].params)
    src = jio.save_checkpoint(str(tmp_path / "orbax"), {"params": {
        **params, "extra": {"kernel": np.zeros(3, np.float32)}}},
        epoch=0, step=0)
    with pytest.raises(ValueError, match="extra.kernel"):
        orbax_read.convert_orbax_checkpoint(
            src, str(tmp_path / "port"), family="vitseg", config="tiny",
            num_classes=CLASSES)
    assert not (tmp_path / "port").exists()


def test_without_tensorstore_the_conversion_is_named(tmp_path, trained,
                                                     monkeypatch):
    _tiny_vitseg_entry(monkeypatch)
    monkeypatch.setitem(__import__("sys").modules, "tensorstore", None)
    with pytest.raises(ImportError, match="convert-orbax"):
        tregistry.resolve_model("vitseg", "tiny", num_classes=CLASSES,
                                input_size=32, checkpoint_path=trained["path"],
                                device="cpu")


def test_convert_orbax_command(tmp_path, trained, monkeypatch, capsys):
    _tiny_vitseg_entry(monkeypatch)
    root = os.path.dirname(trained["path"])
    assert cli_main(["convert-orbax", "--src", root, "--out",
                     str(tmp_path / "out"), "--config", "tiny",
                     "--num-classes", str(CLASSES)]) == 0
    assert capsys.readouterr().out.strip() == str(
        tmp_path / "out" / "epoch=0-step=1")
    restored = tio.restore_checkpoint(str(tmp_path / "out" / "epoch=0-step=1"))
    assert set(restored) == {"params", "opt_state", "step"}
