"""PyTorch port vs the JAX package: training and serving the conv families.

One ``Trainer(model="unet")`` step against the JAX Trainer's step (ce,
Adam, batch 4 as 2 micro-batches of 2) at the ``small`` encoder preset,
32^2; remat with a conv config ignored, as in JAX; the registry, the inits
and ``resolve_model`` for every family (a ``.ckpt`` refused for a conv
family; segformer registered as in JAX); ``ModelRunner`` conv rows (masks
= argmax of the family's apply; an int8 row quantized); train -> save ->
``resolve_model(checkpoint_path=)`` -> the same masks bit for bit; and the
commands ``train --model/--encoder`` and ``register-model --family`` on
the CPU (``device="cpu"``).
"""

import csv
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conv_parity import grads_match_with_near_ties
from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.models import registry as jregistry
from visiontransformer_tpu.models.unet import UNetConfig as JUNetConfig
from visiontransformer_tpu.models.unet import unet_apply as junet_apply
from visiontransformer_tpu.models.unet import unet_init as junet_init
from visiontransformer_tpu.ops import quant as jquant
from visiontransformer_tpu.train import tasks as jtasks
from visiontransformer_tpu.train.trainer import Trainer as JaxTrainer
from visiontransformer_tpu_torch import cli
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.ckpt.convert import (
    conv_params_from_jax,
    load_jax_params,
)
from visiontransformer_tpu_torch.ckpt.io import get_latest_checkpoint
from visiontransformer_tpu_torch.data import CESegmentationDataset
from visiontransformer_tpu_torch.data.synthetic import generate_multiclass
from visiontransformer_tpu_torch.models import registry
from visiontransformer_tpu_torch.models.unet import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ConvSegModel,
    UNetConfig,
)
from visiontransformer_tpu_torch.ops.quant import is_quantized
from visiontransformer_tpu_torch.serve.store import JobStore
from visiontransformer_tpu_torch.serve.worker import ModelRunner
from visiontransformer_tpu_torch.train.trainer import Trainer

CLASSES = 5
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed: int, b: int = 4):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, 32, 32, 3), np.float32),
            "mask": rng.integers(0, CLASSES, (b, 40, 40), dtype=np.int32)}


@pytest.fixture(scope="module")
def jax_step():
    """The JAX unet's params, one JAX Trainer step on them, and the mean
    gradient of the step's two micro-batches."""
    cfg = JUNetConfig(encoder_name="small", num_classes=CLASSES)
    params = jax.tree_util.tree_map(np.array, jax.jit(
        junet_init, static_argnums=1)(jax.random.PRNGKey(0), cfg))
    batch = _batch(7)
    trainer = JaxTrainer(cfg, jcfg.TrainConfig(
        batch_size=4, accumulate_grad_batches=2, learning_rate=LR),
        task="ce", model="unet", use_mesh=False)
    new_state, metrics = trainer.train_step(
        trainer.state_from_params(params), batch, jax.random.PRNGKey(0))
    grad_fn = jax.jit(jax.grad(lambda p, b: jtasks.TASKS["ce"](
        p, b, cfg, rng=None, deterministic=False, apply_fn=junet_apply)[0]))
    grads = [grad_fn(params, {k: jnp.asarray(v[i:i + 2])
                              for k, v in batch.items()}) for i in (0, 2)]
    mean = jax.tree_util.tree_map(lambda a, b: np.asarray((a + b) / 2),
                                  *grads)
    return {"params": params, "batch": batch,
            "loss": float(metrics["loss"]),
            "grads": {k: v.numpy() for k, v in
                      conv_params_from_jax(mean).items()},
            "new": conv_params_from_jax(jax.tree_util.tree_map(
                np.asarray, new_state.params))}


def _port_step(jax_step, train_cfg=None):
    cfg = UNetConfig(encoder_name="small", num_classes=CLASSES)
    trainer = Trainer(cfg, train_cfg or tcfg.TrainConfig(
        batch_size=4, accumulate_grad_batches=2, learning_rate=LR),
        task="ce", model="unet", device="cpu")
    state = trainer.init_state(jax_step["params"])
    state, metrics = trainer.train_step(state, jax_step["batch"], seed=0)
    return trainer, state, float(metrics["loss"])


def test_unet_train_step_matches_jax_trainer(jax_step):
    states = []

    def run():
        _, state, loss = _port_step(jax_step)
        np.testing.assert_allclose(loss, jax_step["loss"], rtol=1e-5)
        states.append(state)
        return {name: p.grad.numpy()
                for name, p in state.model.named_parameters()}

    grads_match_with_near_ties(run, jax_step["grads"])
    state = states[-1]  # the run whose gradients matched
    assert state.step == 1
    for name, p in state.model.named_parameters():
        want = jax_step["grads"][name]
        # Adam's first step is lr·g/(|g| + eps): rounding at near-zero
        # gradients moves by up to lr, elsewhere within lr·1e-2.
        diff = np.abs(p.detach().numpy() - jax_step["new"][name].numpy())
        assert diff.max() <= 2 * LR, name
        big = np.abs(want) > 1e-6
        assert (diff[big] <= LR * 1e-2).all(), name
    # The normalization constants: buffers of the port's model, left as
    # they are; the JAX tree holds them as parameters, which its Adam
    # moves by about lr (ROADMAP.md section 3).
    for key, const in (("norm_mean", IMAGENET_MEAN),
                       ("norm_std", IMAGENET_STD)):
        assert key not in dict(state.model.named_parameters())
        assert torch.equal(getattr(state.model, key), torch.tensor(const))
        moved = np.abs(jax_step["new"][key].numpy() - np.float32(const))
        assert 0 < moved.max() <= 2 * LR


def test_remat_is_ignored_for_a_conv_family(jax_step):
    # The JAX trainer applies remat to vitseg only; the port did read
    # seg_cfg.vit whenever remat was set, which a conv config lacks.
    cfg = UNetConfig(encoder_name="small", num_classes=CLASSES)
    train_cfg = tcfg.TrainConfig(batch_size=4, accumulate_grad_batches=2,
                                 learning_rate=LR, remat=True)
    trainer, with_remat, _ = _port_step(jax_step, train_cfg)
    assert trainer.seg_cfg == cfg
    jcfg_unet = JUNetConfig(encoder_name="small", num_classes=CLASSES)
    assert JaxTrainer(jcfg_unet, jcfg.TrainConfig(remat=True), model="unet",
                      use_mesh=False).seg_cfg == jcfg_unet
    _, plain, _ = _port_step(jax_step)
    for (name, a), (_, b) in zip(with_remat.model.named_parameters(),
                                 plain.model.named_parameters()):
        assert torch.equal(a.grad, b.grad), name
        assert torch.equal(a, b), name


def test_registry_has_every_conv_family():
    # Every family of the JAX package, segformer included, and the port's
    # own served-only sam.
    assert sorted(set(registry.MODEL_FAMILIES) - {"sam"}) == sorted(
        jregistry.MODEL_FAMILIES)
    assert sorted(cli.MODEL_FAMILY_CHOICES) == sorted(registry.MODEL_FAMILIES)
    assert sorted(cli.TRAINED_FAMILY_CHOICES) == sorted(
        jregistry.MODEL_FAMILIES)
    assert sorted(registry.CONV_FAMILIES) == sorted(
        set(registry.MODEL_FAMILIES) - {"vitseg", "segformer", "sam"})
    assert registry.get_model_family("segformer").config_cls.__name__ == \
        "SegformerConfig"
    cfg, model = registry.resolve_model("segformer", "mit_b0", num_classes=3,
                                        device="cpu")
    assert isinstance(model, ConvSegModel) and cfg.is_mit
    with pytest.raises(KeyError):
        registry.get_model_family("nosuchfamily")


@pytest.mark.parametrize("family", registry.CONV_FAMILIES)
def test_resolve_model_returns_the_family(family):
    cfg, model = registry.resolve_model(family, "small", num_classes=3,
                                        compute_dtype="float32",
                                        device="cpu")
    assert isinstance(cfg, registry.get_model_family(family).config_cls)
    assert (cfg.encoder_name, cfg.num_classes) == ("small", 3)
    assert isinstance(model, ConvSegModel) and model.family == family
    assert not model.training
    _, again = registry.resolve_model(family, "small", num_classes=3,
                                      compute_dtype="float32", device="cpu")
    torch.testing.assert_close(again.state_dict(), model.state_dict(),
                               atol=0, rtol=0)
    with torch.no_grad():
        logits = model(torch.rand(1, 32, 32, 3))
    assert logits.shape == (1, 32, 32, 3) and logits.dtype == torch.float32


def test_init_follows_the_jax_distributions():
    model = registry.get_model_family("manet").init(
        torch.Generator().manual_seed(0),
        registry.get_model_family("manet").config_cls(
            encoder_name="resnet18"))
    kernels = [p for n, p in model.named_parameters()
               if n.endswith("kernel")]
    flat = torch.cat([k.detach().flatten() for k in kernels])
    assert float(flat.abs().max()) <= 0.04              # truncated at 2 std
    assert 0.015 < float(flat.std()) < 0.02             # trunc-normal(0.02)
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            assert not p.detach().any(), name
        if name.endswith("scale"):
            assert bool((p.detach() == 1).all()), name
    assert float(model["pab"]["gamma"].detach()) == 0.0
    assert torch.equal(model.norm_mean, torch.tensor(IMAGENET_MEAN))


def test_resolve_model_refuses_a_ckpt_for_a_conv_family(tmp_path):
    path = tmp_path / "model.ckpt"
    path.write_bytes(b"not read")
    with pytest.raises(ValueError, match="vitseg family only"):
        registry.resolve_model("unet", "small", num_classes=3,
                               checkpoint_path=str(path), device="cpu")
    with pytest.raises(FileNotFoundError):
        registry.resolve_model("fpn", "small", num_classes=3,
                               checkpoint_path=str(tmp_path / "missing"),
                               device="cpu")


ROW = {"input_size": 32, "config_name": "small", "num_classes": CLASSES}


@pytest.mark.parametrize("family,dtype", [("fpn", "float32"),
                                          ("manet", "bfloat16")])
def test_runner_serves_a_conv_row(family, dtype):
    row = {**ROW, "model_family": family}
    runner = ModelRunner(row, compute_dtype=dtype, buckets=(1, 4),
                         device="cpu")
    assert runner.cfg.compute_dtype == dtype
    images = np.random.default_rng(3).integers(0, 256, (3, 32, 32, 3),
                                               dtype=np.uint8)
    got = runner.predict(images)
    # The padded bucket's forward, as dispatch runs it.
    padded = np.concatenate([images, np.zeros_like(images[:1])])
    with torch.no_grad():
        want = torch.argmax(runner.model(
            torch.from_numpy(padded).float() / 255.0), dim=-1)[:3]
    assert got.dtype == np.uint8 and got.shape == (3, 32, 32)
    np.testing.assert_array_equal(got, want.numpy())


def test_an_int8_conv_row_raises():
    # The conv half of W8A8 is ported: an int8 conv row no longer raises
    # but quantizes its model (tests/test_torch_conv_quant.py holds the
    # arithmetic against JAX).
    runner = ModelRunner({**ROW, "model_family": "unet", "quantize": "int8"},
                         compute_dtype="float32", device="cpu")
    assert is_quantized(runner.model)
    assert "stages.0.0.conv1.kernel_q" in runner.model.state_dict()
    # A W8A8 tree of the JAX package loads through the bridge too: the
    # model takes the W8A8 form first.
    cfg = JUNetConfig(encoder_name="small", num_classes=CLASSES)
    tree = jax.tree_util.tree_map(np.asarray, jquant.quantize_params_tree(
        junet_init(jax.random.PRNGKey(0), cfg)))
    model = load_jax_params(registry.get_model_family("unet").init(
        torch.Generator().manual_seed(0),
        UNetConfig(encoder_name="small", num_classes=CLASSES)), tree)
    assert is_quantized(model)
    assert model.state_dict()["stages.0.0.conv1.kernel_q"].dtype == \
        torch.int8


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic"))
    generate_multiclass(root, n_samples=8, image_size=40)
    return root, CESegmentationDataset(f"{root}/image_png",
                                       f"{root}/mask_png", image_size=32,
                                       cache=True)


def test_trained_checkpoint_serves_the_same_masks(tmp_path, dataset):
    _, data = dataset
    cfg = UNetConfig(encoder_name="small", num_classes=data.num_classes)
    trainer = Trainer(cfg, tcfg.TrainConfig(
        batch_size=4, accumulate_grad_batches=2, max_epochs=1,
        learning_rate=1e-3), model="unet", device="cpu")
    state = trainer.fit(data, checkpoint_dir=str(tmp_path / "ckpt"))
    assert state.step == 2
    path = get_latest_checkpoint(str(tmp_path / "ckpt"))
    _, restored = registry.resolve_model(
        "unet", "small", num_classes=data.num_classes,
        compute_dtype="float32", checkpoint_path=path, device="cpu")
    torch.testing.assert_close(restored.state_dict(),
                               state.model.state_dict(), atol=0, rtol=0)
    runner = ModelRunner({**ROW, "num_classes": data.num_classes,
                          "model_family": "unet", "checkpoint_path": path},
                         compute_dtype="float32", buckets=(4,),
                         device="cpu")
    images = np.random.default_rng(4).integers(0, 256, (4, 32, 32, 3),
                                               dtype=np.uint8)
    state.model.eval()
    with torch.no_grad():
        want = torch.argmax(state.model(
            torch.from_numpy(images).float() / 255.0), dim=-1)
    np.testing.assert_array_equal(runner.predict(images), want.numpy())


def test_train_command_trains_a_conv_family(tmp_path, dataset):
    root, data = dataset
    rc = cli.main(["train", "--data", root, "--model", "unet", "--encoder",
                   "small", "--image-size", "32", "--batch-size", "4",
                   "--accumulate", "2", "--max-epochs", "1", "--no-split",
                   "--dtype", "float32", "--logs", str(tmp_path / "logs"),
                   "--ckpt-dir", str(tmp_path / "ckpt"), "--device", "cpu"])
    assert rc == 0
    with open(next((tmp_path / "logs").glob("*/version_0/metrics.csv"))) as f:
        rows = list(csv.DictReader(f))
    assert np.isfinite(float(rows[-1]["valid_loss"]))
    _, model = registry.resolve_model(
        "unet", "small", num_classes=data.num_classes,
        compute_dtype="float32",
        checkpoint_path=get_latest_checkpoint(str(tmp_path / "ckpt")),
        device="cpu")
    assert model.cfg.encoder_name == "small"


def test_register_model_command_takes_a_family(tmp_path, capsys):
    db, media = str(tmp_path / "serving.db"), str(tmp_path / "media")
    base = ["register-model", "--db", db, "--media-root", media]
    assert cli.main(base + ["--name", "fpn", "--family", "fpn",
                            "--config", "small"]) == 0
    assert "family=fpn config=small" in capsys.readouterr().out
    rows = JobStore(db, media_root=media).list_models()
    assert [(r["model_family"], r["config_name"]) for r in rows] == [
        ("fpn", "small")]
    # An encoder preset for a conv family, a ViT config for vitseg; int8
    # registers for a conv family, ToMe is refused.
    assert cli.main(base + ["--name", "x", "--family", "fpn",
                            "--config", "P16H768A12"]) == 1
    assert cli.main(base + ["--name", "x", "--config", "resnet34"]) == 1
    assert cli.main(base + ["--name", "q", "--family", "unet", "--config",
                            "small", "--quantize", "int8"]) == 0
    assert cli.main(base + ["--name", "x", "--family", "unet", "--config",
                            "small", "--token-merge-r", "8"]) == 1
    assert len(JobStore(db, media_root=media).list_models()) == 2


def test_training_after_serving_at_the_same_size(jax_step):
    # The resize tables and pooling matrices are cached per shape; made by
    # a serving forward under inference mode they must still serve a
    # training step's backward.
    runner = ModelRunner({**ROW, "model_family": "pspnet"},
                         compute_dtype="float32", buckets=(4,), device="cpu")
    runner.predict(np.zeros((4, 32, 32, 3), np.uint8))
    cfg = registry.get_model_family("pspnet").config_cls(
        encoder_name="small", num_classes=CLASSES)
    trainer = Trainer(cfg, tcfg.TrainConfig(batch_size=4,
                                            accumulate_grad_batches=2),
                      model="pspnet", device="cpu")
    state, metrics = trainer.train_step(trainer.init_state(),
                                        jax_step["batch"], seed=0)
    assert np.isfinite(float(metrics["loss"]))


def test_worker_serves_conv_jobs(tmp_path):
    # A conv row and an int8 conv row through InferenceWorker: each served
    # mask is its row's ModelRunner.predict's.
    from PIL import Image

    from visiontransformer_tpu_torch.serve.worker import InferenceWorker

    store = JobStore(":memory:", media_root=str(tmp_path))
    ok_id = store.register_model("linknet", num_classes=CLASSES,
                                 config_name="small", input_size=32,
                                 model_family="linknet")
    int8_id = store.register_model("int8", num_classes=CLASSES,
                                   config_name="small", input_size=32,
                                   model_family="unet", quantize="int8")
    pixels = np.random.default_rng(6).integers(0, 256, (40, 48, 3),
                                               dtype=np.uint8)
    path = str(tmp_path / "photo.png")
    Image.fromarray(pixels).save(path)
    jobs = [store.create_job(None, model_id, path)["id"]
            for model_id in (ok_id, int8_id)]
    worker = InferenceWorker(store, compute_dtype="float32", buckets=(1,),
                             warmup=False, device="cpu")
    worker.start(preload=False)
    try:
        deadline = time.time() + 120
        while time.time() < deadline and any(
                store.get_job(j)["status"] in ("PENDING", "PROCESSING")
                for j in jobs):
            time.sleep(0.05)
    finally:
        worker.stop()
    image = np.asarray(Image.fromarray(pixels).resize((32, 32),
                                                      Image.BILINEAR))
    for job, model_id in zip(jobs, (ok_id, int8_id)):
        done = store.get_job(job)
        assert done["status"] == "DONE", done
        runner = ModelRunner(store.get_model(model_id),
                             compute_dtype="float32", buckets=(1,),
                             device="cpu")
        np.testing.assert_array_equal(
            np.asarray(Image.open(done["mask_image"])),
            runner.predict(image[None])[0])
