"""PyTorch port vs the JAX package: the segformer family
(models/segformer.py on models/mit.py or the shared conv encoder), and
pretrained HF SegFormer directories (ckpt/hf_dir.py).

At a narrow decode width (32), 5 classes, fp32: logits against the JAX
``segformer_apply`` at atol 5e-5 with the argmax equal, for mit_b0 and the
``small`` conv encoder, with both ``head_norm`` forms, at 64^2 and at 37x53
(the odd, non-square size, where a transposed token order or the wrong
padding would show); the CE gradients at 5e-5 / 5e-4; one
``Trainer(model="segformer")`` step against the JAX Trainer's; the bf16
argmax agreement with JAX's bf16, measured and recorded. An HF
``SegformerForSemanticSegmentation`` with random weights and a small
config, saved by ``save_pretrained`` as ``model.safetensors`` and as
``pytorch_model.bin``, loads through the port's ``resolve_model`` (no
``transformers`` in the port) to the masks of the JAX ``resolve_model``
and to the live HF module's logits. The JAX reference of each case is
built once per module.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conv_parity import grads_match_with_near_ties
from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.losses.basic import cross_entropy_loss as jce
from visiontransformer_tpu.models import registry as jregistry
from visiontransformer_tpu.models import segformer as jseg
from visiontransformer_tpu.train import tasks as jtasks
from visiontransformer_tpu.train.trainer import Trainer as JaxTrainer
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.ckpt import hf_dir
from visiontransformer_tpu_torch.ckpt.convert import (
    conv_params_from_jax,
    load_jax_params,
)
from visiontransformer_tpu_torch.ckpt.torch_convert import (
    convert_hf_segformer_seg_state,
)
from visiontransformer_tpu_torch.losses.basic import cross_entropy_loss
from visiontransformer_tpu_torch.models import registry
from visiontransformer_tpu_torch.models.segformer import SegformerConfig
from visiontransformer_tpu_torch.models.unet import ConvSegModel
from visiontransformer_tpu_torch.serve.worker import ModelRunner
from visiontransformer_tpu_torch.train.trainer import Trainer

CLASSES = 5
EMBED = 32
LOGITS_ATOL = 5e-5
GRAD_ATOL, GRAD_RTOL = 5e-5, 5e-4
LR = 1e-4
SIZES = [(64, 64), (37, 53)]
ENCODERS = ["mit_b0", "small"]
# bf16 argmax agreement of the port's masks with JAX's bf16 masks (random
# weights: many near-ties); measured 0.9967 (mit_b0) and 0.9944 (small)
# on this input.
BF16_AGREEMENT_FLOOR = 0.98


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(encoder, head_norm="gn", dtype="float32"):
    return jseg.SegformerConfig(encoder_name=encoder, num_classes=CLASSES,
                                embed_channels=EMBED, head_norm=head_norm,
                                compute_dtype=dtype)


def _tcfg(encoder, head_norm="gn", dtype="float32"):
    return SegformerConfig(encoder_name=encoder, num_classes=CLASSES,
                           embed_channels=EMBED, head_norm=head_norm,
                           compute_dtype=dtype)


class Reference:
    """(encoder, head_norm, size) -> the JAX params (numpy leaves; the
    affine head drawn away from the identity), images and fp32 logits."""

    def __init__(self):
        self._cases, self._params = {}, {}

    def params(self, encoder, head_norm):
        key = (encoder, head_norm)
        if key not in self._params:
            p = jax.tree_util.tree_map(np.array, jax.jit(
                jseg.segformer_init, static_argnums=1)(
                    jax.random.PRNGKey(0), _jcfg(encoder, head_norm)))
            if head_norm == "affine":
                rng = np.random.default_rng(1)
                p["fuse"]["affine"] = {
                    "scale": rng.uniform(0.5, 1.5, EMBED).astype(np.float32),
                    "bias": rng.uniform(-0.1, 0.1, EMBED).astype(np.float32)}
            self._params[key] = p
        return self._params[key]

    def __call__(self, encoder, head_norm, size):
        key = (encoder, head_norm, size)
        if key not in self._cases:
            cfg = _jcfg(encoder, head_norm)
            params = self.params(encoder, head_norm)
            images = np.random.default_rng(sum(size)).random(
                (2,) + size + (3,), np.float32)
            logits = jax.jit(lambda p, x: jseg.segformer_apply(p, x, cfg))(
                params, jnp.asarray(images))
            self._cases[key] = {"params": params, "images": images,
                                "logits": np.asarray(logits)}
        return self._cases[key]


@pytest.fixture(scope="module")
def reference():
    return Reference()


def _port(encoder, head_norm, params, dtype="float32"):
    model = registry.get_model_family("segformer").init(
        torch.Generator().manual_seed(0), _tcfg(encoder, head_norm, dtype))
    return load_jax_params(model, params).eval()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("head_norm", ["gn", "affine"])
@pytest.mark.parametrize("encoder", ENCODERS)
def test_logits_match_jax(reference, encoder, head_norm, size):
    case = reference(encoder, head_norm, size)
    with torch.no_grad():
        got = _port(encoder, head_norm, case["params"])(
            torch.from_numpy(case["images"])).numpy()
    want = case["logits"]
    assert got.shape == want.shape == (2,) + size + (CLASSES,)
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("encoder", ENCODERS)
def test_ce_gradients_match_jax(reference, encoder):
    case = reference(encoder, "gn", (37, 53))
    cfg = _jcfg(encoder)
    target = np.random.default_rng(4).integers(
        0, CLASSES, (2, 37, 53)).astype(np.int32)
    grads = jax.jit(jax.grad(lambda p: jce(jseg.segformer_apply(
        p, jnp.asarray(case["images"]), cfg), jnp.asarray(target))))(
            case["params"])
    want = {k: v.numpy() for k, v in conv_params_from_jax(
        jax.tree_util.tree_map(np.asarray, grads)).items()}

    def run():
        model = _port(encoder, "gn", case["params"])
        loss = cross_entropy_loss(model(torch.from_numpy(case["images"])),
                                  torch.from_numpy(target))
        loss.backward()
        return {name: p.grad.numpy() for name, p in model.named_parameters()}

    names = {name for name, _ in _port(encoder, "gn",
                                       case["params"]).named_parameters()}
    assert names == set(want) - {"norm_mean", "norm_std"}
    grads_match_with_near_ties(run, want)


def test_trainer_step_matches_jax_trainer(reference):
    """One ce step (Adam, batch 4 as 2 micro-batches of 2) of mit_b0 at
    32^2 in the port's Trainer and the JAX Trainer."""
    jc = _jcfg("mit_b0")
    params = reference.params("mit_b0", "gn")
    rng = np.random.default_rng(7)
    batch = {"image": rng.random((4, 32, 32, 3), np.float32),
             "mask": rng.integers(0, CLASSES, (4, 40, 40), dtype=np.int32)}
    jt = JaxTrainer(jc, jcfg.TrainConfig(batch_size=4,
                                         accumulate_grad_batches=2,
                                         learning_rate=LR),
                    task="ce", model="segformer", use_mesh=False)
    new_state, metrics = jt.train_step(jt.state_from_params(params), batch,
                                       jax.random.PRNGKey(0))
    grad_fn = jax.jit(jax.grad(lambda p, b: jtasks.TASKS["ce"](
        p, b, jc, rng=None, deterministic=False,
        apply_fn=jseg.segformer_apply)[0]))
    grads = [grad_fn(params, {k: jnp.asarray(v[i:i + 2])
                              for k, v in batch.items()}) for i in (0, 2)]
    want = {k: v.numpy() for k, v in conv_params_from_jax(
        jax.tree_util.tree_map(lambda a, b: np.asarray((a + b) / 2),
                               *grads)).items()}
    new = conv_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      new_state.params))
    states = []

    def run():
        trainer = Trainer(_tcfg("mit_b0"), tcfg.TrainConfig(
            batch_size=4, accumulate_grad_batches=2, learning_rate=LR),
            task="ce", model="segformer", device="cpu")
        state, m = trainer.train_step(trainer.init_state(params), batch,
                                      seed=0)
        np.testing.assert_allclose(float(m["loss"]),
                                   float(metrics["loss"]), rtol=1e-5)
        states.append(state)
        return {name: p.grad.numpy()
                for name, p in state.model.named_parameters()}

    grads_match_with_near_ties(run, want)
    state = states[-1]
    assert state.step == 1 and isinstance(state.model, ConvSegModel)
    for name, p in state.model.named_parameters():
        # Adam's first step is lr·g/(|g| + eps): within lr where the
        # gradient is near zero, within lr·1e-2 elsewhere.
        diff = np.abs(p.detach().numpy() - new[name].numpy())
        assert diff.max() <= 2 * LR, name
        assert (diff[np.abs(want[name]) > 1e-6] <= LR * 1e-2).all(), name


@pytest.mark.parametrize("encoder", ENCODERS)
def test_bf16_argmax_agreement_with_jax(reference, encoder):
    """bf16 rounds differently in the two (the attention's eager order is
    kept, the sum orders are the libraries'); the agreement is recorded."""
    params = reference.params(encoder, "gn")
    images = np.random.default_rng(9).random((2, 64, 64, 3), np.float32)
    cfg = _jcfg(encoder, dtype="bfloat16")
    want = np.asarray(jax.jit(lambda p, x: jseg.segformer_apply(p, x, cfg))(
        params, jnp.asarray(images))).argmax(-1)
    with torch.no_grad():
        got = _port(encoder, "gn", params, "bfloat16")(
            torch.from_numpy(images)).argmax(-1).numpy()
    agreement = float((got == want).mean())
    print(f"{encoder} bf16 argmax agreement with JAX: {agreement:.6f}")
    assert agreement >= BF16_AGREEMENT_FLOOR


@pytest.mark.parametrize("name", ["mit_b0", "mit_b2", "small"])
def test_resolve_model_builds_segformer(name):
    assert registry.get_model_family("segformer") is \
        registry.MODEL_FAMILIES["segformer"]
    cfg, model = registry.resolve_model("segformer", name, num_classes=3,
                                        compute_dtype="float32",
                                        device="cpu")
    assert isinstance(model, ConvSegModel) and model.family == "segformer"
    assert cfg.is_mit == name.startswith("mit")
    assert len(model["proj"]) == (4 if cfg.is_mit else 3)
    with torch.no_grad():
        logits = model(torch.rand(1, 37, 53, 3))
    assert logits.shape == (1, 37, 53, 3) and bool(torch.isfinite(
        logits).all())
    with pytest.raises(KeyError, match="mit_b0"):
        registry.model_config("segformer", "mit_b9", num_classes=3)
    with pytest.raises(KeyError):
        registry.model_config("unet", "mit_b0", num_classes=3)


def test_runner_serves_a_segformer_row():
    runner = ModelRunner({"input_size": 32, "config_name": "mit_b0",
                          "num_classes": CLASSES,
                          "model_family": "segformer"},
                         compute_dtype="float32", buckets=(2,), device="cpu")
    images = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3),
                                               dtype=np.uint8)
    with torch.no_grad():
        want = torch.argmax(runner.model(
            torch.from_numpy(images).float() / 255.0), dim=-1)
    np.testing.assert_array_equal(runner.predict(images), want.numpy())


# --- pretrained HF directories ------------------------------------------

HF_LABELS, HF_WIDTH = 7, 32


@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    dims, depths, heads, srs = registry.MIT_PRESETS["mit_b0"]
    config = transformers.SegformerConfig(
        num_channels=3, num_encoder_blocks=4, depths=list(depths),
        sr_ratios=list(srs), hidden_sizes=list(dims),
        num_attention_heads=list(heads), patch_sizes=[7, 3, 3, 3],
        strides=[4, 2, 2, 2], mlp_ratios=[4, 4, 4, 4],
        decoder_hidden_size=HF_WIDTH, num_labels=HF_LABELS)
    torch.manual_seed(0)
    model = transformers.SegformerForSemanticSegmentation(config).eval()
    with torch.no_grad():  # a BatchNorm away from the identity, some
        # variances small enough that the fold's eps (1e-5) shows
        bn = model.decode_head.batch_norm
        bn.running_mean.uniform_(-0.5, 0.5)
        bn.running_var.uniform_(0.5, 2.0)
        small = bn.running_var[::4]
        small.copy_(torch.linspace(1e-4, 1e-3, len(small)))
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.2, 0.2)
    return model


@pytest.mark.parametrize("safe", [True, False],
                         ids=["safetensors", "pytorch_model_bin"])
def test_hf_directory_loads_as_in_jax(tmp_path, hf_model, safe):
    path = str(tmp_path / "hf")
    hf_model.save_pretrained(path, safe_serialization=safe)
    weights = "model.safetensors" if safe else "pytorch_model.bin"
    assert (tmp_path / "hf" / weights).is_file()
    jc, jparams = jregistry.resolve_model(
        "segformer", "mit_b0", num_classes=3, compute_dtype="float32",
        checkpoint_path=path)
    cfg, model = registry.resolve_model(
        "segformer", "mit_b0", num_classes=3, compute_dtype="float32",
        checkpoint_path=path, device="cpu")
    assert (cfg.encoder_name, cfg.head_norm, cfg.num_classes,
            cfg.embed_channels) == (jc.encoder_name, jc.head_norm,
                                    jc.num_classes, jc.embed_channels) == (
        "mit_b0", "affine", HF_LABELS, HF_WIDTH)
    assert cfg.normalize == jc.normalize
    images = np.random.default_rng(2).random((2, 37, 53, 3), np.float32)
    want = np.asarray(jseg.segformer_apply(jparams, jnp.asarray(images), jc))
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_hf_converter_matches_the_live_module(hf_model):
    """The converted weights reproduce HF's own forward (no input
    normalization, as HF's model takes normalized images): the
    ``linear_fuse`` block order and the BatchNorm fold."""
    cfg = SegformerConfig(encoder_name="mit_b0", num_classes=HF_LABELS,
                          embed_channels=HF_WIDTH, head_norm="affine",
                          normalize=False)
    model = registry.get_model_family("segformer").init(torch.Generator(),
                                                        cfg)
    model.load_state_dict(conv_params_from_jax(convert_hf_segformer_seg_state(
        hf_model.state_dict(), cfg)), strict=True)
    x = np.random.default_rng(3).standard_normal((2, 3, 64, 64)).astype(
        np.float32)
    with torch.no_grad():
        want = torch.nn.functional.interpolate(
            hf_model(torch.from_numpy(x)).logits, size=(64, 64),
            mode="bilinear", align_corners=False).numpy()
        got = model.eval()(torch.from_numpy(x.transpose(0, 2, 3, 1))).numpy()
    np.testing.assert_allclose(got.transpose(0, 3, 1, 2), want, atol=5e-5,
                               rtol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(1))


def test_safetensors_reader_matches_the_library(tmp_path):
    safetensors_torch = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "bf16": torch.randn(4, 2, generator=g).to(torch.bfloat16),
        "f16": torch.randn(7, generator=g).to(torch.float16),
        "i64": torch.arange(6).reshape(2, 3),
        "i8": torch.tensor([-127, 0, 5], dtype=torch.int8),
        "b": torch.tensor([True, False]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }
    path = str(tmp_path / "t.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt"})
    got = hf_dir.read_safetensors(path)
    assert sorted(got) == sorted(tensors)
    for name, want in tensors.items():
        assert got[name].dtype == want.dtype, name
        assert torch.equal(got[name], want), name


def test_hf_directory_faults_raise(tmp_path, hf_model):
    path = tmp_path / "hf"
    hf_model.save_pretrained(str(path))
    config = json.loads((path / "config.json").read_text())
    config["depths"] = [1, 1, 1, 1]
    (path / "config.json").write_text(json.dumps(config))
    with pytest.raises(ValueError, match="matches no MiT preset"):
        registry.resolve_model("segformer", "mit_b0", num_classes=3,
                               checkpoint_path=str(path), device="cpu")
    (path / "model.safetensors").unlink()
    with pytest.raises(FileNotFoundError, match="holds no weights"):
        hf_dir.read_hf_state(str(path))
    assert not hf_dir.is_hf_dir(str(tmp_path))
