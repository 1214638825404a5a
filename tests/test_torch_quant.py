"""PyTorch port vs the JAX package: W8A8 int8 quantization.

The W8A8 linear (``nn/layers.py:_linear_w8a8``), the weight quantizer and
the tree walk (``ops/quant.py``), a JAX-quantized tree through the weight
bridge, the trainer's refusal, and the serving opt-in rows (worker, store,
``register-model``), on the tiny config of tests/test_torch_model.py.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.models.vitseg import vitseg_head_logits as jhead
from visiontransformer_tpu.models.vitseg import vitseg_init
from visiontransformer_tpu.models.vitseg import vitseg_predict as jpredict
from visiontransformer_tpu.nn.layers import _linear_w8a8 as jax_linear_w8a8
from visiontransformer_tpu.ops import quant as jquant
from visiontransformer_tpu.serve.store import JobStore as JaxJobStore
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.ckpt.convert import load_jax_params
from visiontransformer_tpu_torch.cli import main as cli_main
from visiontransformer_tpu_torch.models.vitseg import (
    ViTSeg,
    set_token_merge_r,
    vitseg_head_logits,
    vitseg_predict,
)
from visiontransformer_tpu_torch.nn.layers import (
    Linear,
    LinearW8A8,
    _linear_w8a8,
    int8_matmul,
    int8_matmul_plain,
)
from visiontransformer_tpu_torch.ops import quant as tquant
from visiontransformer_tpu_torch.scripts import optin_quality
from visiontransformer_tpu_torch.serve.store import JobStore
from visiontransformer_tpu_torch.serve.worker import ModelRunner
from visiontransformer_tpu_torch.train.state import TrainState
from visiontransformer_tpu_torch.train.trainer import Trainer

VIT = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128)
CLASSES = 5
# bf16: argmax agreement of the quantized port's masks with the quantized
# JAX model's, both in bf16 on the CPU; measured 0.9966 on this input.
BF16_AGREEMENT_FLOOR = 0.99


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype="float32"):
    return (jcfg.ViTSegConfig(vit=jcfg.ViTConfig(**VIT), num_classes=CLASSES,
                              compute_dtype=dtype),
            tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**VIT), num_classes=CLASSES,
                              compute_dtype=dtype))


@pytest.fixture(scope="module")
def jax_params():
    return vitseg_init(jax.random.PRNGKey(0), _configs()[0])


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _linear(seed, n_in=64, n_out=96, bias=True):
    rng = np.random.default_rng(seed)
    params = {"kernel": (rng.standard_normal((n_in, n_out)) * 0.05
                         ).astype(np.float32)}
    if bias:
        params["bias"] = (rng.standard_normal(n_out) * 0.1).astype(np.float32)
    x = (rng.standard_normal((4, 7, n_in)) * 3).astype(np.float32)
    return params, x


@pytest.mark.parametrize("bias", [True, False])
def test_quantize_linear_params_equals_jax(bias):
    params, _ = _linear(0, bias=bias)
    want = _numpy(jquant.quantize_linear_params(
        {k: jnp.asarray(v) for k, v in params.items()}))
    got = tquant.quantize_linear_params(torch.from_numpy(params["kernel"]),
                                        None if not bias else
                                        torch.from_numpy(params["bias"]))
    assert set(got) == set(want)
    assert got["kernel_q"].dtype == torch.int8
    np.testing.assert_array_equal(got["kernel_q"].numpy(), want["kernel_q"])
    np.testing.assert_array_equal(got["kernel_scale"].numpy(),
                                  want["kernel_scale"])
    # A zero column takes the 1e-12 floor, as in JAX.
    params["kernel"][:, 3] = 0.0
    np.testing.assert_array_equal(
        tquant.quantize_linear_params(params["kernel"])["kernel_scale"],
        np.asarray(jquant.quantize_linear_params(
            {"kernel": jnp.asarray(params["kernel"])})["kernel_scale"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_linear_w8a8_fp32_matches_jax(seed):
    """Bit for bit against the JAX function run op by op; within the
    rounding of XLA's rewrite against the jitted one. XLA on the CPU turns
    max|x| / 127 into max|x| * (1/127) (its optimized HLO holds a multiply
    where the source divides), so the jitted s_x may sit one ulp away:
    the dequantized product acc * s_x * s_w then moves by up to 2 ulps of
    its magnitude (measured 1.22), and the bias sum by one ulp of the
    result."""
    params, x = _linear(seed)
    jp = jquant.quantize_linear_params(
        {k: jnp.asarray(v) for k, v in params.items()})
    tp = tquant.quantize_linear_params(torch.from_numpy(params["kernel"]),
                                       torch.from_numpy(params["bias"]))
    got = _linear_w8a8(torch.from_numpy(x), **tp).numpy()
    with jax.disable_jit():
        eager = np.asarray(jax_linear_w8a8(jp, jnp.asarray(x)))
    np.testing.assert_array_equal(got, eager)
    jitted = np.asarray(jax.jit(jax_linear_w8a8)(jp, jnp.asarray(x)))
    product = np.abs(got - params["bias"])
    bound = 2 * 2.0 ** -23 * product + np.spacing(np.abs(jitted))
    assert (np.abs(got - jitted) <= bound).all()
    assert got.dtype == np.float32


def test_linear_w8a8_bf16_activations_match_jax():
    params, x = _linear(3)
    jp = jquant.quantize_linear_params(
        {k: jnp.asarray(v) for k, v in params.items()})
    layer = LinearW8A8(**tquant.quantize_linear_params(
        torch.from_numpy(params["kernel"]), torch.from_numpy(params["bias"])))
    xb = jnp.asarray(x, jnp.bfloat16)
    with jax.disable_jit():
        want = np.asarray(jax_linear_w8a8(jp, xb).astype(jnp.float32))
    got = layer(torch.from_numpy(np.array(xb.astype(jnp.float32)))
                .to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # dtype= casts the input first, as the fp path does.
    assert layer(torch.from_numpy(x), dtype=torch.bfloat16).dtype == \
        torch.bfloat16


def test_int8_matmul_plain_is_exact():
    rng = np.random.default_rng(4)
    a = rng.integers(-127, 128, (33, 3072), dtype=np.int8)
    b = rng.integers(-127, 128, (3072, 24), dtype=np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        int8_matmul_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        want)
    with pytest.raises(ValueError, match="int8"):
        int8_matmul(torch.from_numpy(a).float(), torch.from_numpy(b))


def test_quantize_vitseg_form_and_input_unchanged(jax_params):
    _, t = _configs()
    model = load_jax_params(ViTSeg(t), _numpy(jax_params))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    qmodel = tquant.quantize_vitseg(model)
    assert tquant.is_quantized(qmodel) and not tquant.is_quantized(model)
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key
    for layer in qmodel.backbone.layers:
        for key in tquant.QUANTIZED_LAYER_KEYS:
            module = getattr(layer, key)
            assert isinstance(module, LinearW8A8)
            assert module.kernel_q.dtype == torch.int8
            # Column-major, the layout cuBLASLt's int8 product is fast on.
            assert module.kernel_q.stride() == (1, module.kernel_q.shape[0])
            assert not any(True for _ in module.parameters())
    assert isinstance(qmodel.backbone.patch_embed, Linear)
    backbone = tquant.quantize_vit(model.backbone)
    assert tquant.is_quantized(backbone)
    assert not tquant.is_quantized(model.backbone)
    # The state dict is keyed like the TPU package's quantized tree.
    qtree = jquant.quantize_vitseg_params(jax_params)
    assert set(qmodel.state_dict()) == set(
        _flat_keys(_numpy(qtree)))


def _flat_keys(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_keys(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_keys(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1]


def test_jax_quantized_tree_serves_in_the_port(rng, jax_params):
    """A JAX-quantized tree through load_jax_params gives the
    port-quantized model's logits bit for bit, and the quantized JAX
    model's within the fp32 logits tolerance, masks equal."""
    j, t = _configs()
    qtree = jquant.quantize_vitseg_params(jax_params)
    loaded = load_jax_params(ViTSeg(t), _numpy(qtree)).eval()
    assert tquant.is_quantized(loaded)
    kq = loaded.backbone.layers[0].qkv.kernel_q
    assert kq.stride() == (1, kq.shape[0])
    ported = tquant.quantize_vitseg(
        load_jax_params(ViTSeg(t), _numpy(jax_params)).eval())
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = vitseg_head_logits(loaded, torch.from_numpy(x),
                                 attn_impl="eager")
        again = vitseg_head_logits(ported, torch.from_numpy(x),
                                   attn_impl="eager")
        masks = vitseg_predict(loaded, torch.from_numpy(x), epilogue="plain")
    assert torch.equal(got, again)
    want = jhead(qtree, jnp.asarray(x), j, attn_impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    np.testing.assert_array_equal(
        masks.numpy(), np.asarray(jpredict(qtree, jnp.asarray(x), j,
                                           attn_impl="xla")))


def test_quantized_bf16_masks_agree(rng, jax_params):
    j, t = _configs("bfloat16")
    qtree = jquant.quantize_vitseg_params(jax_params)
    model = load_jax_params(ViTSeg(t), _numpy(qtree)).eval()
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = vitseg_predict(model, torch.from_numpy(x)).numpy()
    want = np.asarray(jpredict(qtree, jnp.asarray(x), j, attn_impl="xla"))
    agreement = float((got == want).mean())
    print(f"int8 bf16 argmax agreement with JAX: {agreement:.4f}")
    assert agreement >= BF16_AGREEMENT_FLOOR


def test_quantize_params_tree_follows_jax_rules():
    rng = np.random.default_rng(5)
    lin = lambda i, o: {"kernel": rng.standard_normal((i, o)).astype(
        np.float32), "bias": rng.standard_normal(o).astype(np.float32)}
    tree = {"patch_embed": lin(48, 16), "head": lin(16, 3),
            "blocks": [{"fc": lin(16, 32), "ln": {"scale": np.ones(16)}},
                       {"fc": lin(32, 16)}],
            "stem": {"kernel": rng.standard_normal((3, 3, 3, 8)).astype(
                np.float32)},
            "dw": {"kernel": rng.standard_normal((3, 3, 1, 8)).astype(
                np.float32)},
            "pos": rng.standard_normal((1, 4, 16)).astype(np.float32)}
    want = _numpy(jquant.quantize_params_tree(
        jax.tree_util.tree_map(jnp.asarray, tree)))
    got = tquant.quantize_params_tree(tree)
    assert tquant.tree_is_quantized(got) and tquant.is_quantized(got)
    assert not tquant.tree_is_quantized(tree)
    assert jquant.tree_is_quantized(want)
    assert sorted(_flat_keys(got)) == sorted(_flat_keys(want))
    for (path, g), (_, w) in zip(
            sorted(jax.tree_util.tree_flatten_with_path(got)[0],
                   key=lambda kv: str(kv[0])),
            sorted(jax.tree_util.tree_flatten_with_path(want)[0],
                   key=lambda kv: str(kv[0]))):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=str(path))
    # An interior conv (cin > 4) quantizes as the TPU package's does
    # (tests/test_torch_conv_quant.py holds whole conv trees).
    conv = {"conv": {"kernel": np.random.default_rng(0).standard_normal(
        (3, 3, 8, 8)).astype(np.float32), "bias": np.zeros(8, np.float32)}}
    got = tquant.quantize_params_tree(conv)
    want = _numpy(jquant.quantize_params_tree(
        jax.tree_util.tree_map(jnp.asarray, conv)))
    assert got["conv"]["kernel_q"].dtype == torch.int8
    for key in ("kernel_q", "kernel_scale", "bias"):
        np.testing.assert_array_equal(np.asarray(got["conv"][key]),
                                      want["conv"][key], err_msg=key)


def test_trainer_refuses_a_quantized_model(jax_params):
    _, t = _configs()
    trainer = Trainer(t, tcfg.TrainConfig(batch_size=2,
                                          accumulate_grad_batches=1),
                      device="cpu")
    state = trainer.init_state(_numpy(jquant.quantize_vitseg_params(
        jax_params)))
    assert tquant.is_quantized(state.model)
    batch = {"image": np.zeros((2, 32, 32, 3), np.float32),
             "mask": np.zeros((2, 256, 256), np.int32)}
    with pytest.raises(ValueError, match="inference-only"):
        trainer.train_step(state, batch, 0)
    fp = trainer.init_state(_numpy(jax_params))
    with pytest.raises(ValueError, match="kernel_q"):
        trainer.train_step(TrainState(
            model=tquant.quantize_vitseg(fp.model),
            optimizer=fp.optimizer), batch, 0)


def test_runner_serves_rows_with_the_opt_ins(tmp_path):
    """A row with token_merge_r and quantize="int8" loads with merging on
    and W8A8 encoder linears, and its masks are those of the same model
    made by hand."""
    store = JobStore(str(tmp_path / "db.sqlite"),
                     media_root=str(tmp_path / "media"))
    kwargs = dict(num_classes=3, config_name="P16H512A8", input_size=32)
    plain_id = store.register_model("plain", **kwargs)
    opt_id = store.register_model("opt", token_merge_r=1, quantize="int8",
                                  **kwargs)
    images = np.random.default_rng(6).integers(0, 256, (2, 32, 32, 3),
                                               dtype=np.uint8)
    plain = ModelRunner(store.get_model(plain_id), device="cpu",
                        compute_dtype="float32", buckets=(2,))
    runner = ModelRunner(store.get_model(opt_id), device="cpu",
                         compute_dtype="float32", buckets=(2,))
    assert runner.cfg.vit.token_merge_r == 1
    assert runner.model.backbone.cfg.token_merge_r == 1
    assert tquant.is_quantized(runner.model)
    assert not tquant.is_quantized(plain.model)
    assert plain.cfg.vit.token_merge_r == 0
    by_hand = tquant.quantize_vitseg(plain.model)
    set_token_merge_r(by_hand, 1)
    with torch.no_grad():
        want = vitseg_predict(
            by_hand, torch.from_numpy(images).float() / 255.0,
            mask_dtype=torch.uint8).numpy()
    np.testing.assert_array_equal(runner.predict(images), want)


def test_store_refuses_what_jax_refuses(tmp_path):
    for store_cls in (JobStore, JaxJobStore):
        store = store_cls(str(tmp_path / f"{store_cls.__module__}.db"),
                          media_root=str(tmp_path / "media"))
        with pytest.raises(ValueError, match="vitseg models only"):
            store.register_model("unet", num_classes=3,
                                 config_name="resnet18",
                                 model_family="unet", token_merge_r=8)
        with pytest.raises(ValueError, match="quantize"):
            store.register_model("fp8", num_classes=3,
                                 config_name="P16H512A8", quantize="fp8")


def test_register_model_takes_the_opt_ins(tmp_path):
    db, media = str(tmp_path / "serving.db"), str(tmp_path / "media")
    base = ["register-model", "--db", db, "--media-root", media,
            "--config", "P16H768A12"]
    assert cli_main(base + ["--name", "tome", "--token-merge-r", "16"]) == 0
    assert cli_main(base + ["--name", "int8", "--quantize", "int8"]) == 0
    with pytest.raises(SystemExit):
        cli_main(base + ["--name", "fp8", "--quantize", "fp8"])
    rows = {r["name"]: r for r in JobStore(db, media_root=media)
            .list_models()}
    assert (rows["tome"]["token_merge_r"], rows["tome"]["quantize"]) == (
        16, "")
    assert (rows["int8"]["token_merge_r"], rows["int8"]["quantize"]) == (
        0, "int8")


def test_optin_quality_script_on_cpu(tmp_path, capsys):
    """The quality script's steps at a tiny size on the host: every variant
    scored, agreement of the exact model with itself 1, speed not
    measured."""
    out = tmp_path / "optin.json"
    assert optin_quality.main([
        "--device", "cpu", "--samples", "4", "--test-samples", "2",
        "--epochs", "1", "--config", "P16H512A8", "--image-size", "32",
        "--in-size", "64", "--batch", "2", "--speed-rounds", "0",
        "--layer-errors", "--out", str(out)]) == 0
    result = json.loads(out.read_text())["optin_quality"]
    assert result["device"] == "cpu"
    # Each W8A8 linear against itself on the host: 8 layers of 4.
    layers = result["layer_errors"]
    assert len(layers) == 8 * 4
    assert all(r["acc_equal"] and r["max_ulp"] == 0.0 for r in layers)
    for name in optin_quality.VARIANTS:
        assert 0.0 <= result[name]["agreement"] <= 1.0
        assert 0.0 <= result[name]["pixel_accuracy"] <= 100.0
        assert result[name]["masks_per_s"] is None
    assert result["exact"]["agreement"] == 1.0
    assert "not measured" in capsys.readouterr().out
