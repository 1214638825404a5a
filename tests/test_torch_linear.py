"""The linear layer's bias in the GEMM's epilogue (``nn/layers.py:linear``).

On the CPU: the dispatch rule (``epilogue_takes``, on fake CUDA tensors),
the CPU path bit for bit the product and then the bias add, the counters
by path, the fake-CUDA dispatch to the fused call without a gradient and
to the plain code with one, and which linears of a ViT masks forward and
of a MiT forward reach the rule with x foldable into rows. On the card
(``card``): at every linear shape of the benchmark's cells, the fused
output against an fp64 product of the same bf16 operands and against the
plain path; the graphed ViT-B/16 and P4H768A12 forwards equal to their
eager forwards bit for bit, with every biased linear fused. This file
imports no JAX, so that the host with the card runs it alone:
``python -m pytest --noconftest tests/test_torch_linear.py -m card`` from
the repository's root.
"""

import collections
import contextlib
import json
import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from chip_smoke import LINEAR_CASES, linear_agreement, linear_inputs

from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.models import mit as tmit
from visiontransformer_tpu_torch.models.vitseg import MasksForward, ViTSeg
from visiontransformer_tpu_torch.nn import layers
from visiontransformer_tpu_torch.ops import layer_norm as ln
from visiontransformer_tpu_torch.utils import spans

BF16, FP16, FP32 = torch.bfloat16, torch.float16, torch.float32
TINY = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=3,
            num_attention_heads=4, intermediate_size=128)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_spans():
    spans.reset()
    yield
    spans.reset()


def _fake_cuda(shape, dtype=BF16, stride=None):
    if stride is not None:
        return torch.empty_strided(shape, stride, dtype=dtype, device="cuda")
    return torch.empty(shape, dtype=dtype, device="cuda")


# ----------------------------------------------------------------- the rule
def _case(case):
    """(x, kernel, bias, grad) of one case of the rule, made under a
    FakeTensorMode: x (6, 5, 32) bf16 against a (32, 48) kernel and a (48,)
    bias on the fake card unless the case changes one of them."""
    dtype = {"fp16": FP16, "fp32": FP32, "fp64": torch.float64}.get(case, BF16)
    x = _fake_cuda((6, 5, 32), dtype)
    kernel, bias = _fake_cuda((32, 48), FP32), _fake_cuda((48,), FP32)
    if case == "cpu":
        x, kernel, bias = (torch.empty(6, 5, 32, dtype=BF16),
                           torch.empty(32, 48), torch.empty(48))
    elif case == "transposed":
        x = _fake_cuda((6, 5, 32), stride=(160, 1, 5))
    elif case == "sliced_features":  # 32 of 40 features: the axes fold
        x = _fake_cuda((6, 5, 32), stride=(200, 40, 1))
    elif case == "sliced_tokens":    # (6, 5) out of (6, 7): they do not
        x = _fake_cuda((6, 5, 32), stride=(224, 32, 1))
    elif case == "size_one_axis":
        x = _fake_cuda((6, 1, 32), stride=(32, 7, 1))
    elif case == "one_row":
        x = _fake_cuda((1, 1, 32))
    elif case == "empty":
        x = _fake_cuda((0, 5, 32))
    elif case == "kernel_3d":
        kernel = _fake_cuda((1, 32, 48), FP32)
    elif case == "no_bias":
        bias = None
    elif case == "bias_2d":
        bias = _fake_cuda((1, 48), FP32)
    elif case == "bias_broadcast":
        bias = _fake_cuda((1,), FP32)
    elif case == "one_out":
        kernel, bias = _fake_cuda((32, 1), FP32), _fake_cuda((1,), FP32)
    elif case == "too_many_rows":
        x = _fake_cuda((layers.EPILOGUE_MAX_DIM + 1, 32))
    elif case == "most_rows":
        x = _fake_cuda((layers.EPILOGUE_MAX_DIM, 32))
    elif case == "x_2d":
        x = _fake_cuda((30, 32))
    return x, kernel, bias, case == "grad"


@pytest.mark.parametrize("case,takes", [
    ("bf16", True), ("fp16", True), ("fp32", True), ("x_2d", True),
    ("sliced_features", True), ("size_one_axis", True), ("most_rows", True),
    ("cpu", False), ("grad", False), ("fp64", False), ("kernel_3d", False),
    ("no_bias", False), ("bias_2d", False), ("bias_broadcast", False),
    ("transposed", False), ("sliced_tokens", False), ("one_row", False),
    ("empty", False), ("one_out", False), ("too_many_rows", False)])
def test_epilogue_takes(case, takes):
    with FakeTensorMode(), torch.no_grad():
        x, kernel, bias, grad = _case(case)
        with torch.enable_grad() if grad else contextlib.nullcontext():
            assert layers.epilogue_takes(x, kernel, bias) is takes


@contextlib.contextmanager
def _addmm_calls():
    """Counts the calls of ``torch.addmm``, each passed on."""
    calls = collections.Counter()
    addmm = torch.addmm

    def spy(*a, **k):
        calls["addmm"] += 1
        return addmm(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(torch, "addmm", spy)
    try:
        yield calls
    finally:
        mp.undo()


@pytest.mark.parametrize("grad", [False, True])
def test_fake_cuda_dispatch(grad):
    """On a CUDA tensor without a gradient the call is one ``addmm`` over
    x's rows, viewed back to (..., out); with one it runs the plain code.
    Either way one count under its path's name."""
    with FakeTensorMode(), _addmm_calls() as calls:
        x = _fake_cuda((2, 5, 32))
        kernel, bias = _fake_cuda((32, 48), FP32), _fake_cuda((48,), FP32)
        with torch.enable_grad() if grad else torch.inference_mode():
            y = layers.linear(x, kernel, bias)
        assert y.shape == (2, 5, 48) and y.dtype == BF16 and y.is_cuda
        assert y.is_contiguous()
    assert calls["addmm"] == (0 if grad else 1)
    assert spans.counters() == ({"linear_plain": 1} if grad
                                else {"linear_epilogue": 1})


@pytest.mark.parametrize("case,counted", [
    ("bf16", "linear_epilogue"), ("transposed", "linear_plain"),
    ("one_row", "linear_plain"), ("fp64", "linear_plain"),
    ("no_bias", None), ("cpu", None)])
def test_counters_by_path(case, counted):
    """One count a call: ``linear_epilogue`` where the rule takes it,
    ``linear_plain`` for a biased call on a card that it does not take,
    nothing for a call without a bias or off the card."""
    with FakeTensorMode(), torch.inference_mode():
        x, kernel, bias, _ = _case(case)
        for _ in range(3):
            y = layers.linear(x, kernel, bias, dtype=x.dtype)
            assert y.shape == (*x.shape[:-1], kernel.shape[-1])
    assert spans.counters() == ({} if counted is None else {counted: 3})


@pytest.mark.parametrize("dtype", [FP32, BF16])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("cast", [False, True])
def test_cpu_linear_is_the_plain_arithmetic(dtype, bias, cast):
    """Off the card ``linear`` is the product in the activation dtype, then
    the bias added in it, bit for bit, and counts nothing."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(3, 7, 40, generator=gen)
    kernel = torch.randn(40, 24, generator=gen) / 40 ** 0.5
    b = torch.randn(24, generator=gen) if bias else None
    if not cast:
        x = x.to(dtype)
    with torch.inference_mode():
        got = layers.linear(x, kernel, b, dtype=dtype if cast else None)
    x = x.to(dtype)
    want = torch.matmul(x, kernel.to(dtype))
    if bias:
        want = want + b.to(dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(got, layers.linear_plain(x, kernel, b))
    assert spans.counters() == {}


def test_cpu_linear_under_autograd_is_the_plain_arithmetic():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 5, 16, generator=gen, requires_grad=True)
    module = layers.Linear(16, 8)
    with torch.no_grad():
        module.kernel.copy_(torch.randn(16, 8, generator=gen))
        module.bias.copy_(torch.randn(8, generator=gen))
    y = module(x)
    y.sum().backward()
    assert torch.equal(y, torch.matmul(x, module.kernel) + module.bias)
    assert torch.equal(module.bias.grad, torch.full((8,), 10.0))
    assert spans.counters() == {}


# ----------------------------------------------- which linears reach the rule
@contextlib.contextmanager
def _rule_calls():
    """The biased calls that reach ``epilogue_takes``, each with whether
    its x folds into rows; the rule itself is passed on."""
    calls = []
    rule = layers.epilogue_takes

    def spy(x, kernel, bias):
        if bias is not None:
            calls.append((tuple(x.shape), layers._folds(x)))
        return rule(x, kernel, bias)

    mp = pytest.MonkeyPatch()
    mp.setattr(layers, "epilogue_takes", spy)
    try:
        yield calls
    finally:
        mp.undo()


def test_vit_masks_forward_biased_linears_all_fold():
    """The masks forward (the graphs' and every eager masks path's) has
    2L + 1 biased linears, the patch embedding and each block's qkv and
    mlp_in (attn_out's and mlp_out's biases go with kernel 10), each on an
    x that folds into rows, so a card runs each in the epilogue."""
    cfg = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**TINY), num_classes=5,
                            compute_dtype="bfloat16")
    model = ViTSeg(cfg)
    images = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    with _rule_calls() as calls, torch.inference_mode():
        MasksForward(model, (32, 32), torch.uint8)(images)
    layers_n = TINY["num_hidden_layers"]
    assert len(calls) == 2 * layers_n + 1
    assert all(folds for _, folds in calls)
    assert calls[0][0] == (2, 16, 8 * 8 * 3)   # the patch embedding
    assert [shape[-1] for shape, _ in calls[1:3]] == [64, 64]


def test_mit_forward_biased_linears_all_fold(monkeypatch):
    """A MiT forward's biased linears are each block's q, k, v, proj, fc1
    and fc2, each on an x that folds into rows where the LayerNorms write
    contiguous rows, as kernel 10 does on a card (the plain code keeps its
    input's layout, and the patch embedding's tokens are a transposed map):
    the spatial reduction's and the Mix-FFN's convolutions hand their
    tokens over as contiguous rows too (a channels-last map of (B, H·W, C)
    tokens in, so one out), so a card runs all of them in the epilogue."""
    plain_ln = ln.layer_norm

    def rows_ln(*a, **k):
        return plain_ln(*a, **k).contiguous()

    monkeypatch.setattr(ln, "layer_norm", rows_ln)
    params = tmit.mit_encoder_init(torch.Generator().manual_seed(0),
                                   "mit_b0")
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with _rule_calls() as calls, torch.no_grad():
        tmit.mit_encoder_apply(params, x.to(BF16), "mit_b0")
    blocks = sum(tmit.MIT_PRESETS["mit_b0"][1])
    assert len(calls) == 6 * blocks
    assert all(folds for _, folds in calls), [
        shape for shape, folds in calls if not folds]


# ----------------------------------------------------------------- the card
@pytest.fixture
def card():
    """The CUDA card, decided here and not at import, so that every xdist
    worker collects the same tests; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("shape", LINEAR_CASES)
def test_fused_against_fp64_and_plain(card, shape):
    """chip_smoke.py's phase 3b check, shape by shape: one launch in the
    epilogue, its largest error against the fp64 product of the same bf16
    operands plus the bias no larger than the plain path's, and each value
    within ``linear_agreement``'s ulps of the plain one."""
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    x, kernel, bias = linear_inputs(shape, gen)
    with torch.inference_mode():
        fused = layers.linear(x, kernel, bias)
        plain = layers.linear_plain(x, kernel, bias)
    assert spans.counters() == {"linear_epilogue": 1}
    agreement = linear_agreement(x, kernel, bias, fused, plain)
    assert agreement["ok"], agreement


@pytest.mark.card
@pytest.mark.parametrize("config", ["vitseg_b16", "vitseg_p4"])
def test_graphed_masks_equal_eager(card, config):
    """The benchmark cell's model at bucket 32 through ModelRunner's CUDA
    graphs: 2L + 1 linears in the epilogue in the eager pass before the
    capture and as many in the capture, none plain, none in a replay;
    masks equal to the eager masks forward's bit for bit."""
    from benchmark.weights import make_weights
    from visiontransformer_tpu_torch.models.vitseg import vitseg_predict
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    with open(os.path.join(ROOT, "benchmark", "configs",
                           config + ".json")) as f:
        cfg = json.load(f)
    row = {"model_family": "vitseg", "config_name": cfg["port_config_name"],
           "num_classes": cfg["num_classes"], "input_size": 224}
    runner = ModelRunner(row, device="cuda", buckets=(32,))
    weights = make_weights(cfg, 2323, card)
    runner.model.load_state_dict({k: v.float() for k, v in weights.items()})
    per_forward = 2 * cfg["num_hidden_layers"] + 1
    spans.reset()
    runner.warmup()
    counts = spans.counters()
    assert counts.get("linear_epilogue", 0) == 2 * per_forward
    assert counts.get("linear_plain", 0) == 0
    images = np.random.default_rng(23).integers(0, 256, (32, 224, 224, 3),
                                                np.uint8)
    got = np.asarray(runner.predict(images))
    assert spans.counters().get("linear_epilogue", 0) == 2 * per_forward
    x = torch.from_numpy(images).to(card).float() / 255.0
    with torch.inference_mode():
        want = vitseg_predict(runner.model, x, out_size=(224, 224),
                              mask_dtype=runner.mask_dtype).cpu().numpy()
    assert np.array_equal(got, want)
    del runner
    torch.cuda.empty_cache()
