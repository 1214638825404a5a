"""Kernel 10, the LayerNorm (``ops/layer_norm.py``, ``csrc/layer_norm.cu``),
and where the ViT forward takes it.

On the CPU: the dispatch rule (``kernel_takes``, on fake CUDA tensors), the
plain path everywhere it must stay (the CPU, a gradient, a tensor-parallel
plan, live dropout), the ops' CPU and fake implementations, and the
rewritten ``encoder_layer_out`` / ``vit_cut_step``: a ViT-B/16 forward bit
for bit equal to the block arithmetic as it was written before the fused
form. On the card (``card``): the kernel against its plain version at the
serving shapes of ViT-B/16, P4H768A12 and SegFormer-B5's four widths, and
one graphed ViT-B/16 forward through ``ModelRunner``. This file imports no
JAX, so that the host with the card, which has none, runs it alone without
``tests/conftest.py``: ``python -m pytest --noconftest
tests/test_torch_layer_norm.py -m card`` from the repository's root.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from chip_smoke import (
    LAYER_NORM_CASES,
    layer_norm_agreement,
    layer_norm_inputs,
)

from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.models import vit as vit_mod
from visiontransformer_tpu_torch.models.vit import (
    ViT,
    block_attention,
    encoder_layer_qkv,
    vit_apply,
    vit_cut_step,
    vit_embed,
)
from visiontransformer_tpu_torch.models.vitseg import (
    MasksForward,
    ViTSeg,
    set_token_merge_r,
)
from visiontransformer_tpu_torch.nn.layers import dropout, gelu_exact
from visiontransformer_tpu_torch.ops import layer_norm as ln
from visiontransformer_tpu_torch.utils import spans

B16 = dict(image_size=224, patch_size=16, hidden_size=768,
           num_hidden_layers=12, num_attention_heads=12,
           intermediate_size=3072)
TINY = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=3,
            num_attention_heads=4, intermediate_size=128)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _randomize(module: torch.nn.Module, seed: int) -> None:
    """Weights at std 0.02, biases and LayerNorm shifts at 0.1, LayerNorm
    scales at 1 + 0.1 N(0, 1), so every bias and scale moves the result."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            noise = torch.randn(p.shape, generator=gen).to(p.device)
            if name.endswith("scale"):
                p.copy_(1.0 + 0.1 * noise)
            elif name.endswith("bias") or p.dim() == 1:
                p.copy_(0.1 * noise)
            else:
                p.copy_(0.02 * noise)


def _vit(vit_kw, seed=0, **cfg_kw) -> ViT:
    model = ViT(tcfg.ViTConfig(**{**vit_kw, **cfg_kw}))
    _randomize(model, seed)
    return model


# ----------------------------------------------------------------- the rule
def _fake_cuda(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="cuda")


BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,cols,rows,where,takes", [
    (BF16, 768, 6, "cuda", True), (FP32, 768, 6, "cuda", True),
    (BF16, 64, 6, "cuda", True), (BF16, 320, 6, "cuda", True),
    (BF16, 2048, 6, "cuda", True), (FP32, 1024, 6, "cuda", True),
    (BF16, 768, 6, "grad", False), (torch.float16, 768, 6, "cuda", False),
    (BF16, 100, 6, "cuda", False), (BF16, 2056, 6, "cuda", False),
    (FP32, 1032, 6, "cuda", False), (BF16, 768, 0, "cuda", False),
    (BF16, 768, 6, "cpu", False)])
def test_kernel_takes(dtype, cols, rows, where, takes):
    with FakeTensorMode(), torch.no_grad():
        x = (torch.empty(rows, cols, dtype=dtype) if where == "cpu"
             else _fake_cuda((rows, cols), dtype))
        with torch.enable_grad() if where == "grad" else \
                contextlib.nullcontext():
            assert ln.kernel_takes(x) is takes


@pytest.mark.parametrize("grad", [False, True])
def test_fake_cuda_dispatch(grad):
    """On a CUDA tensor without a gradient the call reaches the ops (here
    their fake implementations: the shapes and types of the outputs); with
    one it runs the plain code and counts ``layer_norm_plain``."""
    spans.reset()
    with FakeTensorMode():
        x = _fake_cuda((2, 5, 64), torch.bfloat16)
        t = _fake_cuda((2, 5, 64), torch.bfloat16)
        p = _fake_cuda((64,), torch.float32)
        with torch.enable_grad() if grad else torch.inference_mode():
            y = ln.layer_norm(x, p, p, eps=1e-5)
            s, y2 = ln.add_layer_norm(x, t, p, p, p, eps=1e-5)
        for out in (y, s, y2):
            assert out.shape == x.shape and out.dtype == x.dtype
            assert out.is_cuda
    counts = spans.counters()
    assert counts.get("layer_norm_plain", 0) == (2 if grad else 0)
    assert counts.get("layer_norm", 0) == 0   # nothing launched
    spans.reset()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_takes_the_plain_code(dtype):
    gen = torch.Generator().manual_seed(3)
    x, t = (torch.randn(3, 7, 48, generator=gen).to(dtype) for _ in range(2))
    b, g, h = (torch.randn(48, generator=gen) for _ in range(3))
    spans.reset()
    with torch.inference_mode():
        y = ln.layer_norm(x, g, h, eps=1e-6)
        s, y2 = ln.add_layer_norm(x, t, b, g, h, eps=1e-6)
    assert spans.counters() == {}
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    want = ((x32 - mean) * torch.rsqrt(var + 1e-6) * g + h).to(dtype)
    assert torch.equal(y, want)
    want_s = x + (t + b.to(dtype))
    assert torch.equal(s, want_s)
    assert torch.equal(y2, ln.layer_norm_plain(want_s, g, h, 1e-6))


# ------------------------------------------------------------------ the ops
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["ln", "add_bias", "add"])
def test_ops_cpu_and_fake(dtype, form):
    gen = torch.Generator().manual_seed(5)
    x, t = (torch.randn(2, 9, 32, generator=gen).to(dtype) for _ in range(2))
    b, g, h = (torch.randn(32, generator=gen) for _ in range(3))
    if form == "ln":
        op, args = torch.ops.vt.layer_norm, (x, g, h, 1e-5)
        want = (ln.layer_norm_plain(x, g, h, 1e-5),)
    else:
        bias = b if form == "add_bias" else None
        op, args = torch.ops.vt.add_layer_norm, (x, t, bias, g, h, 1e-5)
        want = ln.add_layer_norm_plain(x, t, bias, g, h, 1e-5)
    torch.library.opcheck(op, args)
    got = op(*args)
    got = got if isinstance(got, tuple) else (got,)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args))
        fake = fake if isinstance(fake, tuple) else (fake,)
        assert [(f.shape, f.dtype) for f in fake] == [
            (w.shape, w.dtype) for w in want]


@pytest.mark.parametrize("device", ["cpu", "meta"])   # CPU and fake impls
@pytest.mark.parametrize("case", ["c_not_8", "fp16", "t_shape", "scale"])
def test_ops_refuse(device, case):
    c = 36 if case == "c_not_8" else 32
    dtype = torch.float16 if case == "fp16" else torch.float32
    x = torch.zeros(4, c, dtype=dtype, device=device)
    t = torch.zeros(4, c + 8 if case == "t_shape" else c, dtype=dtype,
                    device=device)
    p = torch.ones(c, device=device)
    g = torch.ones(c + 1, device=device) if case == "scale" else p
    with pytest.raises((TypeError, ValueError)):
        torch.ops.vt.add_layer_norm(x, t, p, g, p, 1e-5)
    if case != "t_shape":
        with pytest.raises((TypeError, ValueError)):
            torch.ops.vt.layer_norm(x, g, p, 1e-5)


# ------------------------------------------------------- where ViT takes it
@contextlib.contextmanager
def _spy():
    """Counts the calls of the LayerNorm's two forms, each passed on."""
    calls = collections.Counter()
    plain_ln, fused = ln.layer_norm, vit_mod.add_layer_norm

    def layer_norm(*a, **k):
        calls["layer_norm"] += 1
        return plain_ln(*a, **k)

    def add_layer_norm(*a, **k):
        calls["add_layer_norm"] += 1
        calls["with_bias"] += a[2] is not None
        return fused(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(ln, "layer_norm", layer_norm)
    mp.setattr(vit_mod, "add_layer_norm", add_layer_norm)
    try:
        yield calls
    finally:
        mp.undo()


@pytest.mark.parametrize("merge_r", [0, 2])
def test_serving_segments_take_the_fused_form(merge_r):
    """The cut forward: each ln2 with attn_out's bias and residual, and
    each block's mlp_out bias and residual with the LayerNorm after it
    (the next ln1, or the final one), unless ToMe's merge lies between;
    2L + 1 LayerNorms either way."""
    cfg = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**TINY), num_classes=5,
                            compute_dtype="bfloat16")
    model = ViTSeg(cfg)
    _randomize(model, 1)
    set_token_merge_r(model, merge_r)
    images = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    layers = TINY["num_hidden_layers"]
    with _spy() as calls, torch.inference_mode():
        MasksForward(model, (32, 32), torch.uint8)(images)
    fused = 2 * layers if merge_r == 0 else layers
    assert calls["add_layer_norm"] == calls["with_bias"] == fused
    assert calls["layer_norm"] == 2 * layers + 1 - fused


@pytest.mark.parametrize("case", ["eval", "grad", "dropout", "tp"])
def test_vit_encode_fused_form_only_where_dropout_is_inert_without_tp(case):
    """vit_encode fuses each block's residual add with its ln2 (its other
    LayerNorms take the LN form), and attn_out's bias with them where the
    dropout is inert and there is no tensor-parallel plan; under such a
    plan or with live dropout the bias stays in the product, whose dropout
    and reduction come before the add. Off the card, and under a gradient,
    every form runs the plain code, which equals the present code bit for
    bit."""
    kw = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.0)
    model = _vit(TINY, seed=4, **kw)
    images = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(6))
    if case == "tp":
        class _Identity:   # a plan over one rank: its collectives are no-ops
            seq_parallel = False

            def enter(self, y, n):
                return y

            def exit(self, y, n):
                return y

        for layer in model.layers:
            layer.tp = _Identity()
    deterministic = case != "dropout"
    gen = torch.Generator().manual_seed(7)
    grad = torch.enable_grad() if case == "grad" else torch.no_grad()
    with _spy() as calls, grad:
        got = vit_apply(model, images, deterministic=deterministic,
                        generator=gen)
    layers = TINY["num_hidden_layers"]
    assert calls["add_layer_norm"] == layers
    assert calls["with_bias"] == (layers if case in ("eval", "grad") else 0)
    assert calls["layer_norm"] == layers + 1
    with grad:
        want = _forward_as_before(
            model, images, generator=None if deterministic
            else torch.Generator().manual_seed(7))
    assert torch.equal(got, want)


def _block_out_as_before(layer, x, attn, cfg, generator=None):
    """encoder_layer_out as it was written before the fused form (no
    parallelism; the hidden dropout drawn from ``generator`` if given)."""
    def drop(y):
        return dropout(y, cfg.hidden_dropout_prob, generator=generator,
                       deterministic=generator is None)

    attn = attn.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
    x = x + drop(layer.attn_out(attn))
    y = ln.layer_norm_plain(x, layer.ln2.scale, layer.ln2.bias,
                            layer.ln2.eps)
    return x + drop(layer.mlp_out(gelu_exact(layer.mlp_in(y))))


def _forward_as_before(model: ViT, images, dtype=torch.float32,
                       generator=None):
    cfg = model.cfg
    x = vit_embed(model, images, dtype=dtype,
                  deterministic=generator is None, generator=generator)
    for layer in model.layers:
        qkv = encoder_layer_qkv(layer, x, cfg, normed=ln.layer_norm_plain(
            x, layer.ln1.scale, layer.ln1.bias, layer.ln1.eps))
        attn = block_attention(qkv, cfg, attn_impl="auto")
        x = _block_out_as_before(layer, x, attn, cfg, generator)
    return ln.layer_norm_plain(x, model.final_ln.scale, model.final_ln.bias,
                               model.final_ln.eps)


@pytest.fixture(scope="module")
def b16():
    return _vit(B16, seed=11)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b16_cpu_forward_bit_identical_to_before(b16, dtype):
    """ViT-B/16 at full width and depth, one image: vit_apply and the cut
    forward (every masks forward's path) equal the block arithmetic as it
    was before the fused form, bit for bit."""
    images = torch.rand(1, 224, 224, 3,
                        generator=torch.Generator().manual_seed(12))
    with torch.inference_mode():
        want = _forward_as_before(b16, images, dtype)
        got = vit_apply(b16, images, dtype=dtype)
        x, state, qkv = vit_cut_step(b16, 0,
                                     vit_embed(b16, images, dtype=dtype))
        for i in range(1, len(b16.layers) + 1):
            out = vit_cut_step(b16, i, x, state,
                               block_attention(qkv, b16.cfg,
                                               attn_impl="auto"))
            if i < len(b16.layers):
                x, state, qkv = out
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(out, want)


# ----------------------------------------------------------------- the card
@pytest.fixture
def card():
    """The CUDA card, decided here and not at import, so that every xdist
    worker collects the same tests; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("form", ["ln", "add_bias", "add"])
@pytest.mark.parametrize("shape,dtype", LAYER_NORM_CASES)
def test_kernel_matches_plain(card, shape, dtype, form):
    """chip_smoke.py's phase 3a check, case by case: s equal to the plain
    residual stream, y within ``layer_norm_agreement``'s tolerance."""
    gen = torch.Generator(device=card).manual_seed(shape[0] + shape[1])
    x, t, b, g, h, eps = layer_norm_inputs(shape, dtype, gen)
    spans.reset()
    with torch.inference_mode():
        if form == "ln":
            y = ln.layer_norm(x, g, h, eps=eps)
            want_y = ln.layer_norm_plain(x, g, h, eps)
        else:
            bias = b if form == "add_bias" else None
            s, y = ln.add_layer_norm(x, t, bias, g, h, eps=eps)
            want_s, want_y = ln.add_layer_norm_plain(x, t, bias, g, h, eps)
            assert torch.equal(s, want_s)
    torch.cuda.synchronize()
    assert spans.counters().get("layer_norm") == 1
    assert y.dtype == dtype
    agreement = layer_norm_agreement(y, want_y)
    assert agreement["ok"], agreement


@pytest.mark.card
def test_graphed_b16_forward_agrees_with_the_plain_path(card, monkeypatch):
    """ViT-B/16 with the benchmark cell's weights (``benchmark/weights.py``)
    and a batch of 32 through ModelRunner's CUDA graphs: kernel 10 in the
    captured segments (25 calls a captured forward, and 25 in the eager
    pass before the capture; none plain, none in a replay), masks equal to
    the eager forward's bit for bit. Against the eager forward with the
    plain LayerNorm: the grid logits within 4 bf16 ulps of logits below 2
    (2^-5; 0.0161 on an H100), and >= 99.5 % of the pixels equal. The
    logits' top two lie close under random weights (median gap 0.17), so
    a change of rounding anywhere flips the pixels where they tie: on an
    H100 the plain forward with eager attention in place of kernel 1
    flips more (99.67 % equal, logits 0.0195 apart, against 99.72 %
    here)."""
    from benchmark.weights import make_weights
    from visiontransformer_tpu_torch.models.vitseg import (
        vitseg_head_logits,
        vitseg_predict,
    )
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    row = {"model_family": "vitseg", "config_name": "P16H768A12",
           "num_classes": 17, "input_size": 224}
    runner = ModelRunner(row, device="cuda", buckets=(32,))
    cfg = dict(B16, num_channels=3, head_channels=256, num_classes=17)
    weights = make_weights(cfg, 12345, card)
    runner.model.load_state_dict({k: v.float() for k, v in weights.items()})
    spans.reset()
    runner.warmup()
    counts = spans.counters()
    assert counts.get("layer_norm", 0) == 2 * 25
    assert counts.get("layer_norm_plain", 0) == 0
    images = np.random.default_rng(22).integers(0, 256, (32, 224, 224, 3),
                                                np.uint8)
    got = np.asarray(runner.predict(images))
    assert spans.counters().get("layer_norm", 0) == 2 * 25   # replays
    x = torch.from_numpy(images).to(card).float() / 255.0

    def forward():
        with torch.inference_mode():
            return (vitseg_head_logits(runner.model, x).float(),
                    vitseg_predict(runner.model, x, out_size=(224, 224),
                                   mask_dtype=runner.mask_dtype).cpu().numpy())

    logits, masks = forward()
    assert np.array_equal(got, masks)
    monkeypatch.setattr(ln, "kernel_takes", lambda x: False)
    plain_logits, plain_masks = forward()
    assert spans.counters().get("layer_norm", 0) == 2 * 25 + 2 * 25
    assert float((logits - plain_logits).abs().max()) <= 2.0 ** -5
    assert float((got == plain_masks).mean()) >= 0.995
