"""The serving forward cut for CUDA graphs, on the CPU: the one masks
forward (``models/vitseg.py:MasksForward``), eagerly and segment by
segment, against the per-block forward, ``encoder_layer`` against its
two halves, the ``out`` overload of
``vt::flash_attention_fwd`` (plain and fake), and a CPU ``ModelRunner``,
which captures nothing. The graphs themselves run only on a card
(``chip_smoke.py``, phases ``serving`` and ``optin``)."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import visiontransformer_tpu_torch.models.registry as port_registry
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.models.vit import (
    block_attention,
    encoder_layer,
    encoder_layer_out,
    encoder_layer_qkv,
)
from visiontransformer_tpu_torch.models.vitseg import (
    MasksForward,
    ViTSeg,
    set_token_merge_r,
    vitseg_head_logits,
    vitseg_predict,
)
from visiontransformer_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from visiontransformer_tpu_torch.ops.upsample_argmax import upsample_argmax
from visiontransformer_tpu_torch.serve.worker import ModelRunner
from visiontransformer_tpu_torch.utils import spans

TINY = dict(patch_size=8, hidden_size=64, num_hidden_layers=3,
            num_attention_heads=4, intermediate_size=128)


def _model(dtype="float32", **vit):
    cfg = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(image_size=32,
                                               **{**TINY, **vit}),
                            num_classes=5, compute_dtype=dtype)
    torch.manual_seed(0)
    model = ViTSeg(cfg)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.5)
    return model


@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("merge_r", [0, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segmented_forward_equals_vitseg_predict(dtype, merge_r, mask_dtype):
    """The masks forward of uint8 images, run eagerly and segment by
    segment, equals the per-block forward (``vitseg_head_logits``, whose
    residual adds and LayerNorms are apart, then kernel 5) and
    ``vitseg_predict`` of the images / 255 bit for bit."""
    model = _model(dtype)
    set_token_merge_r(model, merge_r)
    images = torch.randint(0, 256, (3, 32, 32, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    segments = MasksForward(model, (32, 32), mask_dtype)
    assert segments.count == TINY["num_hidden_layers"] + 1
    with torch.inference_mode():
        x = images.float() / 255.0
        want = upsample_argmax(vitseg_head_logits(model, x).contiguous(),
                               (32, 32), out_dtype=mask_dtype)
        predicted = vitseg_predict(model, x, out_size=(32, 32),
                                   mask_dtype=mask_dtype)
        got = segments(images)
        # Segment by segment, with the attention written into a buffer
        # the next segment reads, as the runner's graphs run it.
        outputs = segments.segment(0, (images,))
        for i in range(1, segments.count):
            q = outputs[1][0]
            attn = torch.full(q.shape, float("nan"), dtype=q.dtype)
            assert segments.attention(outputs, out=attn) is attn
            outputs = segments.segment(i, outputs + (attn,))
        stepped = segments.epilogue(outputs)
    assert len(torch.unique(want)) > 1
    assert got.dtype == stepped.dtype == mask_dtype
    assert torch.equal(got, want) and torch.equal(stepped, want)
    assert torch.equal(predicted, want)


@pytest.mark.parametrize("dropout", [False, True])
def test_encoder_layer_is_its_two_halves(dropout):
    model = _model(hidden_dropout_prob=0.1 if dropout else 0.0,
                   attention_probs_dropout_prob=0.1 if dropout else 0.0)
    cfg, layer = model.backbone.cfg, model.backbone.layers[0]
    x = torch.randn(2, 17, 64, generator=torch.Generator().manual_seed(2))
    kwargs = dict(deterministic=not dropout)
    gens = [torch.Generator().manual_seed(3) if dropout else None
            for _ in range(2)]
    want = encoder_layer(layer, x, cfg, attn_impl="eager",
                         generator=gens[0], **kwargs)
    qkv = encoder_layer_qkv(layer, x, cfg)
    attn = block_attention(qkv, cfg, attn_impl="eager", generator=gens[1],
                           **kwargs)
    got = encoder_layer_out(layer, x, attn, cfg, generator=gens[1],
                            **kwargs)
    assert torch.equal(got, want)
    if dropout:
        assert not torch.equal(got, encoder_layer(
            layer, x, cfg, attn_impl="eager"))
        assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.parametrize("fake", [False, True])
def test_flash_attention_out_overload(fake):
    shape = (2, 3, 17, 16)
    if fake:
        with FakeTensorMode():
            q, out = torch.empty(shape), torch.empty(shape)
            got = torch.ops.vt.flash_attention_fwd.out(q, q, q, out=out)
            assert got is out and got.shape == shape
            with pytest.raises(ValueError, match="out must be"):
                torch.ops.vt.flash_attention_fwd.out(
                    q, q, q, out=torch.empty(2, 3, 16, 16))
        return
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(shape, generator=gen) for _ in range(3))
    out = torch.zeros(shape)
    got = flash_attention(q, k, v, out=out)
    assert got is out
    assert torch.equal(out, torch.ops.vt.flash_attention_fwd(q, k, v))
    with pytest.raises(ValueError, match="out must be"):
        flash_attention(q, k, v, out=torch.zeros(shape, dtype=torch.float64))
    with pytest.raises(ValueError, match="inference kernel only"):
        flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=1, out=out)


class _TinyEntry:
    def vit_config(self, **overrides):
        return tcfg.ViTConfig(**{**TINY, **overrides})


def test_a_cpu_runner_captures_nothing(monkeypatch):
    monkeypatch.setattr(port_registry, "sweep_by_name",
                        lambda name: _TinyEntry())
    spans.reset()
    runner = ModelRunner({"input_size": 32, "config_name": "tiny",
                          "num_classes": 5}, compute_dtype="float32",
                         device="cpu", buckets=(1, 4))
    runner.warmup()
    images = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                               np.uint8)
    masks = runner.predict(images)
    with torch.inference_mode():
        want = vitseg_predict(runner.model,
                              torch.from_numpy(images).float() / 255.0,
                              out_size=(32, 32), mask_dtype=torch.uint8)
    counters = spans.counters()
    spans.reset()
    assert not runner.graphed and runner._graphs == {}
    assert counters["serve.batches"] == 3
    assert counters.get("serve.graph_captures", 0) == 0
    assert counters.get("serve.graphed_batches", 0) == 0
    assert np.array_equal(masks, want.numpy())
