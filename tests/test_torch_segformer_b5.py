"""Kernel 1 with a key count of its own, MiT's attention through the
dispatch, and SegFormer-B5 whole on the port's serving path, on the CPU.

- ``flash_attention`` and ``vt::flash_attention_fwd`` (its CPU and fake
  implementations, the ``out`` overload) at Nq ≠ Nk equal the plain
  math; a gradient or dropout at Nq ≠ Nk raises instead of reaching the
  training kernels;
- MiT with ``attn_impl="flash"`` equals its eager order at fp32; the
  counters say which path served, and a step that needs a gradient stays
  eager;
- the ``mit_b5`` preset whole at 64² (B5's geometry, 2 x 2 keys at stage
  1) from an HF ``save_pretrained`` directory written from the
  benchmark's seeded weights, through ``segformer_apply`` and through a
  ``ModelRunner`` row, against the plain reference
  (``benchmark/reference/segformer.py``);
- the ranges ``mit.attention.<stage>``, ``mit.reduce``, ``mit.ffn`` and
  ``segformer.decode`` in a profile of CPU forwards, and their counters in
  the admin capture's ``spans.json``.
"""

import json
import math

import pytest
import torch

from benchmark import weights_segformer
from benchmark.reference import segformer as ref
from visiontransformer_tpu_torch.models import mit as tmit
from visiontransformer_tpu_torch.models.registry import resolve_model
from visiontransformer_tpu_torch.ops.attention import (
    multi_head_attention,
    resolve_implementation,
)
from visiontransformer_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from visiontransformer_tpu_torch.serve.server import ServingApp
from visiontransformer_tpu_torch.serve.store import JobStore
from visiontransformer_tpu_torch.serve.worker import ModelRunner
from visiontransformer_tpu_torch.utils import spans

B5_CONFIG = "benchmark/configs/segformer_b5_1024.json"
# (B, H, Nq, Nk, d): B5's stage shapes at 64², a partial key tile (49, the
# 224² stage-1 count), more keys than queries.
SHAPES = [(2, 1, 256, 4, 64), (1, 5, 16, 4, 64), (2, 2, 70, 49, 32),
          (1, 2, 3, 65, 16)]


def _math(q, k, v):
    """softmax(q·kᵀ/√d)·v in float64."""
    q, k, v = (t.double() for t in (q, k, v))
    p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), -1)
    return p @ v


def _qkv(b, h, nq, nk, d, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, h, nq, d, generator=g).to(dtype),
            torch.randn(b, h, nk, d, generator=g).to(dtype),
            torch.randn(b, h, nk, d, generator=g).to(dtype))


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel1_takes_a_key_count_of_its_own(shape):
    q, k, v = _qkv(*shape)
    want = _math(q, k, v)
    for got in (flash_attention(q, k, v),
                torch.ops.vt.flash_attention_fwd(q, k, v),
                multi_head_attention(q, k, v, implementation="flash")):
        assert got.shape == q.shape and got.dtype == q.dtype
        assert torch.allclose(got.double(), want, atol=1e-5)
    out = torch.empty_like(q)
    assert torch.ops.vt.flash_attention_fwd.out(q, k, v, out=out) is out
    assert torch.equal(out, flash_attention_plain(q, k, v))


def test_fake_kernel1_keeps_q_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q, k, v = (torch.empty(2, 1, 256, 64), torch.empty(2, 1, 4, 64),
                   torch.empty(2, 1, 4, 64))
        assert torch.ops.vt.flash_attention_fwd(q, k, v).shape == q.shape


@pytest.mark.parametrize("ask", ["gradient", "dropout"])
def test_key_count_of_its_own_refuses_the_training_kernels(ask):
    q, k, v = _qkv(1, 2, 64, 16, 32)
    kwargs = {}
    if ask == "gradient":
        q.requires_grad_(True)
    else:
        kwargs = dict(dropout_rate=0.1, dropout_seed=3)
    with pytest.raises(ValueError, match="inference kernel"):
        flash_attention(q, k, v, **kwargs)


def test_unknown_implementation_raises():
    q = torch.zeros(1, 1, 1, 16)
    assert resolve_implementation("auto", q) == "eager"
    assert resolve_implementation("flash", q) == "flash"
    with pytest.raises(ValueError, match="unknown attention"):
        resolve_implementation("sdpa", q)


@pytest.fixture(autouse=True)
def _fresh_spans():
    spans.reset()
    yield
    spans.reset()


def test_mit_flash_equals_its_eager_order_at_fp32():
    params = tmit.mit_encoder_init(torch.Generator().manual_seed(0),
                                   "mit_b0")
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        eager = tmit.mit_encoder_apply(params, x, "mit_b0", "eager")
        assert spans.counters() == {"mit.attention_eager": 8}
        auto = tmit.mit_encoder_apply(params, x, "mit_b0")  # CPU: eager
        flash = tmit.mit_encoder_apply(params, x, "mit_b0", "flash")
    assert spans.counters() == {"mit.attention_eager": 16,
                                "mit.attention_flash": 8}
    for e, a, f in zip(eager, auto, flash):
        assert torch.equal(e, a)
        assert float((e - f).abs().max()) < 1e-5
    # A step that needs a gradient keeps the eager order, whatever asked.
    spans.reset()
    tree = tmit.mit_encoder_init(torch.Generator().manual_seed(0), "mit_b0")
    leaf = tree["stages"][0]["blocks"][0]["attn"]["q"]["kernel"]
    leaf.requires_grad_(True)
    out = tmit.mit_encoder_apply(tree, x, "mit_b0", "flash")
    assert spans.counters()["mit.attention_eager"] == 8
    assert "mit.attention_flash" not in spans.counters()
    out[0].sum().backward()
    assert leaf.grad is not None


@pytest.fixture(scope="module")
def b5_dir(tmp_path_factory):
    """An HF directory of the mit_b5 preset (B5's config, 19 labels) with
    the benchmark's seeded weights; the weights too."""
    with open(B5_CONFIG) as f:
        cfg = json.load(f)
    cfg["crop_size"] = 64
    w = weights_segformer.make_weights(cfg, 2 ** 31 + 5, "cpu")
    path = weights_segformer.write_hf_dir(
        str(tmp_path_factory.mktemp("b5") / "hf"), cfg, w)
    return cfg, w, path


# fp32 port against the fp32 reference: the same products in other
# orders (oneDNN's convs, the port's gather-form resizes and folded
# BatchNorm) through 52 blocks; the logits are ~0.1 and the differences
# ~1e-6, so 1e-4 leaves room and a wrong layer (~1e-2) still fails.
B5_LOGITS_ATOL = 1e-4


def test_segformer_b5_whole_against_the_reference(b5_dir):
    cfg, w, path = b5_dir
    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(11))
    want = ref.logits(w, images, cfg)
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > B5_LOGITS_ATOL

    _, model = resolve_model("segformer", "mit_b5", num_classes=19,
                             input_size=64, compute_dtype="float32",
                             checkpoint_path=path, device="cpu")
    assert model.cfg.encoder_name == "mit_b5"
    assert model.cfg.embed_channels == 768 and model.cfg.num_classes == 19
    with torch.no_grad():
        got = model(images.float() / 255.0, attn_impl="flash")
    assert spans.counters()["mit.attention_flash"] == 52
    assert float((got - want).abs().max()) < B5_LOGITS_ATOL
    assert torch.equal(got.argmax(-1)[clear], want.argmax(-1)[clear])

    runner = ModelRunner({"model_family": "segformer",
                          "config_name": "mit_b5", "num_classes": 19,
                          "input_size": 64, "checkpoint_path": path},
                         compute_dtype="float32", buckets=(2,),
                         device="cpu")
    masks = torch.from_numpy(runner.predict(images.numpy()))
    assert masks.dtype == torch.uint8 and masks.shape == (2, 64, 64)
    assert torch.equal(masks[clear].long(), want.argmax(-1)[clear])
    assert float(ref.served_gaps(w, images, masks, cfg).max()) \
        < B5_LOGITS_ATOL


def test_ranges_in_the_trace_and_counters_in_spans_json(tmp_path):
    from visiontransformer_tpu_torch.models.registry import get_model_family
    from visiontransformer_tpu_torch.models.segformer import SegformerConfig

    cfg = SegformerConfig(encoder_name="mit_b0", num_classes=3,
                          embed_channels=32)
    model = get_model_family("segformer").init(
        torch.Generator().manual_seed(0), cfg).eval()
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(x)
        model(x, attn_impl="flash")
    names = [e.name for e in prof.events()]
    for i, calls in enumerate((2, 2, 2, 2), start=1):
        assert names.count(f"mit.attention.{i}") == 2 * calls
    assert names.count("mit.reduce") == 2 * 6  # stages 1-3 reduce
    assert names.count("mit.ffn") == 2 * 8
    assert names.count("segformer.decode") == 2
    # The counters go out in the admin capture's spans.json.
    app = ServingApp(JobStore(":memory:", media_root=str(tmp_path)))
    status, out, _ = app._capture_profile(
        {"seconds": 0.1, "trace_dir": str(tmp_path / "trace")})
    assert status == 200, out
    with open(tmp_path / "trace" / "spans.json") as f:
        counters = json.load(f)["counters"]
    assert counters == {"mit.attention_eager": 8, "mit.attention_flash": 8}
