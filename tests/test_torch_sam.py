"""SAM (``models/sam.py``) on the CPU at a tiny geometry: the port against
the benchmark's plain reference (``benchmark/reference/sam.py``) on its
seeded weights, the reference against HF's ``SamModel``, kernel 1's biased
attention's plain version against eager attention with the bias
materialised, the runner's box prompts, HF directories through
``resolve_model``, the counters and the refused opt-ins.

The tiny geometry (``benchmark/tests/tiny_sam.py``): width 32, 4 blocks of
which block 2 is global, windows of 4 x 4 on a 6 x 6 grid (96^2 images),
so that windows are zero-padded to 8 x 8 and cut into four; a decoder 32
wide. Kernel 1 itself runs only on the card (``chip_smoke.py``'s
``flash_bias`` phase).
"""

import os

import numpy as np
import pytest
import torch

from benchmark import weights_sam
from benchmark.reference import sam as ref
from benchmark.tests.tiny_sam import SAM_TINY as TINY
from benchmark.tests.tiny_sam import SAM_TINY_GEOMETRY
from benchmark.tests.tiny_sam import SAM_TINY_SIZE as SIZE
from benchmark.tests.tiny_sam import sam_config as tiny_config
from visiontransformer_tpu_torch.models import registry, sam
from visiontransformer_tpu_torch.ops import attention as attn_ops
from visiontransformer_tpu_torch.ops import flash_attention as fa
from visiontransformer_tpu_torch.utils import spans


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(sam.SAM_PRESETS, TINY, SAM_TINY_GEOMETRY)


@pytest.fixture(scope="module")
def tiny():
    """(cfg, weights, HF directory) of the tiny geometry."""
    import tempfile
    cfg = tiny_config()
    w = weights_sam.make_weights(cfg, 2 ** 31 + 7, "cpu")
    tmp = tempfile.TemporaryDirectory()
    path = weights_sam.write_hf_dir(os.path.join(tmp.name, "hf"), cfg, w)
    yield cfg, w, path
    tmp.cleanup()


def prompts(n=3, seed=5):
    gen = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (n, SIZE, SIZE, 3), generator=gen,
                           dtype=torch.uint8)
    boxes = torch.tensor([[10.0, 20.0, 60.0, 90.0], [0.0, 0.0, 96.0, 96.0],
                          [33.0, 5.0, 95.0, 41.0]])[:n]
    return images, boxes


def load(path, **kwargs):
    return registry.resolve_model("sam", TINY, num_classes=2,
                                  input_size=SIZE, compute_dtype="float32",
                                  checkpoint_path=path, device="cpu",
                                  **kwargs)


def test_port_matches_the_reference_and_the_runner_pads(tiny, tiny_preset):
    """The port's fp32 logits at the image's size within 2e-5 of the
    reference's (fp32 sums in other orders over 4 blocks and the decoder,
    measured 1.6e-6; at this width the logits spread about 0.15), and
    the runner's masks, three images with their boxes in a bucket of 4
    (one padded row), equal to the reference's signs: no bit disagrees
    with a reference logit of magnitude above 1e-4."""
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    cfg, w, path = tiny
    _, model = load(path)
    images, boxes = prompts()
    with torch.no_grad():
        got = sam.upscale_logits(sam.sam_mask_logits(
            model, images.float() / 255.0, boxes), (SIZE, SIZE))
        want = ref.mask_logits(w, images, boxes, cfg)
    assert got.shape == want.shape == (3, SIZE, SIZE)
    assert float(want.std()) > 0.1                 # the image matters
    assert 0.05 < float((want > 0).float().mean()) < 0.95  # both signs
    assert float((got - want).abs().max()) < 2e-5
    row = {"model_family": "sam", "config_name": TINY, "num_classes": 2,
           "input_size": SIZE, "checkpoint_path": path}
    runner = ModelRunner(row, compute_dtype="float32", buckets=(4,),
                         device="cpu")
    masks = runner.dispatch(images.numpy(), boxes=boxes.numpy()).resolve()
    assert masks.shape == (3, SIZE, SIZE) and masks.dtype == np.uint8
    assert set(np.unique(masks)) <= {0, 1}
    assert float(ref.mask_gap(want, torch.from_numpy(masks)).max()) < 1e-4


def test_reference_matches_hf_sam_model(tiny, monkeypatch):
    """The reference's low-resolution mask logits equal HF ``SamModel``'s
    (eager attention) on the same tiny weights to fp32 rounding (2e-5 on
    logits of about 0.1 to 1). Where no test has imported ``transformers``
    yet, it is imported without its TensorFlow and Flax halves, which no
    test uses and which take most of its import time."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    cfg, w, _ = tiny
    hf_cfg = transformers.SamConfig(**{
        k: cfg["hf_config"][k] for k in (
            "vision_config", "prompt_encoder_config", "mask_decoder_config")})
    hf_cfg._attn_implementation = "eager"
    hf = transformers.SamModel(hf_cfg).eval()
    state = dict(w, **{"prompt_encoder.shared_embedding.positional_embedding":
                       w["shared_image_embedding.positional_embedding"]})
    hf.load_state_dict(state, strict=True)
    images, boxes = prompts()
    with torch.no_grad():
        out = hf(pixel_values=ref.normalise(images),
                 input_boxes=boxes[:, None], multimask_output=False)
        emb = ref.image_encoder(w, ref.normalise(images), cfg)
        low = ref.predict_mask(w, emb, ref.embed_boxes(w, boxes, SIZE), cfg,
                               ref.identity)
    assert out.pred_masks.shape == (3, 1, 1, 24, 24)
    assert float((out.pred_masks[:, 0, 0] - low).abs().max()) < 2e-5


def test_plain_biased_attention_matches_eager_with_the_bias():
    """Kernel 1's bias instantiations' plain version and the custom op on
    the CPU against eager attention with the (kh x kw) bias materialised
    key by key, as SAM adds it: q (2, 3, 12, 16) against a 3 x 4 key
    grid."""
    gen = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(2, 3, 12, 16, generator=gen) for _ in range(3))
    rel_h = torch.randn(2, 3, 12, 3, generator=gen)
    rel_w = torch.randn(2, 3, 12, 4, generator=gen)
    bias = torch.empty(2, 3, 12, 12)
    for key in range(12):
        bias[..., key] = rel_h[..., key // 4] + rel_w[..., key % 4]
    logits = q @ k.transpose(-1, -2) / 4.0 + bias
    want = torch.softmax(logits, dim=-1) @ v
    plain = fa.flash_attention_bias_plain(q, k, v, rel_h, rel_w)
    assert float((plain - want).abs().max()) < 1e-6
    assert torch.equal(fa.flash_attention_bias(q, k, v, rel_h, rel_w), plain)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        fake = torch.ops.vt.flash_attention_fwd_bias(
            *(mode.from_tensor(t) for t in (q, k, v, rel_h, rel_w)))
    assert fake.shape == q.shape and fake.dtype == q.dtype


def test_bias_kernel_rule_and_the_counters(tiny, tiny_preset):
    """Which calls kernel 1's bias instantiations take (on tensors of a
    card this host lacks, under a FakeTensorMode: bf16, d 64 or 80, kw
    even, no gradient), that a CPU tensor never takes them, and the
    counters of a forward: one core call a block, eager on the CPU under
    "auto", the plain version under "flash" with the same logits."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def inputs(d=80, dtype=torch.bfloat16, kh=14, kw=14, device="cpu"):
        n = kh * kw
        q = torch.zeros(1, 2, n, d, dtype=dtype, device=device)
        return (q, q, torch.zeros(1, 2, n, kh, dtype=dtype, device=device),
                torch.zeros(1, 2, n, kw, dtype=dtype, device=device))

    with FakeTensorMode():
        card = dict(device="cuda")
        assert fa.bias_kernel_takes(*inputs(**card))
        assert fa.bias_kernel_takes(*inputs(d=64, kh=64, kw=64, **card))
        assert not fa.bias_kernel_takes(*inputs(d=32, **card))
        assert not fa.bias_kernel_takes(*inputs(dtype=torch.float32, **card))
        assert not fa.bias_kernel_takes(*inputs(kh=3, kw=5, **card))
        q, k, rel_h, rel_w = inputs(**card)
        rel_h.requires_grad_()
        assert not fa.bias_kernel_takes(q, k, rel_h, rel_w)
        assert attn_ops.biased_attention_path("auto", q, k, rel_h,
                                              rel_w) == "eager"
        with torch.no_grad():
            assert fa.bias_kernel_takes(q, k, rel_h, rel_w)
        assert attn_ops.biased_attention_path("auto",
                                              *inputs(**card)) == "flash"
        assert attn_ops.biased_attention_path(
            "auto", *inputs(d=32, **card)) == "eager"
    assert not fa.bias_kernel_takes(*inputs())      # a CPU tensor
    assert attn_ops.biased_attention_path("auto", *inputs()) == "eager"
    assert attn_ops.biased_attention_path("flash", *inputs()) == "flash"
    _, w, path = tiny
    _, model = load(path)
    images, boxes = prompts(1)
    x = images.float() / 255.0
    spans.reset()
    with torch.no_grad():
        eager = sam.sam_mask_logits(model, x, boxes)
        got = spans.counters()
        flash = sam.sam_mask_logits(model, x, boxes, attn_impl="flash")
    assert got.get("sam.attention_eager") == 4
    assert "sam.attention_flash" not in got
    assert spans.counters()["sam.attention_flash"] == 4
    assert float((eager - flash).abs().max()) < 1e-5


def test_runner_boxes_and_the_other_families_refuse_them(tiny, tiny_preset,
                                                         monkeypatch):
    """No boxes: the whole image's box, for every row; another family
    refuses boxes; a box array of another shape raises; the masks are the
    epilogue's."""
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    _, _, path = tiny
    row = {"model_family": "sam", "config_name": TINY, "num_classes": 2,
           "input_size": SIZE, "checkpoint_path": path}
    runner = ModelRunner(row, compute_dtype="float32", buckets=(2,),
                         device="cpu")
    images, _ = prompts(2)
    whole = np.array([[0, 0, SIZE, SIZE]] * 2, np.float32)
    plain = runner.dispatch(images.numpy()).resolve()
    assert np.array_equal(plain, runner.dispatch(images.numpy(),
                                                 boxes=whole).resolve())
    with torch.no_grad():      # the model called: two-class logits (0, m)
        logits = runner.model(images.float() / 255.0)
    assert logits.shape == (2, SIZE, SIZE, 2)
    assert np.array_equal(logits.argmax(-1).numpy(), plain)
    with pytest.raises(ValueError, match="boxes must be"):
        runner.dispatch(images.numpy(), boxes=whole[:1])
    # The masks come from the epilogue (kernel 5 on a card): one call a
    # batch on the logits (0, m) at 4g x 4g.
    seen = []
    epilogue = sam.upsample_argmax
    monkeypatch.setattr(sam, "upsample_argmax", lambda x, size, **kw: (
        seen.append((tuple(x.shape), tuple(size), kw)) or epilogue(
            x, size, **kw)))
    assert np.array_equal(runner.dispatch(images.numpy()).resolve(), plain)
    assert seen == [((2, 24, 24, 2), (SIZE, SIZE),
                     {"out_dtype": torch.uint8})]
    conv = ModelRunner({"model_family": "unet", "config_name": "small",
                        "num_classes": 3, "input_size": 32},
                       compute_dtype="float32", buckets=(1,), device="cpu")
    assert not conv.prompted
    with pytest.raises(ValueError, match="sam family"):
        conv.dispatch(np.zeros((1, 32, 32, 3), np.uint8),
                      boxes=np.zeros((1, 4), np.float32))


def test_resolve_model_reads_an_hf_sam_directory(tiny, tiny_preset,
                                                 tmp_path):
    """The HF directory's state loads whole (less the unused prompt
    parameters) and its geometry names the preset; an image size other
    than the row's and a geometry that matches no preset raise."""
    import json

    from visiontransformer_tpu_torch.ckpt.hf_dir import read_hf_sam

    cfg, w, path = tiny
    name, scfg, state = read_hf_sam(path, "float32")
    assert name == TINY and scfg.grid == 6 and scfg.global_attn_indexes == (2,)
    assert "prompt_encoder.mask_embed.conv1.weight" in w
    assert not any(k.startswith("prompt_encoder.mask_embed") for k in state)
    got_cfg, model = load(path)
    assert got_cfg == scfg
    got = model.state_dict()
    assert set(got) == set(state)
    assert all(torch.equal(got[k], w[k]) for k in got)
    with pytest.raises(ValueError, match="input_size"):
        registry.resolve_model("sam", TINY, num_classes=2, input_size=64,
                               checkpoint_path=path, device="cpu")
    other = tmp_path / "other"
    other.mkdir()
    config = json.load(open(os.path.join(path, "config.json")))
    config["vision_config"]["num_hidden_layers"] = 5
    json.dump(config, open(other / "config.json", "w"))
    with pytest.raises(ValueError, match="matches no SAM preset"):
        read_hf_sam(str(other))


def test_presets_and_the_refused_opt_ins(tiny, tiny_preset, tmp_path):
    """HF's three geometries (SAM-H: 636 M encoder parameters, d = 80, 28
    windowed and 4 global blocks), built without storage; the int8 and
    ToMe opt-ins refuse sam, and training does."""
    from visiontransformer_tpu_torch.serve.store import JobStore
    from visiontransformer_tpu_torch.serve.worker import ModelRunner
    from visiontransformer_tpu_torch.train.trainer import Trainer

    h = sam.sam_config("sam_vit_h")
    assert (h.hidden_size, h.head_dim, h.grid, h.mlp_dim) == (1280, 80, 64,
                                                              5120)
    with torch.device("meta"):
        model = sam.SamSeg(h)
    layers = model.vision_encoder.layers
    assert [i for i, layer in enumerate(layers) if not layer.window_size] \
        == [7, 15, 23, 31]
    assert sum(layer.window_size == 14 for layer in layers) == 28
    encoder = sum(p.numel() for p in model.vision_encoder.parameters())
    assert encoder == 637_026_048
    assert sam.sam_config("sam_vit_b").head_dim == 64
    assert sam.sam_config("sam_vit_l").head_dim == 64
    _, _, path = tiny
    _, tiny_model = load(path)
    with pytest.raises(ValueError, match="int8"):
        registry.quantize_int8_(tiny_model)
    row = {"model_family": "sam", "config_name": TINY, "num_classes": 2,
           "input_size": SIZE, "checkpoint_path": path, "quantize": "int8"}
    with pytest.raises(ValueError, match="opt-in"):
        ModelRunner(row, compute_dtype="float32", buckets=(1,), device="cpu")
    store = JobStore(str(tmp_path / "serving.db"),
                     media_root=str(tmp_path / "media"))
    with pytest.raises(ValueError, match="int8"):
        store.register_model("s", num_classes=2, config_name="sam_vit_h",
                             model_family="sam", quantize="int8")
    with pytest.raises(ValueError, match="token_merge_r"):
        store.register_model("s", num_classes=2, config_name="sam_vit_h",
                             model_family="sam", token_merge_r=8)
    with pytest.raises(ValueError, match="served"):
        Trainer(h, None, model="sam", device="cpu")
