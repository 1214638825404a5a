"""The plain references against the port's eager path on the CPU, at a
tiny size. The references import nothing of the port; these tests bring
the two together."""

import numpy as np
import pytest
import torch

from benchmark.reference import vitseg as ref
from benchmark.tests import tiny
from benchmark.weights import make_weights, vitseg_spec


def _port_model(cfg, weights, dtype="float32"):
    from visiontransformer_tpu_torch.models.vitseg import ViTSeg
    import dataclasses
    seg = dataclasses.replace(tiny.port_config(cfg), compute_dtype=dtype)
    model = ViTSeg(seg)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def test_weight_names_are_the_ports_state_dict():
    from visiontransformer_tpu_torch.models.vitseg import ViTSeg
    cfg = tiny.config()
    want = {k: tuple(v.shape) for k, v in ViTSeg(
        tiny.port_config(cfg)).state_dict().items()}
    assert {n: s for n, s, _ in vitseg_spec(cfg)} == want


def test_weights_are_seeded_and_bf16():
    cfg = tiny.config()
    a = make_weights(cfg, 2 ** 31 + 5, torch.device("cpu"))
    b = make_weights(cfg, 2 ** 31 + 5, torch.device("cpu"))
    c = make_weights(cfg, 2 ** 31 + 6, torch.device("cpu"))
    assert all(v.dtype == torch.bfloat16 for v in a.values())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head_conv1.kernel"], c["head_conv1.kernel"])


@pytest.mark.parametrize("config", ["vitseg_b16", "vitseg_p4"])
def test_forward_matches_port_eager_fp32(config):
    from visiontransformer_tpu_torch.models.vitseg import vitseg_apply
    cfg = tiny.config(config)
    w = make_weights(cfg, 11, torch.device("cpu"))
    images = torch.rand((3, 32, 32, 3), generator=torch.Generator()
                        .manual_seed(0))
    with torch.no_grad():
        want = vitseg_apply(_port_model(cfg, w), images, attn_impl="eager")
        got = ref.logits(ref.as_float32(w), images, cfg)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 2e-5


def test_gap_is_zero_on_own_argmax_and_positive_when_altered():
    cfg = tiny.config()
    w = ref.as_float32(make_weights(cfg, 3, torch.device("cpu")))
    images = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits = ref.logits(w, images.float() / 255.0, cfg)
    masks = torch.argmax(logits, -1).to(torch.uint8)
    assert float(ref.served_gaps(w, images, masks, cfg).max()) == 0.0
    masks[1, :4, :4] = (masks[1, :4, :4] + 1) % cfg["num_classes"]
    gaps = ref.served_gaps(w, images, masks, cfg)
    assert float(gaps[0]) == 0.0 and float(gaps[1]) > 0.0


def test_control_rounds_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(2))
    bf16 = (x.to(torch.bfloat16).float() - x).abs().max()
    fp8 = (ref.fp8_e4m3(x) - x).abs().max()
    assert float(fp8) > 4 * float(bf16)


def test_bilinear_matches_port():
    from visiontransformer_tpu_torch.ops.resize import bilinear_matrix
    for out, inp in [(224, 14), (224, 56), (512, 14), (7, 3)]:
        assert np.array_equal(ref.bilinear_matrix(out, inp),
                              bilinear_matrix(out, inp))
