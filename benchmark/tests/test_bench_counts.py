"""The yardstick's arithmetic against counts worked by hand."""

import pytest

from benchmark import counts, harness


def _by_hand(patch: int, n_layers: int = 12) -> float:
    """ViT at 224 with hidden 768, MLP 3072, the conv head to 17 classes,
    its multiply-adds counted one product at a time."""
    d, m, c_head, classes = 768, 3072, 256, 17
    g = 224 // patch
    p = g * g
    n = p + 1
    embed = p * (patch * patch * 3) * d
    qkv = n * d * 3 * d
    scores = n * n * d          # all heads: H * n * n * (d / H)
    pv = n * n * d
    out = n * d * d
    mlp = n * d * m + n * m * d
    head = p * 9 * d * c_head + p * c_head * classes
    return 2.0 * (embed + n_layers * (qkv + scores + pv + out + mlp) + head)


@pytest.mark.parametrize("config,patch,gflop", [("vitseg_b16", 16, 35.8),
                                                 ("vitseg_p4", 4, 907.0)])
def test_forward_flops_match_hand_counts(config, patch, gflop):
    cfg = harness.load_config(config)
    got = counts.vitseg_forward_flops(cfg)
    assert got == _by_hand(patch)
    assert got / 1e9 == pytest.approx(gflop, rel=0.005)


def test_attention_share_of_p4_forward():
    """At 3137 tokens about 40 % of the forward's operations are
    attention's Q.K^T and P.V."""
    n, d = 3137, 768
    attention = 12 * 2 * 2 * n * n * d
    share = attention / counts.vitseg_forward_flops(
        harness.load_config("vitseg_p4"))
    assert 0.38 < share < 0.42


def test_attention_bound_at_384_197_64():
    """PERF.md's kernel table: (384, 197, 64) bf16 is bound by its bytes
    at 0.0116 ms; its operations would take 0.00386 ms."""
    peaks = counts.PEAKS["sxm"]
    n_bytes, n_ops = counts.attention_fwd_counts(384, 197, 64)
    assert n_bytes == 4 * 384 * 197 * 64 * 2
    assert n_ops == 4 * 384 * 197 * 197 * 64
    least = counts.least_seconds(peaks, n_bytes, n_ops, "bf16")
    assert least * 1e3 == pytest.approx(0.0116, abs=5e-5)
    assert n_ops / peaks["bf16"] * 1e3 == pytest.approx(0.00386, abs=5e-5)


def test_epilogue_counts_at_the_serving_shape():
    """(32, 14, 14, 17) bf16 logits to 224² uint8 masks: bound by its
    operations (1.71 us at the fp32 peak), as chip_smoke.py counts them."""
    n_bytes, n_ops = counts.upsample_argmax_counts(32, 14, 14, 17, 224, 224)
    assert n_bytes == 32 * 14 * 14 * 17 * 2 + 32 * 224 * 224 + 2 * 224 * 16
    assert n_ops == 3 * 32 * 224 * 14 * 17 + 4 * 32 * 224 * 224 * 17
    peaks = counts.PEAKS["sxm"]
    least = counts.least_seconds(peaks, n_bytes, n_ops, "fp32")
    assert least == n_ops / peaks["fp32"]
    assert least * 1e6 == pytest.approx(1.71, abs=0.01)


def test_peaks_by_card_name():
    assert counts.peaks_for("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    assert counts.peaks_for("NVIDIA H100 PCIe")["bytes"] == 2.0e12
