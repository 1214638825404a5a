"""PyTorch port vs the JAX package: the evaluation sweep and the crack path.

``evaluate_model`` of both packages on the same weights and dataset (17
CE classes, and the binary crack model), the sweep's per-image metrics and
its scatter rules, ``run_sweep`` restoring a checkpoint that ``Trainer.fit``
wrote, and the commands ``synth``, ``train --task paed_binary`` and
``eval-sweep`` on the CPU (``--device cpu``).
"""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.evaluation import evaluate as jevaluate
from visiontransformer_tpu.metrics import segmentation as jmetrics
from visiontransformer_tpu.models.vitseg import vitseg_init
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.ckpt.convert import load_jax_params
from visiontransformer_tpu_torch.cli import main as cli_main
from visiontransformer_tpu_torch.data import (
    CESegmentationDataset,
    PAEDBinaryDataset,
)
from visiontransformer_tpu_torch.data.synthetic import (
    generate_binary,
    generate_multiclass,
)
from visiontransformer_tpu_torch.evaluation import evaluate as tevaluate
from visiontransformer_tpu_torch.metrics import segmentation as tmetrics
from visiontransformer_tpu_torch.models.vitseg import ViTSeg, vitseg_apply
from visiontransformer_tpu_torch.train.trainer import Trainer

# tests/test_evaluation.py's TINY sweep row: P16H64A4 at 32².
TINY = dict(image_size=32, patch_size=16, hidden_size=64, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=64)
ENTRY = dict(id=0, patch_size=16, hidden_size=64, hidden_layers=1,
             attention_heads=4)
# A prediction may flip between the packages only on a logit tie: the
# binary logit within this of 0, or the top two CE logits within it.
TIE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    ce_root = str(tmp_path_factory.mktemp("ce"))
    generate_multiclass(ce_root, n_samples=6, image_size=64)
    crack_root = str(tmp_path_factory.mktemp("cracks"))
    generate_binary(crack_root, n_samples=6, image_size=40)
    return {
        "ce": CESegmentationDataset(f"{ce_root}/image_png",
                                    f"{ce_root}/mask_png", image_size=32,
                                    mask_size=48, cache=True),
        "binary": PAEDBinaryDataset(f"{crack_root}/image_png",
                                    f"{crack_root}/mask_png", image_size=32,
                                    cache=True)}


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


# ------------------------------------------------------------------ metrics
@pytest.mark.parametrize("case", ["random", "perfect", "absent_classes"])
def test_sweep_metrics_match_per_image(rng, case):
    gt = rng.integers(0, 6, (3, 20, 20)).astype(np.int32)
    pred = {"random": rng.integers(0, 6, gt.shape).astype(np.int32),
            "perfect": gt,
            "absent_classes": np.minimum(gt, 1)}[case]
    got = tmetrics.per_image_eval_metrics(_t(gt), _t(pred), 9)
    for i in range(3):
        want = jmetrics.per_image_eval_metrics(jnp.asarray(gt[i]),
                                               jnp.asarray(pred[i]), 9)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g[i]), float(w), rtol=1e-6)
        for name in ("per_class_iou", "per_class_dice"):
            g = getattr(tmetrics, name)(_t(gt[i]), _t(pred[i]), 9).numpy()
            w = np.asarray(getattr(jmetrics, name)(
                jnp.asarray(gt[i]), jnp.asarray(pred[i]), 9))
            # NaN where JAX gives NaN (classes 6-8 never occur).
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g, w, rtol=1e-6)


def test_confusion_and_presence_follow_jax_scatter_rules(rng):
    # Out-of-range classes: JAX's .at[] scatter counts a negative index from
    # the end and drops one still out of range; bincount would grow the
    # output or raise instead.
    gt = rng.integers(0, 4, (2, 6, 6)).astype(np.int32)
    pred = rng.integers(0, 4, (2, 6, 6)).astype(np.int32)
    gt[0, 0, :4] = [4, 7, -1, -3]
    gt[1, 1, :2] = [-5, 100]
    got = tmetrics.pixel_confusion_matrix(_t(gt), _t(pred), 4)
    want = jmetrics.pixel_confusion_matrix(jnp.asarray(gt),
                                           jnp.asarray(pred), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    presence = tevaluate.class_presence(_t(gt), 4).numpy()
    for i in range(2):
        want = np.asarray(jnp.zeros(4, bool).at[gt[i].reshape(-1)].set(True))
        np.testing.assert_array_equal(presence[i], want)
    assert int(got.sum()) < gt.size  # some pixels were dropped


# -------------------------------------------------------------- the sweep
def _sweep_setup(kind, datasets):
    binary = kind == "binary"
    classes = 1 if binary else 17
    jcfg_ = jcfg.ViTSegConfig(vit=jcfg.ViTConfig(**TINY), num_classes=classes)
    tcfg_ = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**TINY), num_classes=classes)
    params = jax.tree_util.tree_map(np.asarray,
                                    vitseg_init(jax.random.PRNGKey(3), jcfg_))
    model = load_jax_params(ViTSeg(tcfg_), params).eval()
    return jcfg_, tcfg_, params, model, datasets[kind]


@pytest.mark.parametrize("kind", ["ce", "binary"])
def test_evaluate_model_matches_jax(tmp_path, datasets, kind):
    jcfg_, tcfg_, params, model, ds = _sweep_setup(kind, datasets)
    jpath = jevaluate.evaluate_model(
        params, jcfg_, jcfg.SweepEntry(**ENTRY), ds,
        output_dir=str(tmp_path / "jax"), batch_size=4, num_batches=2)
    path = tevaluate.evaluate_model(
        model, tcfg_, tcfg.SweepEntry(**ENTRY), ds,
        output_dir=str(tmp_path / "port"), batch_size=4, num_batches=2)
    assert os.path.basename(path) == "P16H64A4_metrics.csv"

    # Predictions of both packages' batch functions; a flip must sit on a
    # logit tie, and the rows of images without one must agree.
    eval_batch = tevaluate._make_eval_fn(tcfg_)
    jeval_batch = jevaluate._make_eval_fn(jcfg_)
    flipped = []
    for start in (0, 4):
        idx = range(start, min(start + 4, len(ds)))
        images = np.stack([ds[i][0] for i in idx])
        masks = np.stack([ds[i][1] for i in idx])
        preds = eval_batch(model, _t(images), _t(masks))[0].numpy()
        jpreds = np.asarray(jeval_batch(params, jnp.asarray(images),
                                        jnp.asarray(masks))[0])
        differ = preds != jpreds
        if differ.any():
            with torch.no_grad():
                logits = vitseg_apply(model, _t(images)).numpy()[differ]
            gap = (np.abs(logits[:, 0]) if kind == "binary" else
                   -np.diff(np.sort(logits, axis=-1)[:, -2:], axis=-1)[:, 0])
            assert (gap < TIE).all(), gap.max()
        flipped += differ.reshape(len(idx), -1).sum(1).tolist()
    assert sum(flipped) <= 4, flipped  # counted: ties are rare

    rows, jrows = _rows(path), _rows(jpath)
    assert rows[0] == jrows[0] == tevaluate.CSV_HEADER == jevaluate.CSV_HEADER
    assert len(rows) == len(jrows) == 1 + len(ds)
    time_col = tevaluate.CSV_HEADER.index("Inference_Time")
    floats = [tevaluate.CSV_HEADER.index(c)
              for c in ("Accuracy", "Mean_IoU", "Mean_Dice")]
    for row, jrow, flips in zip(rows[1:], jrows[1:], flipped):
        assert float(row[time_col]) > 0
        if flips:
            continue
        for col, (a, b) in enumerate(zip(row, jrow)):
            if col in floats:
                np.testing.assert_allclose(float(a), float(b), atol=1e-6)
            elif col != time_col:
                assert a == b, (tevaluate.CSV_HEADER[col], a, b)
    name = "P16H64A4_pixel_confusion.npy"
    confusion = np.load(tmp_path / "port" / "P16H64A4" / name)
    jconfusion = np.load(tmp_path / "jax" / "P16H64A4" / name)
    assert confusion.shape == ((2, 2) if kind == "binary" else (17, 17))
    assert confusion.sum() == len(ds) * 32 * 32
    assert np.abs(confusion - jconfusion).sum() <= 2 * sum(flipped)
    if not sum(flipped):
        np.testing.assert_array_equal(confusion, jconfusion)


def test_evaluate_model_writes_the_panels_jax_writes(tmp_path, datasets):
    """save_visualizations: the same 5-panel PNGs, with the class names
    and colours, as the JAX package's evaluate_model on the same weights
    (decoded pixels equal where the predictions are)."""
    from PIL import Image

    jcfg_, tcfg_, params, model, ds = _sweep_setup("ce", datasets)
    names = [f"class {i}" for i in range(17)]
    colours = {(15 * i, 255 - 11 * i, (53 * i) % 256): i for i in range(17)}
    kwargs = dict(batch_size=4, num_batches=2, save_visualizations=True,
                  class_names=names, rgb_to_class=colours)
    jevaluate.evaluate_model(params, jcfg_, jcfg.SweepEntry(**ENTRY), ds,
                             output_dir=str(tmp_path / "jax"), **kwargs)
    tevaluate.evaluate_model(model, tcfg_, tcfg.SweepEntry(**ENTRY), ds,
                             output_dir=str(tmp_path / "port"), **kwargs)
    pngs = sorted(f for f in os.listdir(tmp_path / "port" / "P16H64A4")
                  if f.endswith(".png"))
    assert pngs == sorted(f for f in os.listdir(tmp_path / "jax" / "P16H64A4")
                          if f.endswith(".png"))
    assert pngs == sorted(f"result_batch{b}_img{i}.png" for b, n in
                          ((0, 4), (1, len(ds) - 4)) for i in range(n))
    eval_batch = tevaluate._make_eval_fn(tcfg_)
    jeval_batch = jevaluate._make_eval_fn(jcfg_)
    compared = 0
    for b, start in enumerate((0, 4)):
        idx = range(start, min(start + 4, len(ds)))
        images = np.stack([ds[i][0] for i in idx])
        masks = np.stack([ds[i][1] for i in idx])
        preds = eval_batch(model, _t(images), _t(masks))[0].numpy()
        jpreds = np.asarray(jeval_batch(params, jnp.asarray(images),
                                        jnp.asarray(masks))[0])
        for i in range(len(idx)):
            if not np.array_equal(preds[i], jpreds[i]):
                continue  # a tie (test_evaluate_model_matches_jax)
            name = f"P16H64A4/result_batch{b}_img{i}.png"
            got = np.asarray(Image.open(tmp_path / "port" / name))
            want = np.asarray(Image.open(tmp_path / "jax" / name))
            np.testing.assert_array_equal(got, want)
            compared += 1
    assert compared >= len(ds) - 1


def test_run_sweep_restores_a_checkpoint_written_by_fit(tmp_path, datasets):
    ds = datasets["binary"]
    entry = tcfg.SweepEntry(**ENTRY)
    cfg = entry.seg_config(num_classes=1, compute_dtype="float32")
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit,
                                                           image_size=32))
    trainer = Trainer(cfg, tcfg.TrainConfig(
        batch_size=2, accumulate_grad_batches=1, max_epochs=2,
        optimizer="adamw", learning_rate=1e-3, early_stopping_monitor=None),
        task="paed_binary", device="cpu")
    root = tmp_path / "ckpts"
    state = trainer.fit(ds, checkpoint_dir=str(root / entry.name))
    assert sorted(os.listdir(root / entry.name)) == [
        "epoch=0-step=3", "epoch=1-step=6"]
    sweep = dict(output_dir=str(tmp_path / "out"), num_classes=1,
                 entries=[entry], batch_size=4, num_batches=2,
                 compute_dtype="float32", image_size=32, device="cpu")
    (path,) = tevaluate.run_sweep(ds, checkpoint_root=str(root), **sweep)
    trained = tevaluate.evaluate_model(
        state.model.eval(), cfg, entry, ds,
        output_dir=str(tmp_path / "trained"), batch_size=4, num_batches=2)
    time_col = tevaluate.CSV_HEADER.index("Inference_Time")

    def cells(p):
        return [r[:time_col] + r[time_col + 1:] for r in _rows(p)]

    assert cells(path) == cells(trained)
    model = dict(num_classes=1, compute_dtype="float32", image_size=32,
                 device="cpu")
    restored = tevaluate.sweep_model(entry, checkpoint_root=str(root),
                                     **model)[1].state_dict()
    seeded = tevaluate.sweep_model(entry, **model)[1].state_dict()
    for name, p in state.model.state_dict().items():
        torch.testing.assert_close(restored[name], p, atol=0, rtol=0)
    assert not torch.equal(seeded["head_conv2.kernel"],
                           restored["head_conv2.kernel"])


# ---------------------------------------------------------------- commands
def test_crack_path_commands_on_cpu(tmp_path):
    # synth --kind binary -> train --task paed_binary -> eval-sweep
    # --task paed_binary --ckpt-root, as a user runs them, on the CPU.
    data, ckpts, out = (str(tmp_path / d) for d in ("data", "ckpts", "out"))
    assert cli_main(["synth", "--kind", "binary", "--out", data, "--n", "4",
                     "--size", "40"]) == 0
    assert len(os.listdir(os.path.join(data, "mask_png"))) == 4
    assert cli_main(["train", "--data", data, "--task", "paed_binary",
                     "--config", "P16H512A8", "--image-size", "32",
                     "--batch-size", "2", "--accumulate", "2",
                     "--max-epochs", "1", "--no-split",
                     "--logs", str(tmp_path / "logs"),
                     "--ckpt-dir", os.path.join(ckpts, "P16H512A8"),
                     "--device", "cpu"]) == 0
    fields = _rows(next((tmp_path / "logs").glob(
        "*/version_0/metrics.csv")))[0]
    assert {"train_loss", "val_loss", "val_IoU"} <= set(fields)
    assert cli_main(["eval-sweep", "--data", data, "--task", "paed_binary",
                     "--ckpt-root", ckpts, "--configs", "P16H512A8",
                     "--image-size", "32", "--batch-size", "2",
                     "--num-batches", "1", "--no-split", "--out", out,
                     "--device", "cpu"]) == 0
    rows = _rows(os.path.join(out, "P16H512A8", "P16H512A8_metrics.csv"))
    assert rows[0] == tevaluate.CSV_HEADER and len(rows) == 3
    confusion = np.load(os.path.join(out, "P16H512A8",
                                     "P16H512A8_pixel_confusion.npy"))
    assert confusion.shape == (2, 2) and confusion.sum() == 2 * 32 * 32


def test_ce_eval_sweep_command_on_cpu(tmp_path):
    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    assert cli_main(["synth", "--out", data, "--n", "3", "--size", "48"]) == 0
    assert cli_main(["eval-sweep", "--data", data, "--configs",
                     "P16H512A8,P16H768A12", "--image-size", "32",
                     "--batch-size", "2", "--num-batches", "1", "--no-split",
                     "--out", out, "--device", "cpu"]) == 0
    for name in ("P16H512A8", "P16H768A12"):
        rows = _rows(os.path.join(out, name, f"{name}_metrics.csv"))
        assert rows[0] == tevaluate.CSV_HEADER and len(rows) == 3
        assert all(r[1] == name for r in rows[1:])


def test_eval_sweep_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    data = str(tmp_path / "data")
    generate_binary(data, n_samples=2, image_size=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["eval-sweep", "--data", data, "--task", "paed_binary",
                  "--configs", "P16H512A8", "--image-size", "32",
                  "--no-split", "--out", str(tmp_path / "out")])
