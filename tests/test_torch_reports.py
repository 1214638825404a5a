"""PyTorch port vs the JAX package: the demo and the reports.

``predict_image`` of both packages on the same weights (the JAX tree
through the weight bridge) and image: at fp32 the mask, its classes and
its detections are equal. The drawing functions (``save_eval_panels``,
``draw_boxes``, ``save_training_curves``, ``render_demo_composite``) fed
the same arrays write files of the same names whose decoded pixels are
equal; ``compare``'s frames over one sweep directory are equal. The
commands ``demo``, ``compare`` and ``doctor --cpu`` run on the CPU.
"""

import csv
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import jax

from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.evaluation import compare as jcompare
from visiontransformer_tpu.evaluation import demo as jdemo
from visiontransformer_tpu.evaluation import visualize as jvisualize
from visiontransformer_tpu.models.vitseg import vitseg_init
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.ckpt.convert import load_jax_params
from visiontransformer_tpu_torch.cli import main as cli_main
from visiontransformer_tpu_torch.evaluation import compare as tcompare
from visiontransformer_tpu_torch.evaluation import demo as tdemo
from visiontransformer_tpu_torch.evaluation import visualize as tvisualize
from visiontransformer_tpu_torch.evaluation.evaluate import CSV_HEADER
from visiontransformer_tpu_torch.models.vitseg import ViTSeg

VIT = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128)
CLASSES = 6
NAMES = [f"class {i}" for i in range(CLASSES)]
COLOURS = {(40 * i, 200 - 30 * i, (97 * i) % 256): i for i in range(CLASSES)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    j = jcfg.ViTSegConfig(vit=jcfg.ViTConfig(**VIT), num_classes=CLASSES)
    t = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**VIT), num_classes=CLASSES)
    params = jax.tree_util.tree_map(np.asarray,
                                    vitseg_init(jax.random.PRNGKey(5), j))
    # Larger head weights: the random model then predicts several classes.
    params["head_conv2"]["kernel"] = params["head_conv2"]["kernel"] * 50
    return j, t, params, load_jax_params(ViTSeg(t), params).eval()


def _pixels(path):
    return np.asarray(Image.open(path))


def _same_png(a, b):
    np.testing.assert_array_equal(_pixels(a), _pixels(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_predict_image_matches_jax(models, seed):
    j, t, params, model = models
    image = np.random.default_rng(seed).random((32, 32, 3), np.float32)
    got = tdemo.predict_image(model, t, image, class_names=NAMES,
                              rgb_to_class=COLOURS)
    want = jdemo.predict_image(params, j, image, class_names=NAMES,
                               rgb_to_class=COLOURS)
    assert got["mask"].dtype == np.int32
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_array_equal(got["mask_rgb"], want["mask_rgb"])
    assert got["classes"] == want["classes"] and len(got["classes"]) > 1
    assert got["detections"] == want["detections"]


def test_load_image_matches_jax(tmp_path):
    path = str(tmp_path / "img.png")
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (50, 70, 3), np.uint8)).save(path)
    np.testing.assert_array_equal(tdemo.load_image(path),
                                  jdemo.load_image(path))


def test_render_demo_composite_and_boxes_match_jax(tmp_path, models):
    j, t, params, model = models
    image = np.random.default_rng(3).random((32, 32, 3), np.float32)
    result = tdemo.predict_image(model, t, image)
    for module, name in ((tdemo, "port.png"), (jdemo, "jax.png")):
        module.render_demo_composite(image, result, str(tmp_path / name),
                                     class_names=NAMES, title="P8H64A4")
    _same_png(tmp_path / "port.png", tmp_path / "jax.png")
    for module, name in ((tvisualize, "port_boxes.png"),
                         (jvisualize, "jax_boxes.png")):
        plt = tvisualize.pyplot()
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.imshow(image)
        table = module.class_color_table(COLOURS, CLASSES)
        module.draw_boxes(ax, result["mask"], table, NAMES)
        fig.savefig(tmp_path / name)
        plt.close(fig)
    _same_png(tmp_path / "port_boxes.png", tmp_path / "jax_boxes.png")


def test_save_eval_panels_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    images = rng.random((2, 32, 32, 3), np.float32)
    gt = rng.integers(0, CLASSES, (2, 48, 48)).astype(np.int32)
    preds = rng.integers(0, CLASSES, (2, 32, 32)).astype(np.int32)
    preds[:, 4:20, 6:12] = 3
    for module, name in ((tvisualize, "port"), (jvisualize, "jax")):
        os.makedirs(tmp_path / name)
        module.save_eval_panels(str(tmp_path / name), "P8H64A4", 7, images,
                                gt, preds, class_names=NAMES,
                                rgb_to_class=COLOURS)
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) == [
        "result_batch7_img0.png", "result_batch7_img1.png"]
    for f in files:
        _same_png(tmp_path / "port" / f, tmp_path / "jax" / f)


def test_save_training_curves_match_jax(tmp_path):
    path = tmp_path / "metrics.csv"
    rng = np.random.default_rng(5)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["epoch", "step", "train_loss", "valid_loss",
                    "valid_iou", "epoch_time_s"])
        for e in range(4):
            w.writerow([e, 2 * e, *rng.random(3), 1.5])
    for module, name in ((tvisualize, "port.png"), (jvisualize, "jax.png")):
        assert module.save_training_curves(str(path), str(tmp_path / name),
                                           "P8H64A4")
    _same_png(tmp_path / "port.png", tmp_path / "jax.png")
    assert not tvisualize.save_training_curves(str(tmp_path / "none.csv"),
                                               str(tmp_path / "x.png"), "x")


def _sweep_dir(root, rng):
    """Two models' metrics CSVs in the sweep's schema, empty class sets
    included."""
    def classes():
        return "|".join(map(str, sorted(set(rng.integers(
            0, 19, rng.integers(0, 4)).tolist()))))

    for name in ("P16H512A8", "P8H768A12"):
        os.makedirs(root / name)
        with open(root / name / f"{name}_metrics.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(CSV_HEADER)
            for i in range(6):
                w.writerow([1, name, 16, 512, 8, 8, i // 4, i % 4,
                            rng.random() * 100, rng.random(),
                            "nan" if i == 2 else rng.random(),
                            rng.random() / 100, classes(), classes(),
                            classes(), classes()])


def test_compare_frames_match_jax(tmp_path):
    _sweep_dir(tmp_path, np.random.default_rng(6))
    pd.testing.assert_frame_equal(tcompare.aggregate_metrics(str(tmp_path)),
                                  jcompare.aggregate_metrics(str(tmp_path)))
    frames = tcompare.load_metrics(str(tmp_path))
    jframes = jcompare.load_metrics(str(tmp_path))
    assert list(frames) == list(jframes) == ["P16H512A8", "P8H768A12"]
    for name, df in frames.items():
        pd.testing.assert_frame_equal(df, jframes[name])
        pd.testing.assert_frame_equal(
            tcompare.class_detection_summary(df),
            jcompare.class_detection_summary(jframes[name]))
        np.testing.assert_array_equal(
            tcompare.class_confusion_matrix(df),
            jcompare.class_confusion_matrix(jframes[name]))
    for module, name in ((tcompare, "port"), (jcompare, "jax")):
        module.plot_summary(str(tmp_path), str(tmp_path / f"{name}.png"))
        module.plot_confusion_matrices(str(tmp_path), str(tmp_path / name),
                                       class_names=[f"c{i}" for i in
                                                    range(17)])
    _same_png(tmp_path / "port.png", tmp_path / "jax.png")
    for f in sorted(os.listdir(tmp_path / "port")):
        _same_png(tmp_path / "port" / f, tmp_path / "jax" / f)


def test_demo_compare_and_doctor_commands(tmp_path, capsys):
    image = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(7).integers(
        0, 255, (64, 48, 3), np.uint8)).save(image)
    assert cli_main(["demo", "--image", str(image), "--configs",
                     "P16H512A8", "--out", str(tmp_path / "demo"),
                     "--device", "cpu"]) == 0
    assert "P16H512A8: classes=" in capsys.readouterr().out
    assert _pixels(tmp_path / "demo" / "demo_P16H512A8.png").ndim == 3

    _sweep_dir(tmp_path / "sweep", np.random.default_rng(8))
    assert cli_main(["compare", "--dir", str(tmp_path / "sweep"), "--out",
                     str(tmp_path / "cmp")]) == 0
    assert sorted(os.listdir(tmp_path / "cmp")) == [
        "P16H512A8_confusion.png", "P8H768A12_confusion.png", "summary.png"]
    capsys.readouterr()

    assert cli_main(["doctor", "--cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["device"] == "cpu" and report["device_check"] == "ok"
    assert report["torch"] == torch.__version__
    assert len(report["kernels"]) == 10
