"""Trained-model quality and speed of the serving opt-ins, on the GPU.

The port's counterpart of ``scripts/quant_quality.py`` and
``scripts/tome_quality.py``. On random weights the 17-way argmax sits at
near-ties everywhere, so agreement there is a worst case; this trains
ViT-B/16 (17 classes, bf16, 224², the CE task with the JAX script's
schedule: Adam, lr 1e-4, batch 16 in one micro-batch, no early stopping)
on ``generate_multiclass`` images (resized to 224² as the serving forward
resizes), then scores on a held-out set drawn from another seed (the
70/15/15 split needs scikit-learn):

  exact   the bf16 model
  int8    W8A8 encoder linears (ops/quant.py)
  r8, r16 ToMe token merging at r = 8 and 16 (ops/token_merge.py)
  fused   resize and the uint8 scale folded into the patch embedding
          (ops/fused_preproc.py)

each through the serving forward at the held-out images' size (512² in,
bilinear resize to 224² on the device, masks at 512²): argmax agreement
with the exact masks, pixel accuracy and mIoU against the ground truth
(per image, the reference's semantics, then the mean). Then masks/s of
every variant at batch 32 on 512² inputs, best of rounds of 20 forwards
with the masks' readback, the variants in turns in one process.

    python -m visiontransformer_tpu_torch.scripts.optin_quality \\
        [--samples 240] [--epochs 60] [--test-samples 36] [--out FILE] \\
        [--layer-errors]

``--layer-errors`` also runs every W8A8 linear of the int8 model on the
host, on the activations the served forward of the first held-out batch
gave it on the device, and reports each layer's int32 accumulators (equal
or not) and its largest output error, absolute and in units of the
output dtype's last place (``layer_errors``, the worst layer first).

The defaults are the JAX script's sizes (QUANTQ_SAMPLES, QUANTQ_EPOCHS).
``--device cpu`` with a small ``--config``/``--image-size``/``--in-size``
runs the same steps on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from PIL import Image

from visiontransformer_tpu_torch.configs import CE_TRAIN_DEFAULTS
from visiontransformer_tpu_torch.data import CESegmentationDataset
from visiontransformer_tpu_torch.data.synthetic import generate_multiclass
from visiontransformer_tpu_torch.device import resolve_device
from visiontransformer_tpu_torch.metrics.segmentation import (
    per_class_iou,
    pixel_accuracy_percent,
)
from visiontransformer_tpu_torch.models.registry import vitseg_config
from visiontransformer_tpu_torch.nn.layers import (
    LinearW8A8,
    _linear_w8a8,
    int8_matmul,
    quantize_per_token,
)
from visiontransformer_tpu_torch.models.vitseg import (
    set_token_merge_r,
    vitseg_build_fused_preproc,
    vitseg_predict,
    vitseg_predict_fused,
)
from visiontransformer_tpu_torch.ops.quant import quantize_vitseg
from visiontransformer_tpu_torch.ops.resize import resize_bilinear_mm
from visiontransformer_tpu_torch.train.trainer import Trainer

VARIANTS = ("exact", "int8", "r8", "r16", "fused")
SPEED_BATCH = 32
LEARNING_RATE = 1e-4  # scripts/quant_quality.py's


def _args(argv):
    p = argparse.ArgumentParser(
        prog="python -m visiontransformer_tpu_torch.scripts.optin_quality",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--samples", type=int, default=240)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--test-samples", type=int, default=36)
    p.add_argument("--config", default="P16H768A12")
    p.add_argument("--image-size", type=int, default=224,
                   help="compute size of the backbone")
    p.add_argument("--in-size", type=int, default=512,
                   help="side of the generated images and served masks")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--speed-rounds", type=int, default=5,
                   help="rounds of the masks/s A/B (0: not measured)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default="", help="also write the JSON here")
    p.add_argument("--layer-errors", action="store_true",
                   help="each W8A8 linear on the device against the host")
    return p.parse_args(argv)


class _ServedResize:
    """The training set as the serving forward sees its inputs: each
    generated image resized to the compute size by the serving path's
    matrix-form bilinear resize (``resize_bilinear_mm``, not PIL's
    antialiased one), masks as ``CESegmentationDataset`` gives them."""

    def __init__(self, dataset: CESegmentationDataset, size: int):
        self.dataset, self.size, self._cache = dataset, size, {}

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int):
        if idx not in self._cache:
            image, mask = self.dataset[idx]
            image = resize_bilinear_mm(torch.from_numpy(image)[None],
                                       (self.size, self.size))[0].numpy()
            self._cache[idx] = (image, mask)
        return self._cache[idx]


def _held_out(root: str, n: int, size: int, unique_values: np.ndarray):
    """(uint8 images, int64 class masks) at the generated size, the masks
    mapped with the training set's class table."""
    generate_multiclass(root, n_samples=n, image_size=size, seed=1)
    lut = np.zeros(256, np.int64)
    lut[unique_values] = np.arange(len(unique_values))
    names = sorted(os.listdir(f"{root}/image_png"))
    images = np.stack([np.asarray(Image.open(f"{root}/image_png/{f}")
                                  .convert("RGB")) for f in names])
    masks = np.stack([lut[np.asarray(Image.open(f"{root}/mask_png/{f}")
                                     .convert("L"))] for f in names])
    return images, masks


def _forwards(model, in_size: int):
    """(name -> f(uint8 (B, in, in, 3) on the device) -> uint8 masks, the
    int8 model that "int8" serves)."""
    size = (in_size, in_size)
    compute = (model.cfg.vit.image_size,) * 2

    def serve(m):
        return lambda raw: vitseg_predict(
            m, resize_bilinear_mm(raw.float() / 255.0, compute),
            out_size=size, mask_dtype=torch.uint8)

    def merged(r):
        def fn(raw):
            set_token_merge_r(model, r)
            try:
                return serve(model)(raw)
            finally:
                set_token_merge_r(model, 0)
        return fn

    # The training data are not normalized: mean 0, std 1.
    consts = vitseg_build_fused_preproc(model, in_size=in_size,
                                        mean=(0.0,) * 3, std=(1.0,) * 3,
                                        input_scale=1.0 / 255.0)
    int8 = quantize_vitseg(model)
    return {"exact": serve(model), "int8": serve(int8),
            "r8": merged(8), "r16": merged(16),
            "fused": lambda raw: vitseg_predict_fused(
                model, consts, raw, out_size=size, mask_dtype=torch.uint8)
            }, int8


def _layer_errors(forward, int8_model, raw: torch.Tensor) -> list:
    """Each ``LinearW8A8`` of ``int8_model``, on the inputs ``forward(raw)``
    gave it, against the same layer on the host: one dict a layer, the
    largest ulp error first."""
    seen = {}
    layers = {n: m for n, m in int8_model.named_modules()
              if isinstance(m, LinearW8A8)}

    def keep(name):
        def hook(module, args, out):
            seen.setdefault(name, (args[0], out))
        return hook

    hooks = [m.register_forward_hook(keep(name))
             for name, m in layers.items()]
    try:
        forward(raw)
    finally:
        for h in hooks:
            h.remove()
    rows = []
    for name, (x, y) in seen.items():
        m = layers[name]
        host = [t.cpu() for t in (x, m.kernel_q, m.kernel_scale)]
        bias = None if m.bias is None else m.bias.cpu()
        acc = [int8_matmul(q.reshape(-1, q.shape[-1]), w) for q, w in (
            (quantize_per_token(x)[0], m.kernel_q),
            (quantize_per_token(host[0])[0], host[1]))]
        y_host = _linear_w8a8(*host, bias).float()
        err = (y.float().cpu() - y_host).abs()
        # One unit in the last place of each host output, in y's dtype.
        ulp = torch.exp2(torch.floor(torch.log2(y_host.abs().clamp_min(
            torch.finfo(y.dtype).tiny)))) * torch.finfo(y.dtype).eps
        rows.append({"layer": name, "x_shape": list(x.shape),
                     "dtype": str(x.dtype).replace("torch.", ""),
                     "kernel_shape": list(m.kernel_q.shape),
                     "acc_equal": bool(torch.equal(acc[0].cpu(), acc[1])),
                     "max_abs_err": float(err.max()),
                     "max_ulp": float((err / ulp).max())})
    return sorted(rows, key=lambda r: -r["max_ulp"])


def _score(pred: torch.Tensor, gt: torch.Tensor, num_classes: int):
    acc = pixel_accuracy_percent(gt, pred)
    iou = torch.nanmean(per_class_iou(gt, pred, num_classes), dim=-1)
    return float(acc.mean()), float(torch.nanmean(iou))


def _masks_per_s(fn, raw: torch.Tensor, rounds: int) -> float:
    fn(raw).cpu()
    best = 0.0
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(20):
            out = fn(raw)
        out.cpu()
        best = max(best, len(raw) * 20 / (time.perf_counter() - t0))
    return best


def _card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"device": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return {"device": torch.cuda.get_device_name(device),
            "nvidia_smi": smi[0] if smi else "not read"}


def _train(args, device: torch.device, tmp: str):
    """Train on generated images under ``tmp``: (model in eval mode, train
    seconds, classes, training images, held-out images, held-out masks)."""
    generate_multiclass(f"{tmp}/train", n_samples=args.samples,
                        image_size=args.in_size, seed=0)
    train = _ServedResize(CESegmentationDataset(
        f"{tmp}/train/image_png", f"{tmp}/train/mask_png",
        image_size=args.in_size), args.image_size)
    num_classes = train.dataset.num_classes
    images, gt = _held_out(f"{tmp}/test", args.test_samples, args.in_size,
                           train.dataset.unique_values)
    cfg = vitseg_config(args.config, num_classes=num_classes,
                        input_size=args.image_size, compute_dtype="bfloat16")
    tcfg = dataclasses.replace(
        CE_TRAIN_DEFAULTS, batch_size=args.batch, accumulate_grad_batches=1,
        learning_rate=LEARNING_RATE, max_epochs=args.epochs,
        early_stopping_monitor=None)
    print(f"train {len(train)} images ({args.in_size}² -> "
          f"{args.image_size}²), held out {len(images)}, {num_classes} "
          f"classes, {args.config} bf16, {args.epochs} epochs", flush=True)
    t0 = time.perf_counter()
    state = Trainer(cfg, tcfg, device=device).fit(
        train, on_epoch_end=lambda e, m: print(
            f"epoch {e}: train_loss={m['train_loss']:.4f}", flush=True)
        if e % 10 == 9 or e == args.epochs - 1 else None)
    return (state.model.eval(), time.perf_counter() - t0, num_classes,
            len(train), images, gt)


def main(argv=None) -> int:
    args = _args(argv)
    device = resolve_device(args.device)
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        model, train_s, num_classes, n_train, images, gt = _train(
            args, device, tmp)
    result = {"config": args.config, "classes": num_classes,
              "train_images": n_train, "held_out": len(images),
              "epochs": args.epochs, "train_s": train_s, **_card(device)}
    gt = torch.from_numpy(gt).to(device)
    with torch.inference_mode():
        forwards, int8_model = _forwards(model, args.in_size)
        masks = {}
        for name in VARIANTS:
            masks[name] = torch.cat([
                forwards[name](torch.from_numpy(images[i:i + args.batch])
                               .to(device)).long()
                for i in range(0, len(images), args.batch)])
        print(f"\n{'variant':>8} {'agree':>8} {'pix_acc%':>9} {'mIoU':>7}")
        for name in VARIANTS:
            agree = float((masks[name] == masks["exact"]).float().mean())
            acc, miou = _score(masks[name], gt, num_classes)
            result[name] = {"agreement": agree, "pixel_accuracy": acc,
                            "miou": miou}
            print(f"{name:>8} {agree:>8.4f} {acc:>9.2f} {miou:>7.4f}",
                  flush=True)

        if args.layer_errors:
            rows = _layer_errors(forwards["int8"], int8_model,
                                 torch.from_numpy(images[:args.batch])
                                 .to(device))
            result["layer_errors"] = rows
            for r in rows[:5]:
                print(f"layer {r['layer']} x{r['x_shape']} {r['dtype']}: "
                      f"acc_equal={r['acc_equal']} max_abs_err="
                      f"{r['max_abs_err']} max_ulp={r['max_ulp']}",
                      flush=True)

        gen = torch.Generator(device=device).manual_seed(0)
        raw = torch.randint(0, 256, (SPEED_BATCH, args.in_size,
                                     args.in_size, 3), generator=gen,
                            device=device, dtype=torch.uint8)
        rates = {name: None for name in VARIANTS}
        for order in ((VARIANTS, VARIANTS[::-1]) if args.speed_rounds
                      else ()):
            for name in order:
                rates[name] = max(rates[name] or 0.0, _masks_per_s(
                    forwards[name], raw, args.speed_rounds))
        for name in VARIANTS:
            result[name]["masks_per_s"] = rates[name]
            print(f"serve {name}: {rates[name] or 'not measured'} masks/s "
                  f"({result['device']})", flush=True)
    result["seconds"] = time.perf_counter() - t_start
    line = json.dumps({"optin_quality": result})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
