"""Command-line entry points of the port:

  python -m visiontransformer_tpu_torch train --data data --task ce ...
  python -m visiontransformer_tpu_torch serve --port 8000

``train`` mirrors the TPU package's ``cli.py`` train command (its flags
for mesh, parallelism, multi-host, checkpoints, resume and profiling are
left out until their slices) and runs on ``--device`` (default cuda; the
CPU only when asked for). ``serve`` hands its arguments to
``serve/server.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

USAGE = ("usage: python -m visiontransformer_tpu_torch {train,serve} "
         "[options]")


def _train_parser() -> argparse.ArgumentParser:
    t = argparse.ArgumentParser(prog="visiontransformer_tpu_torch train",
                                description="train a vitseg model")
    t.add_argument("--data", required=True,
                   help="dataset root containing image_png/ and mask_png/")
    t.add_argument("--image-size", type=int, default=224)
    t.add_argument("--task", default="ce",
                   choices=["ce", "smp_multiclass", "paed_multiclass",
                            "paed_anchored", "paed_binary"])
    t.add_argument("--config", default="P16H1024A16",
                   help="sweep config name, e.g. P16H512A8")
    t.add_argument("--batch-size", type=int, default=4)
    t.add_argument("--lr", type=float, default=None)
    t.add_argument("--max-epochs", type=int, default=100)
    t.add_argument("--accumulate", type=int, default=4)
    t.add_argument("--dtype", default="bfloat16")
    t.add_argument("--logs", default="logs")
    t.add_argument("--cache-data", action="store_true",
                   help="cache decoded+preprocessed samples in RAM "
                        "(~0.7 MB/sample at 224²)")
    t.add_argument("--no-split", action="store_true",
                   help="reference-compatible mode: train on the full "
                        "directory instead of the 70/15/15 split")
    t.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return t


def cmd_train(argv) -> int:
    from visiontransformer_tpu_torch.configs import (
        CE_TRAIN_DEFAULTS,
        PAED_TRAIN_DEFAULTS,
        sweep_by_name,
    )
    from visiontransformer_tpu_torch.data import (
        CESegmentationDataset,
        PAEDBinaryDataset,
        train_val_test_split,
    )
    from visiontransformer_tpu_torch.train.tasks import get_task
    from visiontransformer_tpu_torch.train.trainer import Trainer
    from visiontransformer_tpu_torch.utils.csvlog import CSVLogger

    args = _train_parser().parse_args(argv)
    get_task(args.task)  # an unported task fails before any data is read
    image_dir = os.path.join(args.data, "image_png")
    mask_dir = os.path.join(args.data, "mask_png")
    binary = args.task == "paed_binary"
    ds_cls = PAEDBinaryDataset if binary else CESegmentationDataset

    probe = ds_cls(image_dir, mask_dir, image_size=args.image_size)
    if args.no_split:
        train_files = val_files = list(probe.images)
    else:
        train_files, val_files, _ = train_val_test_split(probe.images)
    train_ds = ds_cls(image_dir, mask_dir, image_size=args.image_size,
                      subset=train_files, cache=args.cache_data)
    val_ds = ds_cls(image_dir, mask_dir, image_size=args.image_size,
                    subset=val_files, cache=args.cache_data)

    num_classes = 1 if binary else probe.num_classes
    seg_cfg = sweep_by_name(args.config).seg_config(
        num_classes=num_classes, compute_dtype=args.dtype)
    seg_cfg = dataclasses.replace(seg_cfg, vit=dataclasses.replace(
        seg_cfg.vit, image_size=args.image_size))
    tcfg = dataclasses.replace(
        PAED_TRAIN_DEFAULTS if binary else CE_TRAIN_DEFAULTS,
        batch_size=args.batch_size, max_epochs=args.max_epochs,
        accumulate_grad_batches=args.accumulate,
        **({"learning_rate": args.lr} if args.lr else {}))

    logger = CSVLogger(args.logs)
    trainer = Trainer(seg_cfg, tcfg, task=args.task, device=args.device,
                      logger=logger)

    def report(epoch, metrics):
        line = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
        print(f"epoch {epoch}: {line}", flush=True)

    trainer.fit(train_ds, val_dataset=val_ds, on_epoch_end=report)
    print(f"logs: {logger.path}")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("train", "serve"):
        print(USAGE, file=sys.stderr)
        return 2
    if argv[0] == "train":
        return cmd_train(argv[1:])
    from visiontransformer_tpu_torch.serve.server import main as serve_main

    serve_main(argv[1:])
    return 0
