"""Command-line entry points of the port:

  python -m visiontransformer_tpu_torch train --data data --task ce ...
  python -m visiontransformer_tpu_torch train --data data --model unet ...
  python -m visiontransformer_tpu_torch train --data data --task paed_binary ...
  python -m visiontransformer_tpu_torch eval-sweep --data data --out test ...
  python -m visiontransformer_tpu_torch synth --kind binary --out data
  python -m visiontransformer_tpu_torch serve --port 8000
  python -m visiontransformer_tpu_torch convert --ckpt ref.ckpt ...
  python -m visiontransformer_tpu_torch export --ckpt ckpts/ ...
  python -m visiontransformer_tpu_torch export-serving --ckpt ckpts/ ...
  python -m visiontransformer_tpu_torch register-model --name ...

The TPU package's ``cli.py`` commands of the same names, with the flags
the port implements (mesh, parallelism, multi-host and profiling wait for
their slices). ``export-serving`` replaces ``export-hlo``: it writes a
``torch.export`` program (``ckpt/export.py``) for the device it runs on.
Commands that run a model take ``--device`` (default cuda; the CPU only
when asked for). ``serve`` hands its arguments to ``serve/server.py`` and
serves the models registered with ``register-model``, of any family the
port has (``--family``), int8 included. ``export-serving --family`` takes
any family (and, for segformer, an HF SegFormer directory as ``--ckpt``);
``convert``, ``export`` and ``eval-sweep`` are for vitseg.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

COMMANDS = ("train", "eval-sweep", "serve", "convert", "export",
            "export-serving", "register-model", "synth")
# The model families of the port (models/registry.py:MODEL_FAMILIES),
# named here so that parsing the arguments imports no model code;
# tests/test_torch_conv_train_serve.py holds them equal.
MODEL_FAMILY_CHOICES = [
    "deeplabv3", "deeplabv3plus", "fpn", "linknet", "manet", "pan",
    "pspnet", "segformer", "unet", "unetplusplus", "upernet", "vitseg",
]
USAGE = ("usage: python -m visiontransformer_tpu_torch "
         "{" + ",".join(COMMANDS) + "} [options]")


def _add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data", required=True,
                   help="dataset root containing image_png/ and mask_png/")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--no-split", action="store_true",
                   help="reference-compatible mode: use the full directory "
                        "instead of the 70/15/15 split (which needs "
                        "scikit-learn)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")


def _train_parser() -> argparse.ArgumentParser:
    t = argparse.ArgumentParser(prog="visiontransformer_tpu_torch train",
                                description="train a segmentation model")
    _add_data_args(t)
    t.add_argument("--task", default="ce",
                   choices=["ce", "smp_multiclass", "paed_multiclass",
                            "paed_anchored", "paed_binary"])
    t.add_argument("--model", default="vitseg",
                   choices=MODEL_FAMILY_CHOICES)
    t.add_argument("--config", default="P16H1024A16",
                   help="sweep config name (vitseg), e.g. P16H512A8")
    t.add_argument("--encoder", default="resnet34",
                   help="encoder preset (conv families; segformer also "
                        "mit_b0 ... mit_b5)")
    t.add_argument("--batch-size", type=int, default=4)
    t.add_argument("--lr", type=float, default=None)
    t.add_argument("--max-epochs", type=int, default=100)
    t.add_argument("--accumulate", type=int, default=4)
    t.add_argument("--dtype", default="bfloat16")
    t.add_argument("--logs", default="logs")
    t.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (default: checkpoints/ in "
                        "the run's log directory)")
    t.add_argument("--resume", default=None,
                   help="checkpoint path/dir to resume from")
    t.add_argument("--cache-data", action="store_true",
                   help="cache decoded+preprocessed samples in RAM "
                        "(~0.7 MB/sample at 224²)")
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
    from visiontransformer_tpu_torch.models.registry import model_config
    from visiontransformer_tpu_torch.train.trainer import Trainer
    from visiontransformer_tpu_torch.utils.csvlog import CSVLogger

    args = _train_parser().parse_args(argv)
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
    if args.model == "vitseg":
        seg_cfg = sweep_by_name(args.config).seg_config(
            num_classes=num_classes, compute_dtype=args.dtype)
        seg_cfg = dataclasses.replace(seg_cfg, vit=dataclasses.replace(
            seg_cfg.vit, image_size=args.image_size))
    else:
        seg_cfg = model_config(args.model, args.encoder,
                               num_classes=num_classes,
                               compute_dtype=args.dtype)
    tcfg = dataclasses.replace(
        PAED_TRAIN_DEFAULTS if binary else CE_TRAIN_DEFAULTS,
        batch_size=args.batch_size, max_epochs=args.max_epochs,
        accumulate_grad_batches=args.accumulate,
        **({"learning_rate": args.lr} if args.lr else {}))

    logger = CSVLogger(args.logs)
    trainer = Trainer(seg_cfg, tcfg, task=args.task, model=args.model,
                      device=args.device, logger=logger)

    def report(epoch, metrics):
        line = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
        print(f"epoch {epoch}: {line}", flush=True)

    ckpt_dir = args.ckpt_dir or os.path.join(logger.log_dir, "checkpoints")
    trainer.fit(train_ds, val_dataset=val_ds, checkpoint_dir=ckpt_dir,
                resume_from=args.resume, on_epoch_end=report)
    print(f"logs: {logger.path}\ncheckpoints: {ckpt_dir}")
    return 0


def cmd_eval_sweep(argv) -> int:
    """The 9-config evaluation sweep (or --configs) over the test split,
    one metrics CSV and one pixel confusion .npy per config under --out."""
    from visiontransformer_tpu_torch.configs import SWEEP_CONFIGS, sweep_by_name
    from visiontransformer_tpu_torch.data import (
        CESegmentationDataset,
        PAEDBinaryDataset,
        train_val_test_split,
    )
    from visiontransformer_tpu_torch.evaluation import run_sweep

    p = argparse.ArgumentParser(prog="visiontransformer_tpu_torch eval-sweep",
                                description="run the 9-config evaluation "
                                            "sweep")
    _add_data_args(p)
    p.add_argument("--task", default="ce", choices=["ce", "paed_binary"],
                   help="ce: multiclass sweep (reference "
                        "datasetTestViTmodel.py); paed_binary: binary crack "
                        "sweep (reference ViTscriptTest.py, with the "
                        "per-loop config actually instantiated)")
    p.add_argument("--out", default="test")
    p.add_argument("--ckpt-root", default=None,
                   help="directory of <config name>/epoch=N-step=M "
                        "checkpoints of the port (default: seeded random "
                        "weights)")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--num-batches", type=int, default=125)
    p.add_argument("--configs", default=None,
                   help="comma-separated subset, e.g. P16H512A8,P8H768A12")
    p.add_argument("--visualize", action="store_true",
                   help="evaluation panels (not ported yet: raises)")
    args = p.parse_args(argv)

    image_dir = os.path.join(args.data, "image_png")
    mask_dir = os.path.join(args.data, "mask_png")
    binary = args.task == "paed_binary"
    ds_cls = PAEDBinaryDataset if binary else CESegmentationDataset
    probe = ds_cls(image_dir, mask_dir, image_size=args.image_size)
    test_files = (list(probe.images) if args.no_split
                  else train_val_test_split(probe.images)[2])
    test_ds = ds_cls(image_dir, mask_dir, image_size=args.image_size,
                     subset=test_files)

    entries = SWEEP_CONFIGS
    if args.configs:
        entries = [sweep_by_name(n) for n in args.configs.split(",")]
    paths = run_sweep(test_ds, output_dir=args.out,
                      num_classes=1 if binary else probe.num_classes,
                      checkpoint_root=args.ckpt_root, entries=entries,
                      batch_size=args.batch_size,
                      num_batches=args.num_batches,
                      image_size=args.image_size, device=args.device,
                      save_visualizations=args.visualize)
    for path in paths:
        print(path)
    return 0


def cmd_synth(argv) -> int:
    """A synthetic dataset (image_png/, mask_png/) from the port's copy of
    the TPU package's generators."""
    from visiontransformer_tpu_torch.data.synthetic import (
        generate_binary,
        generate_multiclass,
    )

    p = argparse.ArgumentParser(prog="visiontransformer_tpu_torch synth",
                                description="generate a synthetic dataset")
    p.add_argument("--kind", choices=["multiclass", "binary"],
                   default="multiclass")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--size", type=int, default=512)
    args = p.parse_args(argv)
    generate = (generate_multiclass if args.kind == "multiclass"
                else generate_binary)
    generate(args.out, n_samples=args.n, image_size=args.size)
    print(args.out)
    return 0


def _convert_parser(prog: str, description: str, out_help: str
                    ) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description=description)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--config", required=True,
                   help="sweep config name, e.g. P8H1024A16")
    p.add_argument("--num-classes", type=int, default=17)
    p.add_argument("--out", required=True, help=out_help)
    return p


def cmd_convert(argv) -> int:
    """Reference .ckpt -> a port checkpoint directory, so reference-trained
    weights serve on the card."""
    from visiontransformer_tpu_torch.ckpt.io import save_checkpoint
    from visiontransformer_tpu_torch.ckpt.torch_convert import (
        load_lightning_checkpoint,
    )
    from visiontransformer_tpu_torch.configs import sweep_by_name

    p = _convert_parser("visiontransformer_tpu_torch convert",
                        "convert a reference PyTorch-Lightning .ckpt into "
                        "a checkpoint of the port", "output checkpoint "
                        "directory")
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--step", type=int, default=0)
    args = p.parse_args(argv)
    cfg = sweep_by_name(args.config).seg_config(num_classes=args.num_classes)
    params = load_lightning_checkpoint(args.ckpt, cfg)
    print(save_checkpoint(args.out, {"params": params, "step": args.step},
                          epoch=args.epoch, step=args.step))
    return 0


def cmd_export(argv) -> int:
    """A port checkpoint -> reference Lightning .ckpt (the inverse of
    convert; port-trained weights load back into the reference stack and,
    through the TPU package's convert, into the TPU package)."""
    from visiontransformer_tpu_torch.ckpt.io import (
        get_latest_checkpoint,
        parse_epoch,
        restore_checkpoint,
    )
    from visiontransformer_tpu_torch.ckpt.torch_convert import (
        save_lightning_checkpoint,
    )
    from visiontransformer_tpu_torch.configs import sweep_by_name

    args = _convert_parser(
        "visiontransformer_tpu_torch export",
        "export a checkpoint of the port as a reference-format "
        "PyTorch-Lightning .ckpt (inverse of convert)",
        "output .ckpt file path").parse_args(argv)
    path = get_latest_checkpoint(args.ckpt) or args.ckpt
    restored = restore_checkpoint(path)
    params = restored.get("params", restored)
    cfg = sweep_by_name(args.config).seg_config(num_classes=args.num_classes)
    print(save_lightning_checkpoint(
        args.out, params, cfg, epoch=parse_epoch(path) or 0,
        global_step=int(restored.get("step", 0))))
    return 0


def cmd_export_serving(argv) -> int:
    """Serving forward -> one saved torch.export program
    (ckpt/export.py); it replaces the TPU package's export-hlo."""
    from visiontransformer_tpu_torch.ckpt.export import export_serving
    from visiontransformer_tpu_torch.ckpt.io import get_latest_checkpoint
    from visiontransformer_tpu_torch.models.registry import resolve_model

    p = argparse.ArgumentParser(
        prog="visiontransformer_tpu_torch export-serving",
        description="export the serving forward (weights inside) as one "
                    "torch.export program for the device it runs on; "
                    "deployment hosts run it with ckpt.export.load_serving "
                    "(replaces the TPU package's export-hlo)")
    p.add_argument("--ckpt", default="",
                   help="port checkpoint (or a directory of them, latest "
                        "picked), reference .ckpt file (vitseg) or HF "
                        "SegFormer directory (segformer); empty: random "
                        "init, useful for smoke tests")
    p.add_argument("--family", default="vitseg",
                   choices=MODEL_FAMILY_CHOICES)
    p.add_argument("--config", required=True,
                   help="vitseg: sweep config name or ViT size preset; "
                        "other families: encoder preset")
    p.add_argument("--num-classes", type=int, default=17)
    p.add_argument("--input-size", type=int, default=None,
                   help="image side of the program: vitseg's defaults to "
                        "224, every other family's must be given")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", required=True, help="output artifact path")
    args = p.parse_args(argv)
    if args.family != "vitseg" and args.input_size is None:
        p.error(f"--input-size is required for --family {args.family}: "
                f"the exported program is static-shape")
    ckpt = get_latest_checkpoint(args.ckpt) or args.ckpt
    cfg, model = resolve_model(
        args.family, args.config, num_classes=args.num_classes,
        input_size=args.input_size or 224,
        compute_dtype=args.compute_dtype, checkpoint_path=ckpt,
        device=args.device)
    meta = export_serving(model, cfg, out_path=args.out,
                          batch_size=args.batch, input_size=args.input_size)
    print(f"{args.out}: {meta}")
    return 0


def cmd_register_model(argv) -> int:
    """Register a model of any family in the serving store (the reference
    does this through the Django admin)."""
    from visiontransformer_tpu_torch.configs import vit_config_by_name
    from visiontransformer_tpu_torch.models.registry import encoder_presets
    from visiontransformer_tpu_torch.serve.store import JobStore

    p = argparse.ArgumentParser(
        prog="visiontransformer_tpu_torch register-model",
        description="register a model in the serving store")
    p.add_argument("--db", default="serving.db")
    p.add_argument("--media-root", default="media")
    p.add_argument("--name", required=True)
    p.add_argument("--config", required=True,
                   help="vitseg: sweep config name (e.g. P16H768A12) or "
                        "ViT size preset (vit_b_16/vit_l_16/vit_h_14); "
                        "conv families: encoder preset (e.g. resnet34); "
                        "segformer: also mit_b0 ... mit_b5")
    p.add_argument("--num-classes", type=int, default=17)
    p.add_argument("--input-size", type=int, default=224)
    p.add_argument("--ckpt", default="",
                   help="port checkpoint dir, reference .ckpt file "
                        "(vitseg) or HF SegFormer directory (segformer); "
                        "empty: random init, useful for smoke tests")
    p.add_argument("--description", default="")
    p.add_argument("--family", default="vitseg",
                   choices=MODEL_FAMILY_CHOICES,
                   help="model family; --config is a sweep config for "
                        "vitseg, an encoder preset for the conv families")
    p.add_argument("--token-merge-r", type=int, default=0,
                   help="opt-in ToMe token merging: tokens merged per "
                        "encoder block (ops/token_merge.py)")
    p.add_argument("--quantize", default="", choices=("", "int8"),
                   help="opt-in W8A8 dynamic int8 quantization "
                        "(ops/quant.py): vitseg's encoder linears, every "
                        "other family's linears and interior convs")
    args = p.parse_args(argv)
    # Validate the config before touching the store.
    if args.family == "vitseg":
        try:
            vit_config_by_name(args.config)
        except KeyError as exc:
            print(f"error: {exc.args[0]}", file=sys.stderr)
            return 1
    elif args.config not in encoder_presets(args.family):
        print(f"error: unknown encoder preset {args.config!r}; choose from "
              f"{encoder_presets(args.family)}", file=sys.stderr)
        return 1
    if args.ckpt and not os.path.exists(args.ckpt):
        print(f"error: checkpoint {args.ckpt} does not exist",
              file=sys.stderr)
        return 1
    if args.token_merge_r and args.family != "vitseg":
        print("error: --token-merge-r applies to vitseg models only",
              file=sys.stderr)
        return 1
    store = JobStore(args.db, media_root=args.media_root)
    model_id = store.register_model(
        args.name, num_classes=args.num_classes, config_name=args.config,
        description=args.description, input_size=args.input_size,
        checkpoint_path=args.ckpt, model_family=args.family,
        token_merge_r=args.token_merge_r, quantize=args.quantize)
    print(f"registered model id={model_id} name={args.name} "
          f"family={args.family} config={args.config} "
          f"ckpt={args.ckpt or '<random init>'}")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(USAGE, file=sys.stderr)
        return 2
    command, rest = argv[0], argv[1:]
    if command == "serve":
        from visiontransformer_tpu_torch.serve.server import main as serve_main

        serve_main(rest)
        return 0
    return {"train": cmd_train, "eval-sweep": cmd_eval_sweep,
            "convert": cmd_convert, "export": cmd_export,
            "export-serving": cmd_export_serving,
            "register-model": cmd_register_model,
            "synth": cmd_synth}[command](rest)
