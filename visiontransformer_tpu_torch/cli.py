"""Command-line entry points of the port:

  python -m visiontransformer_tpu_torch train --data data --task ce ...
  python -m visiontransformer_tpu_torch train --data data --model unet ...
  python -m visiontransformer_tpu_torch train --data data --task paed_binary ...
  python -m visiontransformer_tpu_torch train --data data --profile-dir prof ...
  python -m visiontransformer_tpu_torch train --data data --mesh 4,2 --fsdp ...
  python -m visiontransformer_tpu_torch train --data data --pipeline 2 --mesh 2,2 ...
  python -m visiontransformer_tpu_torch train --data data --multihost \
      --coordinator HOST:PORT --num-processes 2 --process-id 0 ...
  python -m visiontransformer_tpu_torch eval-sweep --data data --out test ...
  python -m visiontransformer_tpu_torch demo --image IMG.png --configs P16H768A12
  python -m visiontransformer_tpu_torch compare --dir test --out comparison
  python -m visiontransformer_tpu_torch synth --kind binary --out data
  python -m visiontransformer_tpu_torch serve --port 8000
  python -m visiontransformer_tpu_torch convert --ckpt ref.ckpt ...
  python -m visiontransformer_tpu_torch convert-orbax --src orbax/ --out ckpts/ ...
  python -m visiontransformer_tpu_torch export --ckpt ckpts/ ...
  python -m visiontransformer_tpu_torch export-serving --ckpt ckpts/ ...
  python -m visiontransformer_tpu_torch register-model --name ...
  python -m visiontransformer_tpu_torch doctor

The TPU package's ``cli.py`` commands of the same names and flags, but
``--compilation-cache`` (an XLA cache, with no counterpart here).
``train --mesh``/``--pipeline`` outside a torch.distributed job starts
one rank per device of the mesh on this host (``parallel/launch.py``);
``--multihost`` runs this host's ranks of a job that meets at
``--coordinator`` (``parallel/multihost.py``). ``export-serving`` replaces ``export-hlo``: it writes a
``torch.export`` program (``ckpt/export.py``) for the device it runs on.
``convert-orbax`` turns a TPU-package Orbax checkpoint into one of the
port's on a host with tensorstore (``ckpt/orbax_read.py``). ``doctor``
reports torch, CUDA, the card, nvcc, the ten kernels' build and the
native library. Commands that run a model take ``--device`` (default
cuda; the CPU only when asked for). ``serve`` hands its arguments to ``serve/server.py`` and
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

COMMANDS = ("train", "eval-sweep", "demo", "compare", "serve", "convert",
            "convert-orbax", "export", "export-serving", "register-model",
            "synth", "doctor")
# The model families of the port (models/registry.py:MODEL_FAMILIES),
# named here so that parsing the arguments imports no model code;
# tests/test_torch_conv_train_serve.py holds them equal.
MODEL_FAMILY_CHOICES = [
    "deeplabv3", "deeplabv3plus", "fpn", "linknet", "manet", "pan",
    "pspnet", "sam", "segformer", "unet", "unetplusplus", "upernet",
    "vitseg",
]
# The families the port trains and the TPU package checkpoints: all but
# sam, which is served only.
TRAINED_FAMILY_CHOICES = [f for f in MODEL_FAMILY_CHOICES if f != "sam"]
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
                   choices=TRAINED_FAMILY_CHOICES)
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
    t.add_argument("--mesh", default=None,
                   help="dp or dp,tp mesh shape, e.g. 8 or 4,2")
    t.add_argument("--fsdp", action="store_true",
                   help="fully-sharded data parallelism (ZeRO-3): shard "
                        "params/grads/optimizer moments over the mesh's "
                        "data axis too")
    t.add_argument("--seq-parallel", action="store_true",
                   help="sequence parallelism: token-shard the residual "
                        "stream over the tensor-parallel axis (needs a "
                        "dp,tp mesh with tp > 1)")
    t.add_argument("--pipeline", type=int, default=1, metavar="S",
                   help="GPipe pipeline parallelism (vitseg): run the "
                        "encoder as S stages over a (data,stage) mesh; "
                        "each stage stores 1/S of the weights and Adam "
                        "moments. --mesh is then read as dp,S "
                        "(default: 1,S)")
    t.add_argument("--pipeline-microbatches", type=int, default=None,
                   help="in-flight microbatches per pipelined forward "
                        "(default: S; bubble = (S-1)/(M+S-1))")
    t.add_argument("--multihost", action="store_true",
                   help="join a multi-host torch.distributed job and train "
                        "over the pod-wide mesh (pass --coordinator/"
                        "--num-processes/--process-id)")
    t.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (multihost)")
    t.add_argument("--num-processes", type=int, default=None)
    t.add_argument("--process-id", type=int, default=None)
    t.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel axis size of the pod mesh "
                        "(multihost; dp = device_count / tp)")
    t.add_argument("--logs", default="logs")
    t.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (default: checkpoints/ in "
                        "the run's log directory)")
    t.add_argument("--resume", default=None,
                   help="checkpoint path/dir to resume from")
    t.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the first epoch's "
                        "steps 2-5 here (*.pt.trace.json)")
    t.add_argument("--cache-data", action="store_true",
                   help="cache decoded+preprocessed samples in RAM "
                        "(~0.7 MB/sample at 224²)")
    return t


def _parse_mesh(arg):
    if not arg:
        return None
    return tuple(int(x) for x in arg.split(","))


def _job_size(args) -> int:
    """The ranks ``train --mesh``/``--pipeline`` asks for."""
    shape = _parse_mesh(args.mesh)
    if args.pipeline > 1 and shape is None:
        return args.pipeline
    n = 1
    for d in shape or ():
        n *= d
    return n


def cmd_train(argv) -> int:
    import torch

    from visiontransformer_tpu_torch.parallel import launch

    args = _train_parser().parse_args(argv)
    device_type = torch.device(args.device).type
    if args.multihost:
        from visiontransformer_tpu_torch.parallel.multihost import (
            run_multihost,
        )

        if (args.coordinator is None or args.num_processes is None
                or args.process_id is None):
            raise SystemExit("train --multihost needs --coordinator, "
                             "--num-processes and --process-id")
        return run_multihost(_train, (args,), coordinator=args.coordinator,
                             num_processes=args.num_processes,
                             process_id=args.process_id,
                             device_type=device_type)
    world = _job_size(args)
    if world > 1 and not launch.in_job():
        return launch.spawn(_train, world, (args,),
                            device_type=device_type)[0]
    return _train(args)


def _train(args) -> int:
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
    from visiontransformer_tpu_torch.parallel import launch
    from visiontransformer_tpu_torch.train.trainer import Trainer
    from visiontransformer_tpu_torch.utils.csvlog import CSVLogger

    mesh = None
    if args.multihost:
        from visiontransformer_tpu_torch.parallel.multihost import pod_mesh
        mesh, _ = pod_mesh(tp=args.tp)
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
        mesh_shape=_parse_mesh(args.mesh), fsdp=args.fsdp,
        seq_parallel=args.seq_parallel, pipeline_stages=args.pipeline,
        pipeline_microbatches=args.pipeline_microbatches,
        **({"learning_rate": args.lr} if args.lr else {}))

    # Only the primary rank writes logs; every rank takes part in a
    # checkpoint, so a job's checkpoint directory is the same path on every
    # rank, not one derived from the primary's versioned log directory.
    primary = launch.is_primary()
    logger = CSVLogger(args.logs) if primary else None
    trainer = Trainer(seg_cfg, tcfg, task=args.task, model=args.model,
                      device=args.device, logger=logger, mesh=mesh)

    def report(epoch, metrics):
        if primary:
            line = " ".join(f"{k}={v:.4f}"
                            for k, v in sorted(metrics.items()))
            print(f"epoch {epoch}: {line}", flush=True)

    if launch.in_job():
        ckpt_dir = args.ckpt_dir or os.path.join(args.logs, "checkpoints")
    else:
        ckpt_dir = args.ckpt_dir or os.path.join(logger.log_dir,
                                                 "checkpoints")
    trainer.fit(train_ds, val_dataset=val_ds, checkpoint_dir=ckpt_dir,
                resume_from=args.resume, profile_dir=args.profile_dir,
                on_epoch_end=report)
    if primary:
        print(f"logs: {logger.path}\ncheckpoints: {ckpt_dir}")
    return 0


def cmd_eval_sweep(argv) -> int:
    """The 9-config evaluation sweep (or --configs) over the test split,
    one metrics CSV and one pixel confusion .npy per config under --out."""
    from visiontransformer_tpu_torch.configs import SWEEP_CONFIGS, sweep_by_name
    from visiontransformer_tpu_torch.data import (
        CESegmentationDataset,
        PAEDBinaryDataset,
        load_classdict,
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
                   help="a 5-panel PNG per image of batches 0-25 "
                        "(needs matplotlib)")
    p.add_argument("--classdict", default=None,
                   help="calss_names_colors.csv path (default: "
                        "<data>/calss_names_colors.csv when present)")
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

    class_names = rgb_to_class = None
    classdict = args.classdict or os.path.join(args.data,
                                               "calss_names_colors.csv")
    if not binary and os.path.exists(classdict):
        rgb_to_class, class_names = load_classdict(classdict)

    entries = SWEEP_CONFIGS
    if args.configs:
        entries = [sweep_by_name(n) for n in args.configs.split(",")]
    paths = run_sweep(test_ds, output_dir=args.out,
                      num_classes=1 if binary else probe.num_classes,
                      checkpoint_root=args.ckpt_root, entries=entries,
                      batch_size=args.batch_size,
                      num_batches=args.num_batches,
                      image_size=args.image_size, device=args.device,
                      save_visualizations=args.visualize,
                      class_names=class_names, rgb_to_class=rgb_to_class)
    for path in paths:
        print(path)
    return 0


def cmd_demo(argv) -> int:
    """Single-image inference with each of --configs: the mask, its
    classes and boxes, and a 4-panel composite PNG per config."""
    from visiontransformer_tpu_torch.configs import sweep_by_name
    from visiontransformer_tpu_torch.data import load_classdict
    from visiontransformer_tpu_torch.evaluation.demo import (
        load_image,
        predict_image,
        render_demo_composite,
    )
    from visiontransformer_tpu_torch.evaluation.evaluate import sweep_model

    p = argparse.ArgumentParser(prog="visiontransformer_tpu_torch demo",
                                description="single-image inference demo")
    p.add_argument("--image", required=True)
    p.add_argument("--configs", default="P16H768A12",
                   help="comma-separated config names")
    p.add_argument("--classdict", default=None)
    p.add_argument("--ckpt-root", default=None,
                   help="directory of <config name>/epoch=N-step=M "
                        "checkpoints of the port (default: seeded random "
                        "weights)")
    p.add_argument("--num-classes", type=int, default=17)
    p.add_argument("--out", default="demo_out")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    class_names = rgb_to_class = None
    if args.classdict and os.path.exists(args.classdict):
        rgb_to_class, class_names = load_classdict(args.classdict)

    os.makedirs(args.out, exist_ok=True)
    image = load_image(args.image)
    for name in args.configs.split(","):
        cfg, model = sweep_model(sweep_by_name(name),
                                 num_classes=args.num_classes,
                                 checkpoint_root=args.ckpt_root,
                                 device=args.device)
        result = predict_image(model, cfg, image, class_names=class_names,
                               rgb_to_class=rgb_to_class)
        out_path = os.path.join(args.out, f"demo_{name}.png")
        render_demo_composite(image, result, out_path,
                              class_names=class_names,
                              rgb_to_class=rgb_to_class, title=name)
        print(f"{name}: classes={result['classes']} "
              f"detections={len(result['detections'])} -> {out_path}")
    return 0


def cmd_compare(argv) -> int:
    """The sweep's CSVs under --dir -> a summary chart and a class
    confusion chart per model under --out."""
    from visiontransformer_tpu_torch.evaluation.compare import (
        plot_confusion_matrices,
        plot_summary,
    )

    p = argparse.ArgumentParser(prog="visiontransformer_tpu_torch compare",
                                description="aggregate sweep CSVs into "
                                            "reports")
    p.add_argument("--dir", required=True)
    p.add_argument("--out", default="comparison")
    p.add_argument("--num-classes", type=int, default=17)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    summary = plot_summary(args.dir, os.path.join(args.out, "summary.png"))
    print(summary.to_string())
    plot_confusion_matrices(args.dir, args.out, num_classes=args.num_classes)
    print(f"reports in {args.out}/")
    return 0


def cmd_doctor(argv) -> int:
    """One JSON report of the environment: Python, torch and its CUDA
    runtime, the card, nvcc, the ten kernels' build (built here unless
    --cpu), the native library, and a small computation on the device.
    Exits 1 when the device cannot be reached or a check fails."""
    import json
    import platform
    import subprocess

    import torch

    p = argparse.ArgumentParser(prog="visiontransformer_tpu_torch doctor",
                                description="environment report")
    p.add_argument("--cpu", action="store_true",
                   help="check the CPU instead of the card (builds no "
                        "kernel)")
    args = p.parse_args(argv)
    report = {"python": sys.version.split()[0],
              "platform": platform.platform(), "torch": torch.__version__,
              "cuda_runtime": torch.version.cuda}
    failed = False
    device = "cpu" if args.cpu else "cuda"
    if args.cpu:
        report["device"] = "cpu"
    elif torch.cuda.is_available():
        report["device"] = torch.cuda.get_device_name(0)
        report["device_count"] = torch.cuda.device_count()
    else:
        report["device_error"] = "CUDA is not available"
        failed = True

    from visiontransformer_tpu_torch.ops import _build

    try:
        nvcc = _build._nvcc()
        version = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True, timeout=60).stdout
        report["nvcc"] = {"path": nvcc,
                          "version": version.strip().splitlines()[-1]}
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        report["nvcc"] = f"unavailable ({e})"
    if device == "cuda" and not failed and isinstance(report["nvcc"], dict):
        try:
            report["kernel_build_dir"] = str(_build.build())
            report["kernel_build_s"] = _build.last_build_seconds
        except RuntimeError as e:  # the report is the diagnosis
            report["kernel_build_error"] = str(e)[-2000:]
            failed = True
    report["kernels"] = {name: "built" if ok else "not built"
                         for name, ok in _build.built().items()}

    from visiontransformer_tpu_torch import native

    try:
        report["native_lib"] = (f"loaded ({native.library_path()})"
                                if native.available() else
                                "off (VITSEG_NATIVE=0: numpy fallbacks)")
    except RuntimeError as e:
        report["native_lib"] = str(e)[-2000:]
        failed = True
    if "device_error" not in report:
        x = torch.arange(8.0, device=device)
        ok = float((x * x).sum()) == 140.0
        report["device_check"] = "ok" if ok else "WRONG RESULT"
        failed = failed or not ok
    print(json.dumps(report, indent=2))
    return 1 if failed else 0


def cmd_convert_orbax(argv) -> int:
    """A TPU-package Orbax checkpoint (or the latest in a directory of
    them) -> a checkpoint of the port, on a host with tensorstore."""
    from visiontransformer_tpu_torch.ckpt.io import get_latest_checkpoint
    from visiontransformer_tpu_torch.ckpt.orbax_read import (
        convert_orbax_checkpoint,
    )

    p = argparse.ArgumentParser(
        prog="visiontransformer_tpu_torch convert-orbax",
        description="convert a TPU-package Orbax checkpoint (params, Adam "
                    "state, step) into a checkpoint of the port; needs "
                    "tensorstore, which the card's host may lack: convert "
                    "where it is installed and copy the output")
    p.add_argument("--src", required=True,
                   help="Orbax epoch=N-step=M directory, or a directory "
                        "of them (the latest is taken)")
    p.add_argument("--out", required=True,
                   help="directory the epoch=N-step=M checkpoint goes in")
    p.add_argument("--family", default="vitseg",
                   choices=TRAINED_FAMILY_CHOICES)
    p.add_argument("--config", default=None,
                   help="vitseg: sweep config name or ViT size preset")
    p.add_argument("--encoder", default=None,
                   help="other families: encoder preset (segformer also "
                        "mit_b0 ... mit_b5)")
    p.add_argument("--num-classes", type=int, default=17)
    args = p.parse_args(argv)
    src = get_latest_checkpoint(args.src) or args.src
    print(convert_orbax_checkpoint(
        src, args.out, family=args.family, config=args.config,
        num_classes=args.num_classes, encoder=args.encoder))
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
    from visiontransformer_tpu_torch.parallel.pipeline import (
        maybe_unstack_params,
    )

    restored = restore_checkpoint(path)
    params = maybe_unstack_params(restored.get("params", restored))
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
                        "SegFormer directory (segformer) or HF SamModel "
                        "directory (sam); empty: random "
                        "init, useful for smoke tests")
    p.add_argument("--family", default="vitseg",
                   choices=MODEL_FAMILY_CHOICES)
    p.add_argument("--config", required=True,
                   help="vitseg: sweep config name or ViT size preset; "
                        "sam: sam_vit_b, sam_vit_l or sam_vit_h; other "
                        "families: encoder preset")
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
                        "segformer: also mit_b0 ... mit_b5; sam: sam_vit_b, "
                        "sam_vit_l or sam_vit_h (masks {0, 1}, a box "
                        "prompt an image)")
    p.add_argument("--num-classes", type=int, default=17)
    p.add_argument("--input-size", type=int, default=224)
    p.add_argument("--ckpt", default="",
                   help="port checkpoint dir, reference .ckpt file "
                        "(vitseg), HF SegFormer directory (segformer) or "
                        "HF SamModel directory (sam); empty: random init, "
                        "useful for smoke tests")
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
    if args.quantize and args.family == "sam":
        print("error: --quantize int8 is not defined for sam",
              file=sys.stderr)
        return 1
    if args.family == "sam":
        args.num_classes = 2  # background and the prompted object
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
            "demo": cmd_demo, "compare": cmd_compare,
            "convert": cmd_convert, "convert-orbax": cmd_convert_orbax,
            "export": cmd_export, "export-serving": cmd_export_serving,
            "register-model": cmd_register_model, "synth": cmd_synth,
            "doctor": cmd_doctor}[command](rest)
