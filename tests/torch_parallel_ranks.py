"""Rank functions of the port's parallel tests (tests/test_torch_parallel*.py).

They run in the ranks that ``parallel/launch.py:spawn`` starts (gloo on the
CPU), so this module imports torch and the port only: no JAX, which the
ranks would otherwise import again each. Every function returns plain
numpy/python values from rank 0 (None elsewhere) for the test process to
hold against the JAX package.
"""

import csv
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.parallel import launch

# The JAX parallel tests' TINY config (tests/test_mesh.py): N = 5 tokens,
# which no tp > 1 divides.
TINY_VIT = dict(image_size=32, patch_size=16, hidden_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=128)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CLASSES = 5
LR = 1e-3


def seg_cfg(classes=CLASSES, dropout=False, **vit):
    kw = {**TINY_VIT, **vit, **({} if dropout else NO_DROPOUT)}
    return tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**kw), num_classes=classes)


def train_cfg(**kw):
    base = dict(batch_size=16, accumulate_grad_batches=2,
                early_stopping_monitor=None, learning_rate=LR)
    return tcfg.TrainConfig(**{**base, **kw})


def ce_batch(n=16, seed=7):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((n, 32, 32, 3)).astype(np.float32),
            "mask": rng.integers(0, CLASSES, (n, 48, 48)).astype(np.int32)}


def binary_batch(n=16, seed=7):
    rng = np.random.default_rng(seed)
    mask = (rng.random((n, 40, 40)) > 0.8).astype(np.float32)
    mask[0] = 0.0  # an image without a crack
    return {"image": rng.random((n, 32, 32, 3)).astype(np.float32),
            "mask": mask}


def _np(t):
    return t.detach().cpu().numpy()


def _trainer(task, mode, classes, dropout=False, **vit):
    from visiontransformer_tpu_torch.train.trainer import Trainer

    return Trainer(seg_cfg(classes, dropout, **vit), train_cfg(**mode),
                   task=task, device="cpu")


def step(task, mode, params, batch, steps=1):
    """``steps`` train steps of ``task`` in ``mode`` from ``params`` (a
    TPU-package tree): the loss of each step, the first step's metrics,
    gathered mean gradients and updated params, and the local shapes of
    the first block's qkv kernel and its Adam moment after the last, on
    rank 0."""
    classes = 1 if task == "paed_binary" else CLASSES
    trainer = _trainer(task, mode, classes)
    state = trainer.init_state(params)
    losses = []
    for i in range(steps):
        state, step_metrics = trainer.train_step(state, batch, seed=i)
        losses.append(float(step_metrics["loss"]))
        if i == 0:
            metrics = step_metrics
            grads = trainer.plan.gathered(state.model, lambda p: p.grad)
            new = trainer.plan.gathered(state.model, lambda p: p)
    qkv = next(p for n, p in state.model.named_parameters()
               if n.endswith("qkv.kernel"))
    local = getattr(qkv, "to_local", lambda: qkv)()
    moment = state.optimizer.state[qkv]["exp_avg"]
    moment = getattr(moment, "to_local", lambda: moment)()
    if grads is None:
        return None
    return {"losses": losses,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: _np(v) for k, v in grads.items()},
            "params": {k: _np(v) for k, v in new.items()},
            "qkv_local": tuple(local.shape), "moment_local": tuple(
                moment.shape), "plan": trainer.plan.describe()}


def run_steps(jobs, params_by_classes):
    """jobs: [(key, task, mode, batch, steps)] -> {key: step(...)}."""
    out = {}
    for key, task, mode, batch, steps in jobs:
        classes = 1 if task == "paed_binary" else CLASSES
        out[key] = step(task, mode, params_by_classes[classes], batch, steps)
    return out if launch.is_primary() else None


# ------------------------------------------------------------- pipeline
def toy_layers(n=8, d=16):
    rng = np.random.default_rng(0)
    return [(torch.from_numpy(rng.normal(0, 0.3, (d, d)).astype(np.float32)),
             torch.from_numpy(rng.normal(0, 0.1, (d,)).astype(np.float32)))
            for _ in range(n)]


def toy_x():
    return torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (12, 5, 16)).astype(np.float32))


def toy_pipeline(shape, m, grads=False):
    """The toy stack (tests/test_pipeline.py) through pipeline_apply on a
    (dp, S) mesh: the full output (and the stacked gradients of
    sum(out ** 2)) on rank 0."""
    from visiontransformer_tpu_torch.parallel.multihost import global_batch
    from visiontransformer_tpu_torch.parallel.pipeline import (
        Pipeline,
        create_pipeline_mesh,
        pipeline_apply,
    )

    mesh = create_pipeline_mesh(shape)
    layers = toy_layers()
    pipe = Pipeline(mesh.get_group("stage"), len(layers), m,
                    mesh.get_local_rank("data"), shape[0])
    mine = [(w.clone().requires_grad_(), b.clone().requires_grad_())
            for w, b in layers[pipe.first_layer:
                               pipe.first_layer + pipe.per_stage]]

    def layer_fn(y, microbatch):
        for w, b in mine:
            y = torch.tanh(y @ w + b)
        return y

    x = global_batch(mesh, {"x": toy_x()})["x"]
    out = pipeline_apply(x, layer_fn, pipe, [t for wb in mine for t in wb])
    data = mesh.get_group("data")
    full = launch.all_gather(out.detach(), data)
    result = {"out": _np(full)}
    if grads:
        (out ** 2).sum().backward()
        # Sum over "data" (each data shard saw its rows), then every stage.
        gw = torch.stack([w.grad for w, _ in mine])
        gb = torch.stack([b.grad for _, b in mine])
        for g in (gw, gb):
            launch.all_reduce(g, data)
        stage = mesh.get_group("stage")
        result["w"] = _np(launch.all_gather(gw, stage))
        result["b"] = _np(launch.all_gather(gb, stage))
    return result if launch.is_primary() else None


def toy_reference():
    """The sequential stack on the whole batch: output and gradients."""
    layers = [(w.clone().requires_grad_(), b.clone().requires_grad_())
              for w, b in toy_layers()]
    y = toy_x()
    for w, b in layers:
        y = torch.tanh(y @ w + b)
    (y ** 2).sum().backward()
    return {"out": _np(y), "w": _np(torch.stack([w.grad for w, _ in layers])),
            "b": _np(torch.stack([b.grad for _, b in layers]))}


def pipelined_vitseg(params, images, labels):
    """vitseg_apply_pipelined on a (1, 2) mesh against vitseg_apply:
    logits and the CE gradients, gathered on rank 0."""
    from visiontransformer_tpu_torch.ckpt.convert import load_jax_params
    from visiontransformer_tpu_torch.losses.basic import cross_entropy_loss
    from visiontransformer_tpu_torch.models.vitseg import (
        ViTSeg,
        vitseg_apply,
        vitseg_apply_pipelined,
    )
    from visiontransformer_tpu_torch.parallel.pipeline import (
        Pipeline,
        create_pipeline_mesh,
    )

    cfg = seg_cfg()
    plain = load_jax_params(ViTSeg(cfg), params)
    piped = load_jax_params(ViTSeg(cfg), params)
    mesh = create_pipeline_mesh((1, 2))
    pipe = Pipeline(mesh.get_group("stage"), 2, 2)
    piped.backbone.layers = torch.nn.ModuleList(
        list(piped.backbone.layers)[pipe.first_layer:pipe.first_layer + 1])
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    want = vitseg_apply(plain, x)
    got = vitseg_apply_pipelined(piped, x, pipe)
    cross_entropy_loss(want, y).backward()
    cross_entropy_loss(got, y).backward()
    grads = {n: p.grad for n, p in piped.named_parameters()}
    layer = f"backbone.layers.{pipe.first_layer}."
    mine = {n.replace("backbone.layers.0.", layer): g
            for n, g in grads.items()}
    gathered = [None] * 2
    dist.all_gather_object(gathered, {k: _np(v) for k, v in mine.items()})
    if not launch.is_primary():
        return None
    merged = {**gathered[1], **gathered[0]}
    return {"got": _np(got), "want": _np(want), "grads": merged,
            "want_grads": {n: _np(p.grad) for n, p in
                           plain.named_parameters()}}


def pipeline_dropout():
    """Two pipeline steps with dropout on (seeded init), then an eval
    step on the same batch."""
    trainer = _trainer("ce", {"mesh_shape": (1, 2), "pipeline_stages": 2,
                              "pipeline_microbatches": 2,
                              "accumulate_grad_batches": 1}, CLASSES,
                       dropout=True)
    state = trainer.init_state()
    batch = ce_batch()
    losses = []
    for i in range(2):
        state, metrics = trainer.train_step(state, batch, seed=i + 1)
        losses.append(float(metrics["loss"]))
    eval_loss = float(trainer.eval_step(state.model, batch)["loss"])
    return ({"losses": losses, "step": state.step, "eval_loss": eval_loss}
            if launch.is_primary() else None)


def seq_parallel_forward(params, images):
    """vitseg_apply with the residual stream token-sharded over a (1, 2)
    mesh against the plain forward, and the shard lengths."""
    from visiontransformer_tpu_torch.ckpt.convert import load_jax_params
    from visiontransformer_tpu_torch.models.vitseg import ViTSeg, vitseg_apply
    from visiontransformer_tpu_torch.parallel.mesh import create_mesh
    from visiontransformer_tpu_torch.parallel.tensor import parallelize_vit

    cfg = seg_cfg()
    plain = load_jax_params(ViTSeg(cfg), params)
    sp = load_jax_params(ViTSeg(cfg), params)
    parallelize_vit(sp.backbone, create_mesh((1, 2)), seq_parallel=True)
    x = torch.from_numpy(images)
    with torch.no_grad():
        got, want = vitseg_apply(sp, x), vitseg_apply(plain, x)
    tp = sp.backbone.layers[0].tp
    lengths = [None] * 2
    dist.all_gather_object(lengths, tp.token_range(cfg.vit.seq_len))
    return ({"got": _np(got), "want": _np(want), "ranges": lengths}
            if launch.is_primary() else None)


# --------------------------------------------------------------- dropout
def dropout_rules():
    """The dropout rules under a mesh, by what each rank draws."""
    from visiontransformer_tpu_torch.parallel.mesh import create_mesh
    from visiontransformer_tpu_torch.parallel.tensor import TensorParallel

    out = {}
    batch = ce_batch()
    # Identical rows on both data ranks: different draws only if the seeds
    # differ by data rank.
    batch = {k: np.concatenate([v[:4], v[:4], v[:4], v[:4]])
             for k, v in batch.items()}
    for key, mode in (("dp", {"mesh_shape": (2,)}),
                      ("tp", {"mesh_shape": (1, 2)}),
                      ("sp", {"mesh_shape": (1, 2), "seq_parallel": True})):
        trainer = _trainer("ce", mode, CLASSES, dropout=True)
        state = trainer.init_state()
        local = []
        task = trainer.task_fn

        def recording(*args, **kwargs):
            loss, metrics = task(*args, **kwargs)
            local.append(float(loss))
            return loss, metrics

        trainer.task_fn = recording
        trainer.train_step(state, batch, seed=3)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, local)
        out[key] = every
    tp = TensorParallel(create_mesh((1, 2)).get_group("model"), False)
    g = torch.Generator().manual_seed(11)
    seeds = [None] * 2
    dist.all_gather_object(seeds, [tp.fork(g).initial_seed(),
                                   tp.fork(g).initial_seed(),
                                   g.initial_seed()])
    out["fork_seeds"] = seeds
    return out if launch.is_primary() else None


# ------------------------------------------------ fit and checkpoints
def fit_csv(mode, data_dir, logs, params):
    """Trainer.fit for two epochs with a CSV log (every rank passes one):
    the rows rank 0 wrote, and whether any other rank wrote a file."""
    from visiontransformer_tpu_torch.data import CESegmentationDataset
    from visiontransformer_tpu_torch.train.trainer import Trainer
    from visiontransformer_tpu_torch.utils.csvlog import CSVLogger

    data = CESegmentationDataset(f"{data_dir}/image_png",
                                 f"{data_dir}/mask_png", image_size=32)
    rank = dist.get_rank() if dist.is_initialized() else 0
    logger = CSVLogger(f"{logs}/rank{rank}")
    cfg = dataclasses.replace(train_cfg(**mode), batch_size=4,
                              accumulate_grad_batches=2, log_every_n_steps=1,
                              max_epochs=2)
    trainer = Trainer(seg_cfg(classes=data.num_classes), cfg, device="cpu",
                      logger=logger)
    trainer.fit(data, val_dataset=data, state=trainer.init_state(params))
    wrote = [None] * (dist.get_world_size() if dist.is_initialized() else 1)
    mine = os.path.exists(os.path.join(logger.log_dir, "metrics.csv"))
    if dist.is_initialized():
        dist.all_gather_object(wrote, mine)
    else:
        wrote = [mine]
    if not launch.is_primary():
        return None
    with open(os.path.join(logger.log_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    return {"rows": rows, "wrote": wrote}


def save_modes(modes, root, params):
    """One step in each mode, then a checkpoint (every rank takes part):
    {key: (path, gathered params, gathered optimizer state)}, both in the
    per-layer form."""
    from visiontransformer_tpu_torch.parallel.state import match_layer_form

    out = {}
    for key, mode in modes:
        trainer = _trainer("ce", mode, CLASSES)
        state = trainer.init_state(params)
        trainer.train_step(state, ce_batch(), seed=0)
        path = trainer.save(state, f"{root}/{key}", epoch=0)
        full = trainer.plan.gather_state(state.model, state.optimizer)
        if full is not None:
            params, opt = match_layer_form(*full, stacked=False)
            out[key] = (path, {k: _np(v) for k, v in params.items()},
                        _opt_np(opt))
    return out if launch.is_primary() else None


def _opt_np(opt):
    return {"state": {i: {k: (_np(v) if isinstance(v, torch.Tensor) else v)
                          for k, v in s.items()}
                      for i, s in opt["state"].items()},
            "param_groups": opt["param_groups"]}


def resume_modes(modes, path):
    """A mesh trainer resumed from ``path`` through fit (no epoch left to
    train): its gathered state."""
    out = {}
    for key, mode in modes:
        trainer = _trainer("ce", dict(mode, max_epochs=1), CLASSES)
        state = trainer.fit([], state=trainer.init_state(),
                            resume_from=path)
        full = trainer.plan.gather_state(state.model, state.optimizer)
        if full is not None:
            out[key] = ({k: _np(v) for k, v in full[0].items()},
                        _opt_np(full[1]), state.step)
    return out if launch.is_primary() else None


def shape_errors():
    """The TPU package's shape errors, raised inside a job: their
    messages."""
    from visiontransformer_tpu_torch.parallel.pipeline import (
        Pipeline,
        create_pipeline_mesh,
    )

    out = {}
    cases = {
        "batch": lambda: _trainer("ce", {"mesh_shape": (2,),
                                         "batch_size": 6,
                                         "accumulate_grad_batches": 2},
                                  CLASSES),
        "heads": lambda: _trainer("ce", {"mesh_shape": (1, 2)}, CLASSES,
                                  hidden_size=48,
                                  num_attention_heads=3).init_state(),
        "layers": lambda: _trainer("ce", {"pipeline_stages": 2}, CLASSES,
                                   num_hidden_layers=3),
        "microbatches": lambda: _trainer(
            "ce", {"pipeline_stages": 2, "pipeline_microbatches": 3},
            CLASSES),
        "mesh": lambda: _trainer("ce", {"mesh_shape": (3, 1)}, CLASSES),
        "stage_pp": lambda: Pipeline(create_pipeline_mesh((1, 2)).get_group(
            "stage"), 3, 1),
    }
    for key, fn in cases.items():
        try:
            fn()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out if launch.is_primary() else None


def pod_mesh_dims():
    from visiontransformer_tpu_torch.parallel.multihost import pod_mesh

    mesh, dp = pod_mesh(tp=2)
    dims = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    try:
        pod_mesh(tp=3)
        err = None
    except ValueError as e:
        err = str(e)
    return {"dims": dims, "dp": dp, "error": err}


def run_all(calls):
    """[(key, function name, args)] in one job: {key: result}."""
    import sys

    module = sys.modules[__name__]
    out = {}
    for key, name, args in calls:
        out[key] = getattr(module, name)(*args)
    return out if launch.is_primary() else None


# ------------------------------------------- a job started without launch
def own_job_devices(rank, world, init_method):
    """A rank of a job its caller started with ``init_process_group``
    (gloo), not through ``parallel/launch.py``: for each device a mesh
    trainer asks for in turn, the device it trains on or the error it
    raises; then the rank's device and transport."""
    from visiontransformer_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world)
    try:
        asked = []
        for device in (None, "cpu", "cuda"):
            try:
                trainer = Trainer(seg_cfg(), train_cfg(mesh_shape=(2,)),
                                  device=device)
                asked.append(str(trainer.device))
            except (RuntimeError, ValueError) as e:
                asked.append(f"{type(e).__name__}: {e}")
        return {"asked": asked, "rank_device": str(launch.device()),
                "transport": launch.transport()}
    finally:
        dist.destroy_process_group()
