"""PyTorch port vs the JAX package: the parallel layout, without training.

The port's layout rules (``parallel/mesh.py``, ``parallel/pipeline.py``)
are held leaf by leaf to the JAX package's ``param_shardings`` and
``pipeline_param_shardings`` (test_mesh.py:test_param_shardings_megatron_layout,
test_fsdp.py:test_fsdp_spec_layout), with names mapped through the weight
bridge; the fused QKV splits by heads; the token shards of sequence
parallelism; the stacked checkpoint form against ``stack_stage_params``;
the shape errors the TPU package raises, with its messages; the serving
mesh (``ModelRunner(mesh_shape=(dp,))``) against one replica; and the
launcher's rules (backend, failures and timeouts of a rank).
"""

import argparse

import numpy as np
import pytest
import torch

import jax

from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.models import vitseg_init
from visiontransformer_tpu.parallel.mesh import create_mesh as jcreate_mesh
from visiontransformer_tpu.parallel.mesh import param_shardings
from visiontransformer_tpu.parallel.pipeline import (
    create_pipeline_mesh as jcreate_pipeline_mesh,
)
from visiontransformer_tpu.parallel.pipeline import (
    pipeline_param_shardings,
)
from visiontransformer_tpu.parallel.pipeline import (
    stack_stage_params as jstack,
)
from visiontransformer_tpu.train.trainer import Trainer as JaxTrainer
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.ckpt.convert import vitseg_params_from_jax
from visiontransformer_tpu_torch.models.vitseg import ViTSeg
from visiontransformer_tpu_torch.parallel import launch
from visiontransformer_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FSDP_MIN_SIZE,
    MODEL_AXIS,
    create_mesh,
    param_placements,
)
from visiontransformer_tpu_torch.parallel.multihost import (
    global_batch,
    local_shard,
)
from visiontransformer_tpu_torch.parallel.pipeline import (
    STAGE_AXIS,
    is_stacked,
    maybe_unstack_params,
    pipeline_param_placements,
    stack_stage_params,
    unstack_stage_params,
)
from visiontransformer_tpu_torch.parallel.state import (
    stack_train_state,
    unstack_train_state,
)
from visiontransformer_tpu_torch.parallel.tensor import (
    TensorParallel,
    head_columns,
    local_slice,
)
from visiontransformer_tpu_torch.train.trainer import Trainer

import torch_parallel_ranks as R


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(layers=2):
    return jcfg.ViTSegConfig(vit=jcfg.ViTConfig(
        **{**R.TINY_VIT, "num_hidden_layers": layers}), num_classes=R.CLASSES)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, vitseg_init(
        jax.random.PRNGKey(0), _jax_cfg()))


def _port_model():
    return ViTSeg(R.seg_cfg())


def _spec(spec) -> tuple:
    """A spec as a tuple without trailing Nones (P("data", None) is
    P("data"))."""
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _jax_specs(shardings) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): _spec(s.spec) for path, s in flat}


# ---------------------------------------------------------------- layout
@pytest.mark.parametrize("shape", [(4, 2), (8, 1)], ids=["dp4xtp2", "dp8"])
def test_param_placements_megatron_layout_match_jax(eight_devices, jax_params,
                                                    shape):
    """test_mesh.py:test_param_shardings_megatron_layout: every
    parameter's spec equals the JAX package's, leaf by leaf."""
    want = _jax_specs(param_shardings(
        jcreate_mesh(shape, devices=eight_devices), jax_params))
    got = {k: _spec(v) for k, v in
           param_placements(_port_model(), shape).items()}
    assert set(got) == set(vitseg_params_from_jax(jax_params)) == set(want)
    assert got == want
    split = [k for k, v in got.items() if MODEL_AXIS in v]
    assert len(split) == 6 * R.TINY_VIT["num_hidden_layers"]
    assert got["backbone.layers.0.qkv.kernel"] == (None, MODEL_AXIS)
    assert got["backbone.layers.0.attn_out.kernel"] == (MODEL_AXIS,)
    assert got["head_conv1.kernel"] == ()


@pytest.mark.parametrize("family,encoder", [("unet", "small"),
                                            ("segformer", "mit_b0")])
def test_conv_families_stay_replicated_over_model(eight_devices, family,
                                                  encoder):
    """The name rule splits no parameter of a conv family or segformer
    over "model" (the JAX package's param_shardings neither), so under
    tp > 1 their "model" ranks hold whole replicas."""
    from visiontransformer_tpu.models import registry as jregistry
    from visiontransformer_tpu_torch.models import registry as tregistry

    jfam = jregistry.get_model_family(family)
    params = jax.eval_shape(lambda: jfam.init(
        jax.random.PRNGKey(0), jfam.config_cls(encoder_name=encoder,
                                               num_classes=R.CLASSES)))
    want = _jax_specs(param_shardings(
        jcreate_mesh((4, 2), devices=eight_devices), params))
    tfam = tregistry.get_model_family(family)
    model = tfam.init(torch.Generator().manual_seed(0), tfam.config_cls(
        encoder_name=encoder, num_classes=R.CLASSES))
    got = param_placements(model, (4, 2))
    # norm_mean/norm_std are the port's buffers (ROADMAP queue 3).
    assert set(got) == set(want) - {"norm_mean", "norm_std"}
    assert all(v == () for v in got.values())
    assert all(v == () for v in want.values())


@pytest.mark.parametrize("shape,min_size", [((4, 2), 0),
                                            ((4, 2), FSDP_MIN_SIZE),
                                            ((8, 1), 0)])
def test_fsdp_placements_match_jax(eight_devices, jax_params, shape,
                                   min_size):
    """test_fsdp.py:test_fsdp_spec_layout: "data" on the largest free
    dp-divisible axis of every leaf of at least ``min_size`` elements, as
    the JAX package places it."""
    want = _jax_specs(param_shardings(
        jcreate_mesh(shape, devices=eight_devices), jax_params, fsdp=True,
        fsdp_min_size=min_size))
    got = {k: _spec(v) for k, v in param_placements(
        _port_model(), shape, fsdp=True, fsdp_min_size=min_size).items()}
    assert got == want
    if min_size == 0 and shape == (4, 2):
        assert got["backbone.layers.0.qkv.kernel"] == (DATA_AXIS, MODEL_AXIS)
        assert got["backbone.layers.0.attn_out.kernel"] == (MODEL_AXIS,
                                                            DATA_AXIS)
        assert got["backbone.layers.0.ln1.scale"] == (DATA_AXIS,)
    if min_size == FSDP_MIN_SIZE:
        assert got["backbone.layers.0.ln1.scale"] == ()


def test_pipeline_placements_match_jax(eight_devices):
    """Stacked encoder layers over "stage", the rest replicated
    (pipeline_param_shardings)."""
    params = vitseg_init(jax.random.PRNGKey(0), _jax_cfg(layers=4))
    params = dict(params, backbone=dict(
        params["backbone"], layers=jstack(params["backbone"]["layers"])))
    want = _jax_specs(pipeline_param_shardings(
        jcreate_pipeline_mesh((4, 2), devices=eight_devices), params))
    stacked = stack_stage_params(ViTSeg(R.seg_cfg(
        num_hidden_layers=4)).state_dict())
    got = {k: _spec(v) for k, v in pipeline_param_placements(
        list(stacked)).items()}
    assert got == want
    assert got["backbone.layers.qkv.kernel"] == (STAGE_AXIS,)


def test_stacked_form_matches_jax(jax_params):
    """stack_stage_params on the port's state dict is the JAX package's
    stacked tree through the bridge; unstack and maybe_unstack invert it."""
    flat = vitseg_params_from_jax(jax_params)
    want = vitseg_params_from_jax(dict(jax_params, backbone=dict(
        jax_params["backbone"],
        layers=jstack(jax_params["backbone"]["layers"]))))
    got = stack_stage_params(flat)
    assert list(got) == list(want) and is_stacked(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    back = unstack_stage_params(got)
    assert list(back) == list(flat)
    for k in flat:
        assert torch.equal(back[k], flat[k]), k
    assert maybe_unstack_params(flat) is flat
    assert list(maybe_unstack_params(got)) == list(flat)


def test_stacked_train_state_round_trip():
    """The optimizer state follows its parameters into the stacked form
    and back (ids in the params' order), the step count kept."""
    model = _port_model()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sd = opt.state_dict()
    stacked, sopt = stack_train_state(params, sd)
    names = list(stacked)
    i = names.index("backbone.layers.qkv.kernel")
    want = torch.stack([sd["state"][list(params).index(
        f"backbone.layers.{j}.qkv.kernel")]["exp_avg"] for j in range(2)])
    assert torch.equal(sopt["state"][i]["exp_avg"], want)
    assert sopt["param_groups"][0]["params"] == list(range(len(names)))
    flat, fopt = unstack_train_state(stacked, sopt)
    assert list(flat) == list(params)
    for k, v in sd["state"].items():
        for key in v:
            assert torch.equal(fopt["state"][k][key], v[key]), (k, key)


# ------------------------------------------------------------- the QKV split
def test_fused_qkv_splits_by_heads():
    """Rank r of tp holds q, k and v of heads [r·nh/tp, (r+1)·nh/tp), in
    the fused layout's (3, nh, hd) order, not a contiguous column block;
    gather_full puts the parts back."""
    hidden, heads, tp = 64, 4, 2
    hd = hidden // heads
    kernel = torch.arange(hidden * 3 * hidden, dtype=torch.float32).reshape(
        hidden, 3 * hidden)
    for rank in range(tp):
        cols = head_columns(hidden, heads, rank, tp)
        want = torch.cat([torch.arange(part * hidden + rank * 2 * hd,
                                       part * hidden + (rank + 1) * 2 * hd)
                          for part in range(3)])
        assert torch.equal(cols, want)
        contiguous = torch.arange(rank * 3 * hidden // tp,
                                  (rank + 1) * 3 * hidden // tp)
        assert not torch.equal(cols, contiguous)
        local = local_slice("backbone.layers.0.qkv.kernel", kernel, heads,
                            rank, tp)
        assert torch.equal(local, kernel[:, want])
        # q, k and v of one local head are the same head's.
        q, k, v = local.reshape(hidden, 3, heads // tp, hd).unbind(1)
        full = kernel.reshape(hidden, 3, heads, hd)
        assert torch.equal(q, full[:, 0, rank * 2:(rank + 1) * 2])
        assert torch.equal(v, full[:, 2, rank * 2:(rank + 1) * 2])
    with pytest.raises(ValueError, match="heads do not divide"):
        head_columns(48, 3, 0, 2)


def test_local_slice_follows_the_megatron_rule():
    """mlp_in splits its output columns (and bias), attn_out its input
    rows; LayerNorms and biases of row-parallel layers stay whole."""
    t = torch.arange(64 * 128, dtype=torch.float32).reshape(64, 128)
    assert torch.equal(local_slice("b.layers.0.mlp_in.kernel", t, 4, 1, 2),
                       t[:, 64:])
    assert torch.equal(local_slice("b.layers.0.mlp_out.kernel", t.T, 4, 1,
                                   2), t.T[64:])
    bias = torch.arange(64.0)
    assert local_slice("b.layers.0.attn_out.bias", bias, 4, 1, 2) is bias
    assert local_slice("b.layers.0.ln1.scale", bias, 4, 1, 2) is bias


def test_token_shards_of_uneven_sequences():
    """ceil(N/tp) tokens a shard, the last one shorter: N = 197 at tp = 2
    gives 99 and 98, the TINY config's N = 5 gives 3 and 2."""
    def ranges(n, tp):
        out = []
        for rank in range(tp):
            shard = TensorParallel.__new__(TensorParallel)
            shard.size, shard.rank = tp, rank
            out.append(shard.token_range(n))
        return out

    assert ranges(197, 2) == [(0, 99), (99, 197)]
    assert ranges(5, 2) == [(0, 3), (3, 5)]
    assert ranges(5, 4) == [(0, 2), (2, 4), (4, 5), (5, 5)]


# ------------------------------------------------------------ shape errors
def test_create_mesh_shape_mismatch():
    """test_mesh.py:test_create_mesh_shape_mismatch (outside a job the
    world is this one process); the package exports what the TPU
    package's parallel/__init__.py does, the batch split over "data"."""
    import visiontransformer_tpu.parallel as jparallel
    import visiontransformer_tpu_torch.parallel as tparallel

    with pytest.raises(ValueError, match=r"mesh shape \(3, 2\) != 1 devices"):
        create_mesh((3, 2))
    assert len(tparallel.__all__) == len(jparallel.__all__)
    assert tparallel.batch_sharding() == _spec(jparallel.batch_sharding(
        jcreate_mesh((8, 1))).spec) == (DATA_AXIS,)
    assert tparallel.replicated() == _spec(
        jparallel.replicated(jcreate_mesh((8, 1))).spec) == ()


def test_trainer_shape_errors_match_jax(eight_devices):
    """The pipeline's composition and shape errors, raised before any rank
    is needed, with the TPU package's messages."""
    j, t = _jax_cfg(), R.seg_cfg()
    cases = [
        dict(pipeline_stages=2, fsdp=True),
        dict(pipeline_stages=3),
        dict(pipeline_stages=2, mesh_shape=(4,)),
    ]
    for case in cases:
        kw = dict(batch_size=16, accumulate_grad_batches=2,
                  early_stopping_monitor=None, **case)
        with pytest.raises(ValueError) as want:
            JaxTrainer(j, jcfg.TrainConfig(**kw), task="ce")
        with pytest.raises(ValueError) as got:
            Trainer(t, tcfg.TrainConfig(**kw), device="cpu")
        assert str(got.value) == str(want.value), case


def test_local_rows_errors():
    """local_shard outside a job is the batch; global_batch splits rows
    over the data axis, with the TPU package's error for a ragged one."""
    batch = {"x": np.arange(6)}
    assert local_shard(batch)["x"] is batch["x"]

    class Mesh:
        mesh_dim_names = ("data", "model")

        def get_local_rank(self, name):
            return 1

        def size(self, dim):
            return 4 if dim == 0 else 1

    with pytest.raises(ValueError, match="batch axis 6 of 'x' must be "
                                         "divisible by the data axis 4"):
        global_batch(Mesh(), batch)
    assert list(global_batch(Mesh(), {"x": np.arange(8)})["x"]) == [2, 3]


# ------------------------------------------------------------ serving mesh
def _row():
    return {"id": 1, "name": "m", "num_classes": R.CLASSES,
            "config_name": "P16H512A8", "input_size": 32,
            "checkpoint_path": "", "model_family": "vitseg"}


def test_serving_mesh_matches_one_replica():
    """ModelRunner(mesh_shape=(2,)) splits a bucket's rows over two
    replicas and gathers their masks in row order: the single replica's
    masks (fp32 on the CPU)."""
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    images = np.random.default_rng(0).integers(0, 256, (6, 32, 32, 3),
                                               np.uint8)
    one = ModelRunner(_row(), compute_dtype="float32", device="cpu",
                      buckets=(4, 8))
    two = ModelRunner(_row(), compute_dtype="float32", buckets=(4, 8),
                      mesh_shape=(2,), devices=["cpu", "cpu"])
    assert len(two.replicas) == 2
    for dev, model, stream in two.replicas:
        assert stream is None
        for (n, p), q in zip(model.named_parameters(),
                             one.model.parameters()):
            assert torch.equal(p, q), n
    np.testing.assert_array_equal(two.predict(images), one.predict(images))
    # A 1-device mesh is plain placement.
    assert len(ModelRunner(_row(), device="cpu", buckets=(4,),
                           mesh_shape=(1,)).replicas) == 1


def test_serving_mesh_bucket_error_matches_jax():
    """Every bucket must divide by dp, as the TPU runner requires, with
    its message."""
    from visiontransformer_tpu.serve.worker import ModelRunner as JaxRunner
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    row = dict(_row(), config_name="P16H512A8")
    with pytest.raises(ValueError) as want:
        JaxRunner(row, mesh_shape=(8,))
    with pytest.raises(ValueError) as got:
        ModelRunner(row, mesh_shape=(8,), devices=["cpu"] * 8)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=r"mesh shape \(2,\) != 3 devices"):
        ModelRunner(row, mesh_shape=(2,), devices=["cpu"] * 3,
                    buckets=(2,))


def test_serve_command_keeps_the_buckets_dp_divides():
    """serve --mesh keeps the ladder's rungs that dp divides, as the TPU
    server does."""
    from visiontransformer_tpu_torch.serve.server import build_arg_parser

    assert build_arg_parser().parse_args(["--mesh", "4"]).mesh == "4"


# --------------------------------------------------------------- launcher
def test_backend_rule():
    assert launch.backend_for(torch.device("cpu"), False) == "gloo"
    assert launch.backend_for(torch.device("cuda", 0), True) == "gloo"
    assert launch.backend_for(torch.device("cuda", 0), False) == "nccl"
    assert launch.transport() == "none" and launch.is_primary()


def _fails():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise KeyError("rank one fails")
    dist.barrier()  # rank 0 waits here until the job is torn down
    return 0


def _sleeps():
    import time

    time.sleep(60)


def test_a_failed_rank_fails_the_job_without_a_hang():
    """A rank's exception reaches the caller with its traceback; the rank
    left waiting in a collective is killed; a job past its timeout too."""
    with pytest.raises(RuntimeError, match="rank one fails"):
        launch.spawn(_fails, 2, device_type="cpu", timeout=60)
    with pytest.raises(RuntimeError, match="timed out"):
        launch.spawn(_sleeps, 1, device_type="cpu", timeout=3)


def test_trainer_in_a_job_started_without_launch(tmp_path):
    """In a job the caller started itself (init_process_group, as torchrun
    does), a mesh trainer trains on the device it asked for: CUDA by
    default, which raises on a host without it rather than falling back to
    the CPU; the CPU when asked, which the rank then keeps."""
    if torch.cuda.is_available():
        pytest.skip("holds the answers of a host without CUDA")
    init = "file://" + str(tmp_path / "store")
    ranks = launch.run_processes(R.own_job_devices,
                                 [(r, 2, init) for r in range(2)],
                                 timeout=120)
    for got in ranks:
        first, cpu, cuda = got["asked"]
        assert first.startswith("RuntimeError: CUDA is not available")
        assert cpu == "cpu"
        assert cuda == "ValueError: this rank owns cpu; it cannot run on cuda"
        assert got["rank_device"] == "cpu"
        assert got["transport"] == "gloo"


def test_cuda_jobs_need_a_card_a_rank():
    """Outside the tests and the chip check, a job's ranks each need a
    card of their own."""
    if torch.cuda.device_count() >= 64:
        pytest.skip("a host with 64 cards")
    with pytest.raises(ValueError, match="ranks need 64 cards"):
        launch.spawn(_fails, 64)


def test_train_flags_match_the_jax_commands():
    """train takes the TPU package's parallel flags with its defaults
    (but --compilation-cache, an XLA cache)."""
    from visiontransformer_tpu_torch.cli import _parse_mesh, _train_parser

    args = _train_parser().parse_args(["--data", "d"])
    want = dict(mesh=None, fsdp=False, seq_parallel=False, pipeline=1,
                pipeline_microbatches=None, multihost=False,
                coordinator=None, num_processes=None, process_id=None, tp=1)
    assert {k: getattr(args, k) for k in want} == want
    assert _parse_mesh("4,2") == (4, 2) and _parse_mesh(None) is None
    with pytest.raises(SystemExit):
        _train_parser().parse_args(["--data", "d", "--compilation-cache",
                                    "x"])
    assert isinstance(args, argparse.Namespace)
