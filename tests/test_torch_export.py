"""PyTorch port vs the JAX package: the exported serving program and the
custom ops of kernels 1 and 5.

The port's ``ckpt/export.py`` (``torch.export``) is held against the JAX
package's ``ckpt/stablehlo.py`` (``jax.export``) on the same weights, and
against the port's eager ``vitseg_predict``; ``vt::flash_attention_fwd``
and ``vt::upsample_argmax`` pass ``torch.library.opcheck``; ``export-serving
--family`` programs of a conv family, of segformer and of vitseg give
``ModelRunner.predict``'s masks bit for bit. Everything runs
on the CPU, where the ops run their plain versions (their CUDA
implementations are the kernels, checked on the card by chip_smoke.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.ckpt import stablehlo as jexport
from visiontransformer_tpu.models.vitseg import (
    vitseg_apply as jax_vitseg_apply,
    vitseg_init,
)
import visiontransformer_tpu_torch.models.registry as port_registry
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.ckpt.convert import load_jax_params
from visiontransformer_tpu_torch.ckpt.export import (
    export_serving,
    load_serving,
    serving_input_size,
)
from visiontransformer_tpu_torch.ckpt.io import save_checkpoint
from visiontransformer_tpu_torch.cli import main as cli_main
from visiontransformer_tpu_torch.models.vitseg import (
    ViTSeg,
    vitseg_apply,
    vitseg_predict,
)
from visiontransformer_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from visiontransformer_tpu_torch.ops.upsample_argmax import (
    upsample_argmax,
    upsample_argmax_plain,
)
from visiontransformer_tpu_torch.serve.worker import ModelRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128)
CLASSES = 5
# Agreement of the port's masks with the JAX artifact's: both take the fp32
# matrix-form upsample, whose argmax may flip only at a logit near-tie
# (ROADMAP "Parity first"); a flip must sit on a gap of at most twice the
# logits' difference plus TIE_TOL.
MIN_AGREEMENT = 0.9999
TIE_TOL = 1e-5
FLASH_OP = torch.ops.vt.flash_attention_fwd.default
EPILOGUE_OP = torch.ops.vt.upsample_argmax.default


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port model): the same fp32 weights."""
    j = jcfg.ViTSegConfig(vit=jcfg.ViTConfig(**VIT), num_classes=CLASSES)
    t = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**VIT), num_classes=CLASSES)
    params = jax.tree_util.tree_map(
        np.asarray, vitseg_init(jax.random.PRNGKey(0), j))
    return j, params, t, load_jax_params(ViTSeg(t), params).eval()


def _images(seed, batch=8):
    return np.random.default_rng(seed).random(
        (batch, 32, 32, 3)).astype(np.float32)


def _op_nodes(program):
    """(kernel 1 nodes, kernel 5 nodes, plain-version nodes): softmax and
    argmax are what the plain versions would trace."""
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    plain = sum(str(t).startswith("aten.")
                and ("softmax" in str(t) or "argmax" in str(t))
                for t in targets)
    return targets.count(FLASH_OP), targets.count(EPILOGUE_OP), plain


def test_artifact_masks_equal_eager_forward(tmp_path, models):
    _, _, t, model = models
    path = str(tmp_path / "model.pt2")
    meta = export_serving(model, t, out_path=path, batch_size=8)
    assert meta["input_size"] == 32 and meta["batch_size"] == 8
    assert meta["num_classes"] == CLASSES and meta["platforms"] == ["cpu"]
    assert meta["family"] == "vitseg"
    art = load_serving(path, device="cpu")
    assert art.meta == meta
    images = torch.from_numpy(_images(1))
    got = art.call(images)
    with torch.no_grad():
        want = vitseg_predict(model, images, mask_dtype=torch.uint8)
    assert got.dtype == torch.uint8 and got.shape == (8, 32, 32)
    assert torch.equal(got, want)


def test_artifact_agrees_with_jax_artifact(tmp_path, models):
    j, params, t, model = models
    jpath, tpath = str(tmp_path / "jax.hlo"), str(tmp_path / "port.pt2")
    jexport.export_serving(params, j, out_path=jpath, batch_size=8)
    export_serving(model, t, out_path=tpath, batch_size=8)
    x = _images(2)
    want = np.asarray(jexport.load_serving(jpath).call(jnp.asarray(x)))
    got = load_serving(tpath, device="cpu").call(torch.from_numpy(x)).numpy()
    agreement = float((got == want).mean())
    assert agreement >= MIN_AGREEMENT
    flips = got != want
    if flips.any():
        jlogits = np.asarray(jax_vitseg_apply(params, jnp.asarray(x), j))
        with torch.no_grad():
            tlogits = vitseg_apply(model, torch.from_numpy(x)).numpy()
        err = float(np.abs(jlogits - tlogits).max())
        at = jlogits[flips]
        gap = np.abs(np.take_along_axis(at, want[flips][:, None].astype(int), 1)
                     - np.take_along_axis(at, got[flips][:, None].astype(int),
                                          1))
        assert gap.max() <= 2 * err + TIE_TOL


def test_artifact_with_kernels_holds_the_custom_ops(tmp_path, models):
    _, _, t, model = models
    path = str(tmp_path / "model.pt2")
    export_serving(model, t, out_path=path, batch_size=2, attn_impl="flash",
                   epilogue="kernel")
    art = load_serving(path, device="cpu")
    assert _op_nodes(art.program) == (t.vit.num_hidden_layers, 1, 0)
    images = torch.from_numpy(_images(3, batch=2))
    with torch.no_grad():
        want = vitseg_predict(model, images, attn_impl="flash",
                              epilogue="kernel", mask_dtype=torch.uint8)
    assert torch.equal(art.call(images), want)
    # The eager-attention export on the CPU holds the plain forms instead.
    export_serving(model, t, out_path=path, batch_size=2)
    nodes = _op_nodes(load_serving(path, device="cpu").program)
    assert nodes[:2] == (0, 0) and nodes[2] == t.vit.num_hidden_layers + 1


def test_artifact_loads_in_a_fresh_process(tmp_path, models):
    """torch.export.load needs the vt:: ops registered before it reads the
    program: load_serving registers them, in a process that never built
    the model."""
    _, _, t, model = models
    path = str(tmp_path / "model.pt2")
    export_serving(model, t, out_path=path, batch_size=2, attn_impl="flash",
                   epilogue="kernel")
    images = _images(4, batch=2)
    np.save(tmp_path / "images.npy", images)
    with torch.no_grad():
        want = vitseg_predict(model, torch.from_numpy(images),
                              attn_impl="flash", epilogue="kernel",
                              mask_dtype=torch.uint8).numpy()
    code = (
        "import sys, numpy as np, torch\n"
        "from visiontransformer_tpu_torch.ckpt.export import load_serving\n"
        "art = load_serving(sys.argv[1], device='cpu')\n"
        "x = torch.from_numpy(np.load(sys.argv[2]))\n"
        "np.save(sys.argv[3], art.call(x).numpy())\n")
    out = tmp_path / "masks.npy"
    subprocess.run([sys.executable, "-c", code, path,
                    str(tmp_path / "images.npy"), str(out)], check=True,
                   cwd=REPO, timeout=300,
                   env={**os.environ, "OMP_NUM_THREADS": "1"})
    np.testing.assert_array_equal(np.load(out), want)


def test_artifact_refuses_wrong_shape_magic_and_device(tmp_path, models):
    _, _, t, model = models
    path = str(tmp_path / "model.pt2")
    export_serving(model, t, out_path=path, batch_size=2)
    art = load_serving(path, device="cpu")
    with pytest.raises(ValueError, match="exported for shape"):
        art.call(torch.zeros(4, 32, 32, 3))
    junk = str(tmp_path / "junk.bin")
    with open(junk, "wb") as f:
        f.write(b"not an artifact")
    with pytest.raises(ValueError, match="bad magic"):
        load_serving(junk, device="cpu")
    with pytest.raises(ValueError, match=r"exported for \['cpu'\], not cuda"):
        load_serving(path)    # None means CUDA
    with pytest.raises(ValueError, match="not cuda"):
        load_serving(path, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 17, 65])
def test_flash_attention_op(dtype, n):
    gen = torch.Generator().manual_seed(n)
    qkv = torch.randn(2, n, 3, 4, 16, generator=gen).to(dtype)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)    # strided views, as the model's
    torch.library.opcheck(FLASH_OP, (q, k, v))
    with torch.no_grad():
        assert torch.equal(flash_attention(q, k, v),
                           flash_attention_plain(q, k, v))


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.uint8])
def test_upsample_argmax_op(in_dtype, out_dtype):
    x = torch.randn(2, 4, 5, 17,
                    generator=torch.Generator().manual_seed(0)).to(in_dtype)
    torch.library.opcheck(EPILOGUE_OP, (x, 32, 40, out_dtype))
    got = upsample_argmax(x, (32, 40), out_dtype=out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(got, upsample_argmax_plain(x, (32, 40), out_dtype))


@pytest.mark.parametrize("device", ["cpu", "meta"])   # CPU and fake impls
@pytest.mark.parametrize("case", ["strided", "uint8_c300"])
def test_upsample_argmax_op_refuses(device, case):
    """The op itself holds the kernel's contract, so a direct call, or an
    exported program, cannot reach the launch with a strided input or
    with more classes than a uint8 mask holds."""
    if case == "strided":
        x = torch.zeros(1, 5, 4, 17, device=device).transpose(1, 2)
        out_dtype = torch.int32
    else:
        x = torch.zeros(1, 4, 4, 300, device=device)
        out_dtype = torch.uint8
    with pytest.raises(ValueError):
        torch.ops.vt.upsample_argmax(x, 8, 8, out_dtype)


def test_export_serving_command(tmp_path, monkeypatch, models):
    """export-serving from a port checkpoint, checked against the
    checkpoint's own forward."""
    _, _, t, model = models
    monkeypatch.setattr(port_registry, "sweep_by_name",
                        lambda name: tcfg.SweepEntry(0, 8, 64, 2, 4))
    cfg = port_registry.vitseg_config("tiny", num_classes=CLASSES,
                                      input_size=32, compute_dtype="float32")
    trained = port_registry.init_vitseg_(ViTSeg(cfg),
                                         torch.Generator().manual_seed(5))
    ckpt_dir = str(tmp_path / "ckpts")
    save_checkpoint(ckpt_dir, {"params": trained.state_dict(), "step": 5},
                    epoch=1, step=5)
    out = str(tmp_path / "model.pt2")
    assert cli_main(["export-serving", "--ckpt", ckpt_dir, "--config", "tiny",
                     "--num-classes", str(CLASSES), "--input-size", "32",
                     "--batch", "2", "--compute-dtype", "float32",
                     "--device", "cpu", "--out", out]) == 0
    art = load_serving(out, device="cpu")
    images = torch.from_numpy(_images(7, batch=2))
    with torch.no_grad():
        logits = vitseg_apply(trained.eval(), images)
    assert torch.equal(art.call(images), logits.argmax(-1).to(torch.uint8))


@pytest.mark.parametrize("family,config", [("unet", "small"),
                                           ("segformer", "mit_b0"),
                                           ("vitseg", "tiny")])
def test_export_serving_family_masks_equal_runner(tmp_path, monkeypatch,
                                                  family, config):
    """export-serving --family for a conv family, segformer and vitseg
    (a tiny sweep entry): the program's masks equal ModelRunner.predict's
    bit for bit, and its header names the family."""
    monkeypatch.setattr(port_registry, "sweep_by_name",
                        lambda name: tcfg.SweepEntry(0, 8, 64, 2, 4))
    out = str(tmp_path / f"{family}.pt2")
    assert cli_main(["export-serving", "--family", family, "--config",
                     config, "--num-classes", str(CLASSES), "--input-size",
                     "40", "--batch", "2", "--compute-dtype", "float32",
                     "--device", "cpu", "--out", out]) == 0
    art = load_serving(out, device="cpu")
    assert (art.meta["family"], art.meta["input_size"],
            art.meta["batch_size"]) == (family, 40, 2)
    images = np.random.default_rng(11).integers(0, 256, (2, 40, 40, 3),
                                                dtype=np.uint8)
    runner = ModelRunner({"input_size": 40, "config_name": config,
                          "num_classes": CLASSES, "model_family": family},
                         compute_dtype="float32", buckets=(2,), device="cpu")
    got = art.call(torch.from_numpy(images).float() / 255.0)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), runner.predict(images))


def test_export_serving_family_needs_an_input_size(tmp_path, models):
    _, _, t, _ = models
    cfg = port_registry.model_config("unet", "small", num_classes=CLASSES)
    with pytest.raises(ValueError, match="input_size"):
        serving_input_size(cfg, "unet", None)
    assert serving_input_size(cfg, "unet", 48) == 48
    assert serving_input_size(t, "vitseg", None) == 32
    with pytest.raises(SystemExit):
        cli_main(["export-serving", "--family", "segformer", "--config",
                  "mit_b0", "--device", "cpu", "--out",
                  str(tmp_path / "x.pt2")])
    assert not (tmp_path / "x.pt2").exists()
