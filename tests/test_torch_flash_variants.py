"""PyTorch port vs the JAX package: the flash-attention tuning-sweep kernels.

The JAX scripts ``scripts/tune_flash2.py`` and ``scripts/tune_flash3.py``
read ``sys.argv`` when imported, so they are loaded under a patched argv;
their ``variant`` functions run their Pallas kernels in interpret mode off a
TPU. The port's plain versions of kernels 6-9 are held against them on the
same numpy inputs at N = 200 (padded by the JAX call to 256, so keys past N
are masked) and the JAX call's own ``block_k``, and kernels 7 and 9 also at
the edges their Hopper kernels meet (a chain of 64 rows wholly past N, a
256-query block with one live row). The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py. The names of
the designs each instantiation runs on the card and the layout rules the
wrappers check before a launch (TMA's) are pure Python and are held here.

The ``bf16exp`` mode's reference runs in a subprocess with XLA's excess
precision off: by default XLA on the CPU skips the mode's bf16 roundings,
which leaves an exp in fp32, the very thing the mode is priced against.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visiontransformer_tpu_torch.ops import flash_variants as fv
from visiontransformer_tpu_torch.scripts import tune_flash2, tune_flash3
from visiontransformer_tpu_torch.utils import spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BH, N_PAD = 200, 2, 256
ATOL = 2e-5
DTYPES = ("float32", "bfloat16")
VARIANT_BLOCK_KS = (128, 256)  # one and two key chunks of n_pad

# Runs the JAX script (repo argv[1]) bf16exp variant on the q, k, v of the
# .npz argv[2] at n_pad argv[4], for every block_k of argv[5] and dtype of
# argv[6], into the .npz argv[3].
_JAX_BF16EXP = r"""
import importlib.util, os, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
repo, inputs, out, n_pad = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
block_ks, dtypes = sys.argv[5].split(","), sys.argv[6].split(",")
sys.argv = ["tune_flash2.py"]
spec = importlib.util.spec_from_file_location(
    "_jax_tune_flash2", os.path.join(repo, "scripts", "tune_flash2.py"))
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
qkv = np.load(inputs)
results = {}
for dtype in dtypes:
    for block_k in block_ks:
        got = module.variant(*(jnp.asarray(qkv[name], getattr(jnp, dtype))
                               for name in "qkv"), mode="bf16exp",
                             block_q=128, block_k=int(block_k), n_pad=n_pad)
        results[f"{dtype}/{block_k}"] = np.asarray(got.astype(jnp.float32))
np.savez(out, **results)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_sweeps():
    with pytest.MonkeyPatch.context() as mp:
        scripts = {}
        for name in ("tune_flash2", "tune_flash3"):
            mp.setattr(sys, "argv", [f"{name}.py"])
            spec = importlib.util.spec_from_file_location(
                f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            scripts[name] = module
    return scripts


@pytest.fixture(scope="module")
def jax_bf16exp(tmp_path_factory):
    """([q, k, v], {"dtype/block_k": the JAX bf16exp output}), the outputs
    computed with XLA_FLAGS=--xla_allow_excess_precision=false."""
    tmp = tmp_path_factory.mktemp("bf16exp")
    arrays = _qkv(np.random.default_rng(1))
    np.savez(tmp / "qkv.npz", **dict(zip("qkv", arrays)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "PYTHONPATH": os.pathsep.join(
               [REPO, *filter(None, [os.environ.get("PYTHONPATH")])])}
    done = subprocess.run(
        [sys.executable, "-c", _JAX_BF16EXP, REPO, str(tmp / "qkv.npz"),
         str(tmp / "out.npz"), str(N_PAD),
         ",".join(map(str, VARIANT_BLOCK_KS)), ",".join(DTYPES)],
        env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    with np.load(tmp / "out.npz") as out:
        return arrays, {name: torch.from_numpy(out[name]) for name in out}


def _qkv(rng, shape=(BH, N, 64)):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_k", VARIANT_BLOCK_KS)
@pytest.mark.parametrize("mode", fv.MODES)
def test_variant_matches_jax(rng, jax_sweeps, jax_bf16exp, mode, block_k,
                             dtype):
    from chip_smoke import flash_agrees

    if mode == "bf16exp":
        arrays, outputs = jax_bf16exp
        want = outputs[f"{dtype}/{block_k}"]
    else:
        arrays = _qkv(rng)
        want = jax_sweeps["tune_flash2"].variant(
            *(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays), mode=mode,
            block_q=128, block_k=block_k, n_pad=N_PAD)
        want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    got = fv.variant_plain(*(torch.from_numpy(a).to(getattr(torch, dtype))
                             for a in arrays), mode=mode, block_k=block_k)
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    else:
        ok, fields = flash_agrees(got, want.bfloat16())  # the card's bf16 gate
        assert ok, fields


@pytest.mark.parametrize("block_k", VARIANT_BLOCK_KS)
@pytest.mark.parametrize("mode", ["base", "exp2"])
def test_bf16exp_reference_refuses_fp32_exp(jax_bf16exp, mode, block_k):
    # The fp32 bf16exp comparison above tells the mode's bf16 roundings
    # apart: an exp taken in fp32 misses the JAX reference by far more
    # than its tolerance.
    arrays, outputs = jax_bf16exp
    got = fv.variant_plain(*map(torch.from_numpy, arrays), mode=mode,
                           block_k=block_k)
    assert float((got - outputs[f"float32/{block_k}"]).abs().max()) > 10 * ATOL


@pytest.mark.parametrize("name,block_q,block_k", [
    ("dualq", 64, 128), ("dualq", 128, 256), ("quadq", 32, 128),
    ("quadq", 64, 256), ("pvT", 128, 128), ("pvT", 256, 256),
    ("dualq_pvT", 64, 128), ("dualq_pvT", 128, 256)])
def test_chain_kernels_match_jax(rng, jax_sweeps, name, block_q, block_k):
    plain = {"dualq": fv.multiq_plain, "quadq": fv.multiq_plain,
             "pvT": fv.pvt_plain, "dualq_pvT": fv.dualq_pvt_plain}[name]
    arrays = _qkv(rng)
    want = jax_sweeps["tune_flash3"].variant(
        *(jnp.asarray(a) for a in arrays), name=name, block_q=block_q,
        block_k=block_k, n_pad=N_PAD)
    got = plain(*(torch.from_numpy(a) for a in arrays), block_k=block_k)
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                               atol=ATOL, rtol=0)


# (JAX variant name, the port's plain version): kernels 7 and 9.
CHAIN_EDGE_KERNELS = {"dualq": fv.multiq_plain, "quadq": fv.multiq_plain,
                      "dualq_pvT": fv.dualq_pvt_plain}


@pytest.mark.parametrize("block_k", fv.CHAIN_BLOCK_KS)
@pytest.mark.parametrize("n", [1, 65, 257])
@pytest.mark.parametrize("name", list(CHAIN_EDGE_KERNELS))
def test_chain_kernels_match_jax_at_tile_edges(rng, jax_sweeps, name, n,
                                               block_k):
    # The Hopper kernels' edges: N = 1 (one key, one live row), 65 (the
    # second 64-row chain of a warpgroup holds one live row, the block's
    # second warpgroup none) and 257 (a 256-query block with one live row),
    # at both key tiles; the JAX kernels at 64 rows a chain, padded to
    # whole programs.
    nq = {"dualq": 2, "quadq": 4, "dualq_pvT": 2}[name]
    rows = nq * 64
    arrays = _qkv(rng, (BH, n, 64))
    want = jax_sweeps["tune_flash3"].variant(
        *(jnp.asarray(a) for a in arrays), name=name, block_q=64,
        block_k=block_k, n_pad=-(-n // rows) * rows)
    got = CHAIN_EDGE_KERNELS[name](*(torch.from_numpy(a) for a in arrays),
                                   block_k=block_k)
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("kernel,kwargs,plain", [
    (fv.flash_variant, {"mode": "bf16exp", "block_k": 32},
     lambda *t: fv.variant_plain(*t, mode="bf16exp", block_k=32)),
    (fv.flash_multiq, {"chains": 4, "block_k": 64},
     lambda *t: fv.multiq_plain(*t, block_k=64)),
    (fv.flash_pvt, {"block_k": 32}, lambda *t: fv.pvt_plain(*t, block_k=32)),
    (fv.flash_dualq_pvt, {"block_k": 64},
     lambda *t: fv.dualq_pvt_plain(*t, block_k=64))])
def test_wrappers_run_plain_on_cpu(rng, kernel, kwargs, plain):
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(rng, (2, 3, 70, 64)))
    launches = spans.counters()
    got = kernel(q, k, v, **kwargs)
    assert torch.equal(got, plain(q, k, v))
    # (BH, N, d) as the JAX scripts pass it gives the same rows.
    flat = [t.reshape(6, 70, 64) for t in (q, k, v)]
    assert torch.equal(kernel(*flat, **kwargs), got.reshape(6, 70, 64))
    # The CPU launches no kernel.
    assert (spans.counters().get(kernel.__name__, 0)
            == launches.get(kernel.__name__, 0))


def test_wrappers_reject():
    x = torch.zeros(2, 8, 32)
    for kernel in (fv.flash_variant, fv.flash_multiq, fv.flash_pvt,
                   fv.flash_dualq_pvt):
        with pytest.raises(ValueError, match="head dim"):
            kernel(x, x, x)
    with pytest.raises(ValueError, match="head dim"):
        fv.variant_plain(x, x, x)
    y = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="mode"):
        fv.flash_variant(y, y, y, mode="exp10")
    with pytest.raises(ValueError, match="block_k"):
        fv.flash_variant(y, y, y, block_k=48)
    with pytest.raises(ValueError, match="block_k"):
        fv.flash_pvt(y, y, y, block_k=128)
    with pytest.raises(ValueError, match="chains"):
        fv.flash_multiq(y, y, y, chains=3)
    # Neither CPU nor CUDA: the wrapper raises instead of running anything.
    m = torch.zeros(2, 8, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="device"):
        fv.flash_dualq_pvt(m, m, m)


@pytest.mark.parametrize("mode", fv.MODES)
@pytest.mark.parametrize("block_k", fv.VARIANT_BLOCK_KS)
def test_variant_path_names_every_instantiation(mode, block_k):
    # Kernel 6 runs one design at every mode and key tile, so that the
    # sweep's cases differ by the one lever.
    assert fv.variant_path(mode, block_k) == "wgmma_tma"


@pytest.mark.parametrize("block_k", fv.CHAIN_BLOCK_KS)
@pytest.mark.parametrize("chains,transposed,design", [
    (2, False, "wgmma_tma"), (4, False, "wgmma_tma"), (1, True, "wgmma_tma"),
    (2, True, "wgmma_tma")])
def test_chains_path_names_every_instantiation(chains, transposed, design,
                                               block_k):
    # Kernels 7-9 run kernel 6's design, so that the sweep's chains and
    # transpose are each the one difference from its rows form.
    assert fv.chains_path(chains, transposed, block_k) == design


def test_design_names_refuse_what_no_kernel_runs():
    with pytest.raises(ValueError, match="mode"):
        fv.variant_path("exp10", 64)
    with pytest.raises(ValueError, match="block_k"):
        fv.variant_path("base", 48)
    with pytest.raises(ValueError, match="block_k"):
        fv.chains_path(1, True, 128)
    for chains, transposed in ((1, False), (4, True), (3, False)):
        with pytest.raises(ValueError, match="no kernel"):
            fv.chains_path(chains, transposed, 64)
        # Refused before the library is looked for.
        with pytest.raises(ValueError, match="no kernel"):
            fv.chains_info(chains, transposed, 64)


def _fused_qkv(b=2, n=70, h=3):
    """q, k, v as the model passes them: slices of one (B, N, 3, H, 64)
    projection, (B, H, N, 64) views read in place."""
    qkv = torch.zeros(b, n, 3, h, 64, dtype=torch.bfloat16)
    return tuple(qkv.permute(2, 0, 3, 1, 4))


WRAPPERS = ("flash_variant", "flash_multiq", "flash_pvt", "flash_dualq_pvt")


@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_views_take_strided_slices(name):
    q, k, v = _fused_qkv()
    views = fv.kernel_views(name, q, k, v)
    assert [t.data_ptr() for t in views] == [q.data_ptr(), k.data_ptr(),
                                            v.data_ptr()]
    # (BH, N, d) gains the batch axis of length 1.
    flat = torch.zeros(6, 70, 64, dtype=torch.bfloat16)
    assert fv.kernel_views(name, flat, flat, flat)[0].shape == (
        1, 6, 70, 64)


@pytest.mark.parametrize("name", WRAPPERS)
@pytest.mark.parametrize("bad", ["misaligned base", "odd row stride",
                                 "strided last dim"])
def test_kernel_views_refuse_unreadable_layouts(name, bad):
    # Every kernel reads 16-byte rows: a base off a 16-byte boundary, a row
    # stride that is not a multiple of 16 bytes, or a strided last
    # dimension raise ValueError before any launch.
    buf = torch.zeros(2 * 3 * 70 * 128 + 8, dtype=torch.bfloat16)
    x = {"misaligned base": lambda: buf[1:1 + 2 * 3 * 70 * 64].view(
             2, 3, 70, 64),
         "odd row stride": lambda: buf[:2 * 3 * 70 * 68].view(
             2, 3, 70, 68)[..., :64],
         "strided last dim": lambda: buf[:2 * 3 * 70 * 128].view(
             2, 3, 70, 128)[..., ::2]}[bad]()
    y = torch.zeros(2, 3, 70, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        fv.kernel_views(name, x, y, y)


@pytest.mark.parametrize("name", WRAPPERS)
@pytest.mark.parametrize("expand", ["heads", "batch"])
def test_kernel_views_refuse_what_tma_cannot_read(name, expand):
    # A key shared across heads (or batches) by a stride of 0: TMA takes no
    # stride of 0 on a dimension longer than 1, so every kernel, 7 and 9
    # too since they read through TMA, refuses it before a launch.
    q = torch.zeros(2, 3, 70, 64, dtype=torch.bfloat16)
    k = (torch.zeros(2, 1, 70, 64, dtype=torch.bfloat16).expand(2, 3, 70, 64)
         if expand == "heads" else
         torch.zeros(1, 3, 70, 64, dtype=torch.bfloat16).expand(2, 3, 70, 64))
    with pytest.raises(ValueError, match=f"{name}: TMA"):
        fv.kernel_views(name, q, k, q)
    # On the CPU the wrapper runs the plain version, whatever the layout.
    kernel = getattr(fv, name)
    assert torch.equal(kernel(q, k, q), fv.variant_plain(q, k, q))


def test_launch_strides_give_tma_a_stride_for_length_one_axes():
    # A length-1 axis may carry any stride (0 after expand); the kernels
    # never step along it, and TMA is given 8 elements (16 bytes) there.
    q = torch.zeros(2, 3, 70, 64, dtype=torch.bfloat16)
    one = torch.zeros(1, 64, dtype=torch.bfloat16).expand(1, 1, 1, 64)
    assert fv._launch_strides(q) == [3 * 70 * 64, 70 * 64, 64]
    assert fv._launch_strides(q[:1]) == [8, 70 * 64, 64]
    assert fv._launch_strides(one) == [8, 8, 8]
    assert fv.kernel_views("test", one, one, one)[0] is one


@pytest.mark.parametrize("sweep,cases", [
    (tune_flash2, [f"{m} (block_k={b})" for m in fv.MODES
                   for b in fv.VARIANT_BLOCK_KS]),
    (tune_flash3, [f"{name} (block_k={b})" for name in tune_flash3.KERNELS
                   for b in fv.CHAIN_BLOCK_KS] + ["best variant"])])
def test_sweep_runs_on_cpu(capsys, sweep, cases):
    assert sweep.main(["200", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("N=200 bh=2 d=64 bf16 on cpu")
    for label in ["production kernel", "F.scaled_dot_product_attention",
                  *cases]:
        assert any(line.startswith(label) for line in lines), label
    errs = [float(line.split()[-1]) for line in lines if "rel err" in line]
    assert len(errs) == (9 if sweep is tune_flash2 else 10)
    assert max(errs) < 1e-2  # bf16 outputs against the production kernel's


@pytest.mark.parametrize("mode", ["base", "bf16exp"])
@pytest.mark.parametrize("n", [1025, 197])
def test_chip_smoke_variant_gate(rng, n, mode):
    # chip_smoke.py's bf16 check of the sweep kernels (bf16exp: its own,
    # looser gate) passes keys taken in another order (the running max then
    # moves at other keys), and refuses an output whose keys past N in the
    # last 64-key tile were scored instead of masked: as the zeros the copy
    # fills in, or as real data.
    from chip_smoke import BF16EXP_TOL, flash_agrees

    tol = BF16EXP_TOL if mode == "bf16exp" else None
    agrees = lambda got, want: flash_agrees(got, want, tol)
    plain = lambda *t: fv.variant_plain(*t, mode=mode, block_k=64)
    pad = -n % 64
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(rng, (1, 2, n + pad, 64)))
    head = lambda t: t[:, :, :n]
    want = plain(head(q), head(k), head(v))
    perm = torch.from_numpy(rng.permutation(n))
    assert agrees(plain(head(q), k[:, :, perm], v[:, :, perm]), want)[0]
    zeros = torch.zeros(1, 2, pad, 64, dtype=torch.bfloat16)
    for tail_k, tail_v in ((zeros, zeros), (k[:, :, n:], v[:, :, n:])):
        bad = head(plain(q, torch.cat([head(k), tail_k], 2),
                         torch.cat([head(v), tail_v], 2)))
        ok, fields = agrees(bad, want)
        assert not ok, fields


@pytest.mark.parametrize("block_k", [32, 128])
@pytest.mark.parametrize("n", [1025, 197, 3137])
def test_chip_smoke_bf16exp_card_gate(rng, n, block_k):
    # chip_smoke.py's tight check of the bf16exp kernel, against the plain
    # version that rounds its exp as the card does, refuses an output with
    # exp taken in fp32 (base and exp2 modes) and one with torch's bf16 exp
    # (the TPU kernel's rounding), at the chip_smoke shapes' N.
    from chip_smoke import BF16EXP_CARD_TOL, flash_agrees

    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(rng, (2, n, 64)))
    want = fv.bf16exp_card_plain(q, k, v, block_k=block_k)
    for mode in fv.MODES:
        got = fv.variant_plain(q, k, v, mode=mode, block_k=block_k)
        ok, fields = flash_agrees(got, want, BF16EXP_CARD_TOL)
        assert not ok, (mode, fields)
        assert fields["rel_err_norm"] > 5 * BF16EXP_CARD_TOL[2], (mode, fields)
