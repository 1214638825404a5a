"""PyTorch port vs the JAX package: ToMe token merging.

``merge_step``/``unmerge`` (``ops/token_merge.py``) against the JAX
functions on the same tokens: the hand-checked case of
tests/test_token_merge.py, a tie case that only the stable order decides,
random cases and a hypothesis property over the token count, r and the
batch (sizes and tokens within 1e-6, ``assign`` equal as integers); then
the merged vitseg forward and its gradients against JAX's on the tiny
config of tests/test_torch_model.py.
"""

import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.models.vitseg import vitseg_apply as jax_apply
from visiontransformer_tpu.models.vitseg import vitseg_head_logits as jhead
from visiontransformer_tpu.models.vitseg import vitseg_init
from visiontransformer_tpu.models.vitseg import vitseg_predict as jpredict
from visiontransformer_tpu.ops import token_merge as jtm
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.ckpt.convert import (
    load_jax_params,
    vitseg_params_from_jax,
)
from visiontransformer_tpu_torch.models.vitseg import (
    ViTSeg,
    set_token_merge_r,
    vitseg_apply,
    vitseg_head_logits,
    vitseg_predict,
)
from visiontransformer_tpu_torch.ops import token_merge as ttm

VIT = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128)
CLASSES = 5
TOKEN_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _merge_both(x: np.ndarray, r: int, steps: int = 1):
    """``steps`` merges of x by both packages: (port tokens, sizes, assign),
    (JAX tokens, sizes, assign), as numpy."""
    b, n, _ = x.shape
    tx, ts = torch.from_numpy(x), ttm.init_merge_state(b, n)
    for _ in range(steps):
        tx, ts = ttm.merge_step(tx, ts, r)
    return ((tx.numpy(), ts.sizes.numpy(), ts.assign.numpy(),
             ttm.unmerge(tx, ts).numpy()),
            tuple(np.asarray(a) for a in _jax_merges(jnp.asarray(x), r,
                                                     steps)))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_merges(x, r, steps):
    state = jtm.init_merge_state(x.shape[0], x.shape[1])
    for _ in range(steps):
        x, state = jtm.merge_step(x, state, r)
    return x, state.sizes, state.assign, jtm.unmerge(x, state)


def _assert_same(got, want):
    for g, w, name in zip(got, want, ("tokens", "sizes", "assign",
                                      "unmerged")):
        assert g.shape == w.shape, name
        if name == "assign":
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=TOKEN_ATOL, rtol=0,
                                       err_msg=name)


def test_merge_step_hand_checked():
    """tests/test_token_merge.py's case: source (1, 0) merges into the
    colinear destination (3, 0), the 1e-6 norm eps scoring the larger norm
    higher; everything else is a reorder."""
    x = np.array([[[10, 0], [1, 0], [1.1, 0], [0, 5], [7, 7], [0, 1],
                   [3, 0]]], np.float32)
    got, want = _merge_both(x, 1)
    _assert_same(got, want)
    np.testing.assert_allclose(got[0][0], [[10, 0], [1.1, 0], [7, 7],
                                           [2, 0], [0, 5], [0, 1]],
                               atol=1e-6)
    np.testing.assert_array_equal(got[1][0], [1, 1, 1, 2, 1, 1])
    np.testing.assert_array_equal(got[2][0], [0, 3, 1, 4, 2, 5, 3])


def test_merge_ties_follow_the_stable_order():
    """Duplicated tokens: the body cycles through 7 scaled basis vectors,
    so every source scores exactly the same best similarity and the r
    merged sources, and their partners, are decided by the stable sort
    (position order) and the first maximum alone. The merged tokens are
    copies either way; the sizes and assign show the choice."""
    basis = 2.0 * np.eye(8, dtype=np.float32)
    body = basis[np.arange(80) % 7]
    x = np.concatenate([np.full((1, 8), 0.5, np.float32), body])[None]
    got, want = _merge_both(np.repeat(x, 2, axis=0), 10, steps=2)
    _assert_same(got, want)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("b,n,h,r,steps", [
    (3, 17, 8, 3, 2), (2, 197, 64, 8, 3), (2, 50, 16, 30, 1),
    (1, 2, 4, 1, 1), (2, 3, 4, 2, 2), (2, 38, 16, 16, 2)])
def test_merge_step_matches_jax(b, n, h, r, steps):
    x = np.random.default_rng(n).standard_normal((b, n, h)).astype(
        np.float32)
    got, want = _merge_both(x, r, steps)
    _assert_same(got, want)
    np.testing.assert_allclose(got[1].sum(axis=1), np.full(b, n))


BF16_MIN_ASSIGN_AGREEMENT = 0.9


@pytest.mark.parametrize("b,n,h,r,steps", [
    (2, 197, 64, 8, 3), (4, 197, 768, 16, 12), (2, 38, 16, 16, 2)])
def test_merge_step_bf16_agreement_with_jax(record_property, b, n, h, r,
                                            steps):
    """bf16 tokens: the similarity is scored in the activation dtype, so a
    different rounding of the norm can move near-tied scores and with them
    the merge choices. The share of equal ``assign`` entries after each
    step is recorded (1.0 at every step on an x86 CPU with the port's
    norm; with torch.linalg.vector_norm in its place, 0.876, 0.523 and
    0.320 after the three steps at (2, 197, 64)) and held above a floor,
    not to exactness."""
    x = np.random.default_rng(n + h).standard_normal((b, n, h)).astype(
        np.float32)
    tx, ts = torch.from_numpy(x).to(torch.bfloat16), ttm.init_merge_state(
        b, n)
    want = _jax_assigns(jnp.asarray(x, jnp.bfloat16), r, steps)
    shares = []
    for step in range(steps):
        tx, ts = ttm.merge_step(tx, ts, r)
        assert tx.dtype == torch.bfloat16
        assert ts.assign.shape == want[step].shape
        np.testing.assert_allclose(ts.sizes.sum(dim=1).numpy(),
                                   np.full(b, n))
        shares.append(float((ts.assign.numpy()
                             == np.asarray(want[step])).mean()))
    record_property("assign_agreement_per_step", shares)
    print(f"bf16 assign agreement with JAX {(b, n, h, r)}: {shares}")
    assert min(shares) >= BF16_MIN_ASSIGN_AGREEMENT, shares


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_assigns(x, r, steps):
    state, out = jtm.init_merge_state(x.shape[0], x.shape[1]), []
    for _ in range(steps):
        x, state = jtm.merge_step(x, state, r)
        out.append(state.assign)
    return out


@settings(max_examples=20, deadline=None, database=None, derandomize=True)
@given(n=st.integers(1, 40), r=st.integers(0, 25), b=st.integers(1, 3),
       steps=st.integers(1, 3), seed=st.integers(0, 2 ** 16))
def test_merge_step_property(n, r, b, steps, seed):
    """Port and JAX agree, sizes always count the original tokens, and
    assign maps every original position to a live token."""
    x = np.random.default_rng(seed).standard_normal((b, n, 6)).astype(
        np.float32)
    got, want = _merge_both(x, r, steps)
    _assert_same(got, want)
    np.testing.assert_allclose(got[1].sum(axis=1), np.full(b, n), rtol=1e-6)
    assert got[2].min() >= 0 and got[2].max() < got[0].shape[1]


def _configs(r=0, dtype="float32", **vit):
    return (jcfg.ViTSegConfig(vit=jcfg.ViTConfig(**VIT, token_merge_r=r,
                                                 **vit),
                              num_classes=CLASSES, compute_dtype=dtype),
            tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**VIT, token_merge_r=r,
                                                 **vit),
                              num_classes=CLASSES, compute_dtype=dtype))


@pytest.fixture(scope="module")
def jax_params():
    return vitseg_init(jax.random.PRNGKey(0), _configs()[0])


def _port(jax_params, r=0, dtype="float32", **vit):
    model = ViTSeg(_configs(r, dtype, **vit)[1])
    return load_jax_params(model, jax.tree_util.tree_map(np.asarray,
                                                         jax_params)).eval()


@pytest.mark.parametrize("r", [0, 2])
@pytest.mark.parametrize("attn_impl", ["eager", "flash"])
def test_merged_vitseg_matches_jax(rng, jax_params, r, attn_impl):
    """fp32 logits within the seg-logits tolerance of JAX's merged model,
    masks equal; r = 0 bit for bit with the unmerged port."""
    j, _ = _configs(r)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    model = _port(jax_params, r)
    with torch.no_grad():
        logits = vitseg_head_logits(model, torch.from_numpy(x),
                                    attn_impl=attn_impl)
        masks = vitseg_predict(model, torch.from_numpy(x),
                               attn_impl=attn_impl)
        plain = vitseg_head_logits(_port(jax_params), torch.from_numpy(x),
                                   attn_impl=attn_impl)
    want = jhead(jax_params, jnp.asarray(x), j, attn_impl="xla")
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=5e-5)
    np.testing.assert_array_equal(
        masks.numpy(), np.asarray(jpredict(jax_params, jnp.asarray(x), j,
                                           attn_impl="xla")))
    if r == 0:
        assert torch.equal(logits, plain)
    else:
        assert not torch.equal(logits, plain)


def test_final_layer_norm_runs_before_the_unmerge(rng, jax_params):
    """As in the TPU package, the final LayerNorm reads the merged tokens
    (N - layers·r of them) and the unmerge follows it. The LayerNorm acts
    per token, so the other order gives the same values at more cost; this
    holds the order itself."""
    model = _port(jax_params, 3)
    seen = []
    model.backbone.final_ln.register_forward_hook(
        lambda _m, args, _out: seen.append(args[0].shape[1]))
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    with torch.no_grad():
        tokens = model.backbone(x)
    assert seen == [17 - 2 * 3]
    assert tokens.shape[1] == 17


def test_set_token_merge_r_switches_in_place(rng, jax_params):
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    model = _port(jax_params)
    with torch.no_grad():
        plain = vitseg_head_logits(model, x)
        cfg = set_token_merge_r(model, 2)
        merged = vitseg_head_logits(model, x)
        set_token_merge_r(model, 0)
        again = vitseg_head_logits(model, x)
    assert cfg.vit.token_merge_r == 2 and model.cfg is not cfg
    assert model.backbone.cfg.token_merge_r == 0
    assert not torch.equal(plain, merged)
    assert torch.equal(plain, again)


def test_merged_training_gradients_match_jax(rng, jax_params):
    """Gradients through the merge (gathers and one-hot products) of a
    summed-logits loss, dropout off, within the train tolerances."""
    j, _ = _configs(2, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    weights = rng.standard_normal((2, 32, 32, CLASSES)).astype(np.float32)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jax_apply(
        p, jnp.asarray(x), j, attn_impl="xla", deterministic=False,
        rng=jax.random.PRNGKey(0)) * weights)))(jax_params)
    want = vitseg_params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    model = _port(jax_params, 2, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0).train()
    loss = (vitseg_apply(model, torch.from_numpy(x), attn_impl="flash",
                         deterministic=False,
                         generator=torch.Generator().manual_seed(0))
            * torch.from_numpy(weights)).sum()
    loss.backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=5e-5, rtol=5e-4, err_msg=name)
    assert model.backbone.layers[1].qkv.kernel.grad.abs().sum() > 0
