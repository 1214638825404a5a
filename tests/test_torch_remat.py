"""PyTorch port: per-block remat (``ViTConfig.remat``, ``TrainConfig.remat``).

With dropout, the remat forward and backward must equal the plain ones bit
for bit (loss, every gradient, and the dropout generator's state at the
end): the checkpointed block replays its draws from the generator state it
started from. Without dropout, one remat step of the port's Trainer is held
against the JAX Trainer's remat step at the train tolerances of
tests/test_torch_train.py, on its tiny config.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.models.vitseg import vitseg_init
from visiontransformer_tpu.train import tasks as jtasks
from visiontransformer_tpu.train.trainer import Trainer as JaxTrainer
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.ckpt.convert import (
    load_jax_params,
    vitseg_params_from_jax,
)
from visiontransformer_tpu_torch.models.vitseg import ViTSeg, vitseg_apply
from visiontransformer_tpu_torch.train.trainer import Trainer

VIT = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CLASSES = 5
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jcfg.ViTSegConfig(vit=jcfg.ViTConfig(**VIT), num_classes=CLASSES)
    return jax.tree_util.tree_map(
        np.asarray, vitseg_init(jax.random.PRNGKey(0), cfg))


def _model(jax_params, **vit):
    cfg = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**VIT, **vit),
                            num_classes=CLASSES)
    return load_jax_params(ViTSeg(cfg), jax_params).train()


def _backward(model, x, weights, attn_impl, seed=3):
    """A summed-logits loss with dropout from a generator seeded with
    ``seed``: (loss, gradients by name, the generator's state after the
    backward)."""
    generator = torch.Generator().manual_seed(seed)
    loss = (vitseg_apply(model, x, attn_impl=attn_impl, deterministic=False,
                         generator=generator) * weights).sum()
    loss.backward()
    return (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
            generator.get_state())


@pytest.mark.parametrize("r", [0, 2])
@pytest.mark.parametrize("attn_impl", ["eager", "flash"])
def test_remat_equals_plain_bit_for_bit_with_dropout(rng, jax_params,
                                                     attn_impl, r):
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    weights = torch.from_numpy(rng.standard_normal(
        (2, 32, 32, CLASSES)).astype(np.float32))
    runs = {}
    for remat in (False, True):
        model = _model(jax_params, remat=remat, token_merge_r=r)
        calls = []
        model.backbone.layers[0].ln1.register_forward_hook(
            lambda *_: calls.append(1))
        runs[remat] = _backward(model, x, weights, attn_impl)
        # The checkpointed block runs again in the backward.
        assert len(calls) == (2 if remat else 1)
    (loss, grads, state), (rloss, rgrads, rstate) = runs[False], runs[True]
    assert torch.equal(loss, rloss)
    for name, grad in grads.items():
        assert torch.equal(grad, rgrads[name]), name
    assert torch.equal(state, rstate)


def test_remat_is_off_without_a_gradient(rng, jax_params):
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    outs = []
    for remat in (False, True):
        model = _model(jax_params, remat=remat).eval()
        with torch.no_grad():
            outs.append(vitseg_apply(model, x))
    assert torch.equal(*outs)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((4, 32, 32, 3), np.float32),
            "mask": rng.integers(0, CLASSES, (4, 256, 256), dtype=np.int32)}


def test_trainer_remat_step_equals_plain_step(jax_params):
    """TrainConfig.remat turns ViTConfig.remat on; one accumulated step with
    dropout gives the same loss, gradients and weights as without."""
    cfg = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**VIT), num_classes=CLASSES)
    results = []
    for remat in (False, True):
        trainer = Trainer(cfg, tcfg.TrainConfig(
            batch_size=4, accumulate_grad_batches=2, remat=remat),
            device="cpu")
        assert trainer.seg_cfg.vit.remat is remat
        state = trainer.init_state(jax_params)
        assert state.model.backbone.cfg.remat is remat
        state, metrics = trainer.train_step(state, _batch(1), seed=5)
        results.append((metrics["loss"],
                        {n: (p.grad, p.detach())
                         for n, p in state.model.named_parameters()}))
    assert torch.equal(results[0][0], results[1][0])
    for name, (grad, value) in results[0][1].items():
        assert torch.equal(grad, results[1][1][name][0]), name
        assert torch.equal(value, results[1][1][name][1]), name
    # remat composes with the mesh fields; a pipeline whose stages do not
    # divide the layers is refused as the TPU package refuses it.
    with pytest.raises(ValueError, match="2 encoder layers must divide "
                                         "over 3 pipeline stages"):
        Trainer(cfg, tcfg.TrainConfig(remat=True, pipeline_stages=3),
                device="cpu")


@pytest.mark.parametrize("attn_impl", ["eager", "flash"])
def test_remat_step_matches_jax_remat_step(jax_params, attn_impl):
    """Dropout off: the port's remat step against the JAX Trainer's
    (TrainConfig.remat), loss within 1e-5, gradients within 5e-5."""
    jcfg_ = jcfg.ViTSegConfig(vit=jcfg.ViTConfig(**VIT, **NO_DROPOUT),
                              num_classes=CLASSES)
    train_cfg = dict(batch_size=4, accumulate_grad_batches=2,
                     learning_rate=LR, remat=True)
    batch = _batch(7)
    jtrainer = JaxTrainer(jcfg_, jcfg.TrainConfig(**train_cfg), task="ce",
                          use_mesh=False)
    assert jtrainer.seg_cfg.vit.remat
    jstate = jtrainer.state_from_params(jax_params)
    jstate, jmetrics = jtrainer.train_step(jstate, batch,
                                           jax.random.PRNGKey(0))
    jnew = vitseg_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         jstate.params))

    cfg = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**VIT, **NO_DROPOUT),
                            num_classes=CLASSES)
    trainer = Trainer(cfg, tcfg.TrainConfig(**train_cfg), device="cpu",
                      attn_impl=attn_impl)
    state, metrics = trainer.train_step(trainer.init_state(jax_params),
                                        batch, seed=0)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    # The updated weights as tests/test_torch_train.py compares them
    # (Adam's first step is lr·g/(|g| + eps)); the gradients against JAX's
    # gradient of the mean micro-batch loss under remat.
    for name, p in state.model.named_parameters():
        diff = np.abs(p.detach().numpy() - jnew[name].numpy())
        assert diff.max() <= 2 * LR, name
    jgrads = _jax_mean_grads(jtrainer.seg_cfg, jax_params, batch)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(),
                                   atol=5e-5, rtol=5e-4, err_msg=name)


def _jax_mean_grads(cfg, params, batch):
    grad_fn = jax.jit(jax.grad(lambda p, b: jtasks.TASKS["ce"](
        p, b, cfg, rng=jax.random.PRNGKey(0), deterministic=False)[0]))
    grads = [grad_fn(params, {k: jnp.asarray(v[i:i + 2])
                              for k, v in batch.items()}) for i in (0, 2)]
    return vitseg_params_from_jax(jax.tree_util.tree_map(
        lambda a, b: np.asarray((a + b) / 2), *grads))

