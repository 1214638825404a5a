"""Shared checks of the conv-family parity tests
(tests/test_torch_conv_families.py, tests/test_torch_conv_families_2.py).

For a family at an input size: a JAX parameter tree (jitted init, numpy
leaves), seeded numpy images and CE targets, the JAX logits and the
``jax.grad`` of the CE loss, computed once per (family, size) and module;
the port's model holding the same weights through the weight bridge.

Tolerances: fp32 logits at the suite's seg-logit atol, 5e-5
(tests/test_model_parity.py:97-99; measured errors are below 2e-6 at
these sizes); gradients at 5e-5 absolute / 5e-4 relative, the train-step
tolerance of tests/test_torch_train.py.

ReLU near-ties: the two forwards differ by about 1e-6 (the CPU conv
library's sum order), so a ReLU input within that of zero may fall on the
other side of the kink in the port than in JAX, which moves every upstream
gradient by that element's share (up to ~1e-4 at these sizes). It is the
gradient's form of an argmax near-tie. ``relu_decisions`` finds the port's
ReLU inputs within KINK_TOL of zero, and the gradient checks try the port
with subsets of those decisions taken the other way: the gradients must
match JAX's for one of them, and how many were taken the other way is
printed (ROADMAP.md section 3).
"""

import contextlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from visiontransformer_tpu.losses.basic import cross_entropy_loss as jce
from visiontransformer_tpu.models import registry as jregistry
from visiontransformer_tpu_torch.ckpt.convert import (
    conv_params_from_jax,
    load_jax_params,
)
from visiontransformer_tpu_torch.losses.basic import cross_entropy_loss
from visiontransformer_tpu_torch.models import registry as tregistry

CLASSES = 5
LOGITS_ATOL = 5e-5
GRAD_ATOL, GRAD_RTOL = 5e-5, 5e-4
# Argmax agreement with the JAX logits, measured and recorded (ROADMAP.md
# section 3); not asserted exact, since a near-tie may flip.
MIN_AGREEMENT = 0.999
# The norm constants are buffers of the port's model, parameters of the
# JAX tree (ROADMAP.md section 3).
NORM_KEYS = ("norm_mean", "norm_std")
# Ten times the largest forward difference measured (under 2e-6).
KINK_TOL = 1e-5
MAX_NEAR_KINKS = 8


class Reference:
    """(family, size) -> the JAX side of one parity case, made at first
    use and kept for the module."""

    def __init__(self, encoder: str = "small"):
        self.encoder = encoder
        self._cases = {}

    def __call__(self, family: str, size: int = 32):
        key = (family, size)
        if key not in self._cases:
            self._cases[key] = self._make(family, size)
        return self._cases[key]

    def _make(self, family: str, size: int):
        fam = jregistry.get_model_family(family)
        cfg = fam.config_cls(encoder_name=self.encoder, num_classes=CLASSES)
        params = jax.tree_util.tree_map(np.array, jax.jit(
            fam.init, static_argnums=1)(jax.random.PRNGKey(size), cfg))
        rng = np.random.default_rng(size)
        images = rng.random((2, size, size, 3), np.float32)
        target = rng.integers(0, CLASSES, (2, size, size)).astype(np.int32)
        logits = jax.jit(lambda p, x: fam.apply(p, x, cfg))(
            params, jnp.asarray(images))
        grads = jax.jit(jax.grad(lambda p: jce(
            fam.apply(p, jnp.asarray(images), cfg), jnp.asarray(target))))(
                params)
        return {"cfg": cfg, "params": params, "images": images,
                "target": target, "logits": np.asarray(logits),
                "grads": conv_params_from_jax(
                    jax.tree_util.tree_map(np.asarray, grads))}


def port_model(family: str, case) -> torch.nn.Module:
    fam = tregistry.get_model_family(family)
    cfg = fam.config_cls(encoder_name=case["cfg"].encoder_name,
                         num_classes=CLASSES)
    model = fam.init(torch.Generator().manual_seed(0), cfg)
    return load_jax_params(model, case["params"])


def check_logits(family: str, case) -> float:
    """The port's fp32 logits against JAX's; returns the argmax
    agreement."""
    model = port_model(family, case)
    with torch.no_grad():
        got = model(torch.from_numpy(case["images"])).numpy()
    want = case["logits"]
    assert got.shape == want.shape == case["images"].shape[:3] + (CLASSES,)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)
    agreement = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"{family}: max |error| {np.abs(got - want).max():.3g}, "
          f"argmax agreement {agreement:.6f}")
    assert agreement >= MIN_AGREEMENT
    return agreement


@contextlib.contextmanager
def relu_decisions(toggle=()):
    """Within: ``F.relu`` counts its calls, records the (call, flat index)
    of every input within KINK_TOL of zero in ``near``, and takes the
    decision at each (call, flat index) of ``toggle`` the other way
    (gradient 1 for an input below zero, 0 above)."""
    relu, near, calls = F.relu, [], [0]
    by_call = {}
    for call, index in toggle:
        by_call.setdefault(call, []).append(index)

    def patched(x, inplace=False):
        call = calls[0]
        calls[0] += 1
        near.extend((call, int(i)) for i in torch.nonzero(
            x.detach().abs().flatten() < KINK_TOL).flatten())
        if call not in by_call:
            return relu(x, inplace=inplace)
        mask = (x > 0).flatten()
        mask[by_call[call]] = ~mask[by_call[call]]
        return x * mask.reshape(x.shape)

    F.relu = patched
    try:
        yield near
    finally:
        F.relu = relu


def grads_match_with_near_ties(run, want) -> int:
    """``run()`` -> {name: gradient}, computed by the port. Holds them to
    ``want`` at GRAD_ATOL / GRAD_RTOL, with the ReLU decisions at inputs
    within KINK_TOL of zero as the port takes them or, where that fails,
    with subsets of them taken the other way (fewest first). Returns the
    number taken the other way."""
    with relu_decisions() as near:
        got = run()
    assert len(near) <= MAX_NEAR_KINKS, f"{len(near)} ReLU near-ties"
    first_error = None
    for k in range(len(near) + 1):
        for toggle in itertools.combinations(near, k):
            if k:
                with relu_decisions(toggle):
                    got = run()
            try:
                for name, grad in got.items():
                    np.testing.assert_allclose(
                        grad, want[name], atol=GRAD_ATOL, rtol=GRAD_RTOL,
                        err_msg=name)
            except AssertionError as exc:
                first_error = first_error or exc
                continue
            print(f"gradients match with {k} of {len(near)} ReLU near-ties "
                  f"taken the other way")
            return k
    raise first_error


def check_grads(family: str, case) -> None:
    """The gradient of the CE loss with respect to every parameter against
    ``jax.grad``'s."""
    want = {k: v.numpy() for k, v in case["grads"].items()}

    def run():
        model = port_model(family, case)
        loss = cross_entropy_loss(model(torch.from_numpy(case["images"])),
                                  torch.from_numpy(case["target"]))
        loss.backward()
        return {name: p.grad.numpy() for name, p in model.named_parameters()}

    names = {name for name, _ in port_model(family, case).named_parameters()}
    assert names == set(want) - set(NORM_KEYS)
    grads_match_with_near_ties(run, want)
