"""The port's training round against the reference, from the same weights.

``jax.random`` streams cannot be reproduced in torch, so both executors
start from the same numpy-made weights in the reference's layout, carried
into the port with ``params_from_jax``.  Tolerances (float32): one
``train_round`` within rtol 1e-5 on the loss and rtol 1e-4 / atol 1e-6 on
the updated parameters (XLA and PyTorch's CPU kernels sum the convolutions
in different orders).  With int8 link hooks the round is held within rtol
1e-3 on the loss and atol 1e-3 on the parameters: an activation that XLA
and PyTorch compute one ulp apart can fall on either side of an int8
rounding boundary and move its code by one step (at B=4 from these weights
that moves the loss by 7e-5 relative and a parameter by 5.4e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.compression import make_link_hooks as r_link_hooks
from repro.models import vgg as r_vgg
from repro.pipeline import SplitLearningExecutor as RefExecutor

import repro_torch.core as T
from repro_torch.compression import make_link_hooks
from repro_torch.data import classification_batches
from repro_torch.models import vgg
from repro_torch.pipeline import (LinkHooks, SplitLearningExecutor,
                                  microbatch_grads, split_batch,
                                  vgg_stages_from_cuts)

_PLAN_FIELDS = dict(b=4, B=8, T_f=1.0, T_i=0.5, L_t=2.0, iterations=1,
                    history=[], solve_seconds=0.0)


def reference_layout_params(seed=0):
    """Weights in the reference's layout (HWIO conv, (fan_in, out) dense)
    at its initializer's scales — a +-2 std truncated normal over
    sqrt(fan_in), He gain on the hidden layers — made with numpy."""
    shapes = jax.eval_shape(r_vgg.init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    out = []
    for i, p in enumerate(shapes):
        w = p["w"].shape
        fan_in = w[0] * w[1] * w[2] if len(w) == 4 else w[0]
        gain = np.sqrt(2.0) if i < len(shapes) - 1 else 1.0
        z = np.clip(rng.standard_normal(size=w), -2.0, 2.0)
        out.append({"w": (z * gain / np.sqrt(fan_in)).astype(np.float32),
                    "b": np.zeros(p["b"].shape, np.float32)})
    return out


@pytest.fixture(scope="module")
def ref_params():
    return reference_layout_params()


def test_microbatch_grads_equal_full_batch():
    """The paper's synchronous-SGD guarantee (Fig. 4: same convergence)."""
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.normal(size=(8, 4)), dtype=torch.float32,
                     requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    batch = {"x": torch.tensor(rng.normal(size=(16, 8)), dtype=torch.float32),
             "y": torch.tensor(rng.normal(size=(16, 4)), dtype=torch.float32)}

    def loss_fn(params, mb):
        pw, pb = params
        return ((mb["x"] @ pw + pb - mb["y"]) ** 2).mean()

    l_full = loss_fn([w, b], batch)
    g_full = torch.autograd.grad(l_full, [w, b])
    l_full = l_full.detach()
    for q in (1, 2, 4, 8, 16):
        l_mb, g_mb = microbatch_grads(loss_fn, [w, b], batch, q)
        assert float(l_mb) == pytest.approx(float(l_full), rel=1e-6)
        for a, c in zip(g_mb, g_full):
            torch.testing.assert_close(a, c, rtol=0, atol=1e-6)
    assert split_batch(batch, 4)["x"].shape == (4, 4, 8)
    with pytest.raises(ValueError):
        split_batch(batch, 5)


def test_train_round_matches_reference(ref_params):
    """B=8, two micro-batches, momentum 0.9, from the same weights."""
    sol = (3, 16), (0, 1)
    rplan = R.Plan(solution=R.SplitSolution(*sol), **_PLAN_FIELDS)
    tplan = T.Plan(solution=T.SplitSolution(*sol), **_PLAN_FIELDS)
    batch = next(classification_batches(batch=8, seed=0))

    ref = RefExecutor(rplan, None, None, seed=0)
    ref.full_params = [{k: jnp.asarray(v) for k, v in p.items()}
                       for p in ref_params]
    want_loss = ref.train_round({k: jnp.asarray(v) for k, v in batch.items()},
                                lr=0.05, momentum=0.9)
    ex = SplitLearningExecutor(tplan, None, None,
                               params=vgg.params_from_jax(ref_params),
                               device="cpu")
    got_loss = ex.train_round(batch, lr=0.05, momentum=0.9)

    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    want = [{k: np.asarray(v) for k, v in p.items()} for p in ref.full_params]
    for g, w in zip(vgg.params_to_jax(ex.full_params), want):
        np.testing.assert_allclose(g["w"], w["w"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(g["b"], w["b"], rtol=1e-4, atol=1e-6)
    assert ex.simulated_time == ref.simulated_time == 2.0


def test_train_round_with_int8_hooks_matches_reference(ref_params):
    """The round of ``test_train_round_matches_reference`` with int8 link
    hooks at every cut in both packages (tolerances: module docstring)."""
    sol = (3, 16), (0, 1)
    rplan = R.Plan(solution=R.SplitSolution(*sol), **_PLAN_FIELDS)
    tplan = T.Plan(solution=T.SplitSolution(*sol), **_PLAN_FIELDS)
    batch = next(classification_batches(batch=8, seed=0))
    ref = RefExecutor(rplan, None, None, seed=0, hooks=r_link_hooks("int8"))
    ref.full_params = [{k: jnp.asarray(v) for k, v in p.items()}
                       for p in ref_params]
    want_loss = ref.train_round({k: jnp.asarray(v) for k, v in batch.items()},
                                lr=0.05, momentum=0.9)
    ex = SplitLearningExecutor(tplan, None, None,
                               params=vgg.params_from_jax(ref_params),
                               hooks=make_link_hooks("int8"), device="cpu")
    got_loss = ex.train_round(batch, lr=0.05, momentum=0.9)
    assert got_loss == pytest.approx(want_loss, rel=1e-3)
    want = [{k: np.asarray(v) for k, v in p.items()} for p in ref.full_params]
    for g, w in zip(vgg.params_to_jax(ex.full_params), want):
        np.testing.assert_allclose(g["w"], w["w"], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(g["b"], w["b"], rtol=1e-4, atol=1e-3)


def test_executor_semantics():
    """q choice, link hooks, momentum restart on a new stage grouping, and
    the given weights are copied, not trained in place."""
    plan = T.Plan(solution=T.SplitSolution((2, 16), (0, 1)),
                  **{**_PLAN_FIELDS, "b": 2, "B": 6})      # 3 micro-batches
    params = vgg.init_params(torch.Generator().manual_seed(1))
    before = params[0].weight.detach().clone()
    seen = []
    hooks = LinkHooks(fwd=lambda x: seen.append(tuple(x.shape)) or x)
    ex = SplitLearningExecutor(plan, None, None, params=params, hooks=hooks,
                               device="cpu")
    batch = next(classification_batches(batch=4, seed=2))
    loss = ex.train_round(batch, lr=0.01, momentum=0.9)
    assert np.isfinite(loss)
    assert torch.equal(params[0].weight, before)
    # B=4 does not split into 3 micro-batches: q drops to 2, the hooks see
    # every stage's output of both micro-batches
    assert seen == [(2, 32, 32, 64), (2, 10)] * 2
    assert [len(g) for g in ex._velocity] == [4, 28]
    ex.stages = vgg_stages_from_cuts((5, 16), ex.full_params)
    ex.train_round(batch, lr=0.01, momentum=0.9)
    assert [len(g) for g in ex._velocity] == [10, 22]   # restarted buffer
    assert 0.0 <= ex.evaluate(batch) <= 1.0
