"""Language-model training through the port against the reference, on the
reduced ``qwen3-0.6b`` (dense) and ``rwkv6-1.6b`` (ssm) configs.

From the same numpy-made weights (the reference's ``init_params`` carried
across by ``params_from_jax``), in float32 compute on both sides (bf16
rounds at other places in the two frameworks):

* ``ModelAPI.loss`` and every parameter's gradient against
  ``jax.value_and_grad(api.loss)``, under ``remat`` none, layer and dots:
  the loss within rtol 1e-5, each gradient within 1e-4 of its tensor's
  largest magnitude (RWKV6's in ``tests/test_torch_lm_train_rwkv6.py``,
  which shares this file's helpers: a file stays well under 20 s);
* ``make_train_step`` (Q = 2 micro-batches, AdamW) for 3 steps: the loss
  of each step within rtol 1e-4 (``tests/test_torch_lm_steps.py``);
* ``configs/base.py::count_params`` ``==`` the reference's, full and
  reduced;
* ``transformer_stage_fn`` chained over two stages equals the layers of
  ``forward_hidden``, and ``stack_stage_params`` / ``unstack_stage_params``
  equal the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_config
from repro.configs.base import count_params as r_count
from repro.launch.steps import make_train_step as r_step
from repro.models import get_model as r_model
from repro.optim import get_optimizer as r_opt
from repro.pipeline import stage as r_stage

from repro_torch.configs import get_config as t_config
from repro_torch.configs.base import count_params as t_count
from repro_torch.data import token_lm_batches
from repro_torch.launch.steps import (default_microbatches,
                                      default_optimizer_name,
                                      make_train_step)
from repro_torch.models import rwkv6 as t_rwkv
from repro_torch.models import transformer as t_tf
from repro_torch.models.registry import get_model as t_model
from repro_torch.optim import get_optimizer as t_opt
from repro_torch.pipeline import stage as t_stage

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STEP_RTOL = 1e-4
LIBS = {"qwen3-0.6b": t_tf, "rwkv6-1.6b": t_rwkv}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread: the reduced models' small CPU ops gain
    nothing from a thread pool, and parallel test workers each spinning a
    full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, remat="layer"):
    rc = dataclasses.replace(r_config(arch, reduced=True),
                             compute_dtype=jnp.float32, remat=remat)
    tc = dataclasses.replace(t_config(arch, reduced=True),
                             compute_dtype=torch.float32, remat=remat)
    return rc, tc


@pytest.fixture(scope="module")
def weights():
    cache = {}

    def get(arch):
        if arch not in cache:
            rc, _ = _configs(arch)
            cache[arch] = jax.tree.map(
                np.asarray, r_model(rc).init(jax.random.PRNGKey(0)))
        return cache[arch]
    return get


def _batch(vocab, B=4, S=16, seed=3):
    return next(token_lm_batches(batch=B, seq_len=S, vocab=vocab, seed=seed))


def _port_grads(model) -> dict:
    """The model's gradients in the reference's tree layout."""
    out = {n: p.grad.numpy() for n, p in model.named_parameters()
           if not n.startswith("layers.")}
    names = [n for n, _ in model.layers[0].named_parameters()]
    out["layers"] = {n: np.stack([getattr(layer, n).grad.numpy()
                                  for layer in model.layers]) for n in names}
    return out


def check_loss_and_gradients(arch, remat, weights):
    rc, tc = _configs(arch, remat)
    tree = weights(arch)
    batch = _batch(rc.vocab)
    want_loss, want = jax.jit(jax.value_and_grad(r_model(rc).loss))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = LIBS[arch].params_from_jax(tree, tc, "cpu")
    loss = t_model(tc, "cpu").loss(model, batch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss),
                                                 rel=LOSS_RTOL)
    got = _port_grads(model)
    want = jax.tree.map(np.asarray, want)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == len(jax.tree.leaves(got))
    for path, w in flat_w:
        g = got
        for key in path:
            g = g[key.key]
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= GRAD_REL * scale, (path, scale)


@pytest.mark.parametrize("remat", ["none", "layer", "dots"])
def test_qwen3_loss_and_gradients_match_jax(remat, weights):
    check_loss_and_gradients("qwen3-0.6b", remat, weights)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", list(LIBS))
def test_count_params_and_policy_equal_reference(arch, reduced):
    from repro.launch import steps as rs
    rc, tc = r_config(arch, reduced=reduced), t_config(arch,
                                                       reduced=reduced)
    assert t_count(tc) == r_count(rc)
    assert default_optimizer_name(tc) == rs.default_optimizer_name(rc)
    for B in (1, 6, 32, 256):
        assert default_microbatches(tc, B) == rs.default_microbatches(rc, B)


def test_count_params_is_the_reference_estimate():
    """Not the parameter count: the reference's profile-based estimate."""
    assert t_count(t_config("qwen3-0.6b")) == 810_287_104
    assert t_count(t_config("rwkv6-1.6b")) == 1_577_058_304


def test_stage_fn_over_two_stages_equals_forward_hidden(weights):
    rc, tc = _configs("qwen3-0.6b", "none")
    tree = weights("qwen3-0.6b")
    model = t_tf.params_from_jax(tree, tc, "cpu")
    tokens = torch.from_numpy(_batch(rc.vocab)["tokens"])
    with torch.no_grad():
        want = t_tf.forward_hidden(model, tokens)
        x = model.embed_tokens(tokens)
        layers = {k: torch.from_numpy(v) for k, v in tree["layers"].items()}
        stages = t_stage.stack_stage_params(layers, 2)
        fn = t_stage.transformer_stage_fn(tc)
        for s in range(2):
            x = fn({k: v[s] for k, v in stages.items()}, x)
    assert torch.equal(x, want)


def test_stage_fn_is_differentiable_under_layer_remat(weights):
    _, tc = _configs("qwen3-0.6b", "layer")
    tree = weights("qwen3-0.6b")
    layers = {k: torch.from_numpy(v[:1]).requires_grad_()
              for k, v in tree["layers"].items()}
    x = torch.randn(2, 8, tc.d_model, generator=torch.Generator()
                    .manual_seed(0))
    out = t_stage.transformer_stage_fn(tc)(layers, x)
    grads = torch.autograd.grad(out.square().sum(), list(layers.values()))
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


@pytest.mark.parametrize("num_stages", [1, 2])
def test_stack_and_unstack_equal_reference(num_stages, weights):
    layers = weights("qwen3-0.6b")["layers"]
    want = r_stage.stack_stage_params(
        {k: jnp.asarray(v) for k, v in layers.items()}, num_stages)
    got = t_stage.stack_stage_params(
        {k: torch.from_numpy(v) for k, v in layers.items()}, num_stages)
    for k in layers:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    back = t_stage.unstack_stage_params(got)
    rback = r_stage.unstack_stage_params(want)
    for k in layers:
        assert np.array_equal(back[k].numpy(), np.asarray(rback[k]))
        assert np.array_equal(back[k].numpy(), layers[k])
