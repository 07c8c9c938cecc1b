"""The hybrid ``jamba-1.5-large`` (reduced: 8 layers = 2 periods of 4, a
Mamba + SwiGLU, a Mamba + MoE, a Mamba + SwiGLU and an attention + MoE
slot; d_model 64, 4 query heads and 2 kv heads of 16, d_inner 128,
d_state 16, 4 experts top-2, vocab 384) through the port's
``models/jamba.py``, against the reference's, from the same numpy-made
weights (``tests/test_torch_mamba.py``'s ``fill_tree``, the reference's
``periods/slot<j>`` tree stacked over the periods) and tokens, in float32
compute:

* a 40-token prefill (``scan_chunk`` 16: chunks of 16, 16 and 8 tokens;
  the reference's chunk 8): the last position's logits and the whole
  cache (k, v and each Mamba slot's conv and ssm states);
* 6 decode steps after it, each step's logits and the cache after them,
  against the reference's ``decode_step``;
* decode against the prefill (the reference's 2e-3 prefill-vs-decode
  contract): 8 tokens from an empty cache, as the reference's
  ``tests/test_models_smoke.py::test_prefill_decode_consistency``, and 4
  steps after a 40-token prefill against the longer prefills, where the
  experts' capacity is made to hold every token (see that test);
* the mean loss and every gradient under remat ``none`` and ``dots``;
* the attention's calls to ``flash_attention`` (one causal call a period
  in a prefill, none in a decode step);
* the ``params_from_jax`` / ``params_to_jax`` round trip (``==``).

Tolerances: logits, caches and decode steps within 1e-5 of each tensor's
largest magnitude; the loss within rtol 1e-5 and each gradient within 1e-4
of its tensor's largest magnitude (``GRAD_REL``, as
``tests/test_torch_lm_train.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import jamba as RJ
from test_torch_mamba import close, configs, fill_tree

from repro_torch.models import jamba
from repro_torch.models.common import nest_layers
from repro_torch.models.registry import get_model

ARCH = "jamba-1.5-large-398b"
FWD_REL = 1e-5
GRAD_REL = 1e-4
LOSS_RTOL = 1e-5
DECODE_TOL = 2e-3
S, CACHE, STEPS = 40, 56, 6

ref_prefill = jax.jit(RJ.prefill, static_argnums=(2, 3))
ref_decode = jax.jit(RJ.decode_step, static_argnums=4)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread: the reduced model's small CPU ops gain
    nothing from a thread pool, and parallel test workers each spinning a
    full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_tree(rcfg, seed=2):
    shapes = jax.eval_shape(lambda k: RJ.init_params(k, rcfg),
                            jax.random.PRNGKey(0))
    return fill_tree(shapes, seed)


def tokens_of(n, vocab, seed, B=2):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, n))


@pytest.fixture(scope="module")
def setup():
    rcfg, pcfg = configs(ARCH, scan_chunk=16)
    tree = reference_tree(rcfg)
    return rcfg, pcfg, tree, jamba.params_from_jax(tree, pcfg, "cpu")


def test_reduced_config_has_every_slot_kind(setup):
    _, pcfg, _, model = setup
    assert jamba.num_periods(pcfg) == 2
    assert jamba._slot_kinds(pcfg) == [("mamba", "mlp"), ("mamba", "moe"),
                                       ("mamba", "mlp"), ("attn", "moe")]
    assert [pcfg.layer_kind(i) for i in range(8)] == \
        ["mamba"] * 3 + ["attn"] + ["mamba"] * 3 + ["attn"]
    assert len(model.periods) == 2


def test_prefill_and_decode_match_reference(setup):
    rcfg, pcfg, tree, model = setup
    tokens = tokens_of(S, pcfg.vocab, seed=3)
    nxt = tokens_of(STEPS, pcfg.vocab, seed=4)
    want, w_cache = ref_prefill(tree, jnp.asarray(tokens, jnp.int32), rcfg,
                                CACHE)
    got, cache = jamba.prefill(model, torch.from_numpy(tokens), CACHE)
    assert got.shape == (2, 1, pcfg.vocab)
    close(got, want, FWD_REL)
    assert set(cache) == set(w_cache) == {"k", "v", "m0_conv", "m0_h",
                                          "m1_conv", "m1_h", "m2_conv",
                                          "m2_h"}
    for name in w_cache:
        assert cache[name].dtype == torch.float32
        close(cache[name], w_cache[name], FWD_REL)
    for t in range(STEPS):
        tok = nxt[:, t:t + 1]
        want, w_cache = ref_decode(tree, w_cache, jnp.asarray(tok, jnp.int32),
                                   jnp.int32(S + t), rcfg)
        got, cache = jamba.decode_step(model, cache, torch.from_numpy(tok),
                                       S + t)
        close(got, want, FWD_REL)
    for name in w_cache:
        close(cache[name], w_cache[name], FWD_REL)


def test_decode_from_empty_cache_equals_the_prefill(setup):
    """The reference's own check: 8 tokens decoded one at a time from an
    empty cache give the prefill's last logits."""
    _, pcfg, _, model = setup
    tokens = torch.from_numpy(tokens_of(8, pcfg.vocab, seed=7, B=1))
    want, _ = jamba.prefill(model, tokens, 16)
    cache = jamba.make_cache(pcfg, 1, 16, "cpu")
    for t in range(8):
        got, cache = jamba.decode_step(model, cache, tokens[:, t:t + 1], t)
    close(got, want, DECODE_TOL)


def test_decode_equals_the_longer_prefill(setup):
    """Decode after a 40-token prefill against the prefills of 41-44
    tokens, at ``capacity_factor`` 2 (= experts / top-k, so that an
    expert's capacity holds every token): at the published 1.25 a prefill
    past ~40 tokens drops the pairs over an expert's capacity, which a
    one-token decode step never does, and the two differ by design (the
    reference does the same; its own check stays at 8 tokens)."""
    rcfg, pcfg = configs(ARCH, scan_chunk=16, capacity_factor=2.0)
    model = jamba.params_from_jax(reference_tree(rcfg), pcfg, "cpu")
    tokens = tokens_of(S + 4, pcfg.vocab, seed=6)
    _, cache = jamba.prefill(model, torch.from_numpy(tokens[:, :S]), CACHE)
    for t in range(4):
        got, cache = jamba.decode_step(
            model, cache, torch.from_numpy(tokens[:, S + t:S + t + 1]), S + t)
        longer, _ = jamba.prefill(
            model, torch.from_numpy(tokens[:, :S + t + 1]), CACHE)
        close(got, longer, DECODE_TOL)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_loss_and_gradients_match_reference(setup, remat):
    rcfg, pcfg, tree, _ = setup
    rcfg, pcfg = (dataclasses.replace(c, remat=remat) for c in (rcfg, pcfg))
    model = jamba.params_from_jax(tree, pcfg, "cpu")
    toks = tokens_of(S + 1, pcfg.vocab, seed=5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want_loss, want = jax.jit(jax.value_and_grad(RJ.loss_fn),
                              static_argnums=2)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}, rcfg)
    loss = get_model(pcfg, "cpu").loss(model, batch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss),
                                                 rel=LOSS_RTOL)
    got = nest_layers({n: p.grad.numpy() for n, p in
                       model.named_parameters()}, np.stack)
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray,
                                                             want))[0]
    assert len(flat) == len(jax.tree.leaves(got))
    names = set()
    for path, w in flat:
        g = got
        for key in path:
            g = g[key.key]
        close(g, w, GRAD_REL)
        names.add("/".join(str(key.key) for key in path))
    assert {"periods/slot0/mamba/A_log", "periods/slot1/moe/router",
            "periods/slot3/wq", "periods/slot2/w_gate", "lm_head"} <= names


def test_attention_goes_through_the_wrapper(setup, monkeypatch):
    _, pcfg, _, model = setup
    calls = []
    real = jamba.flash_attention

    def spy(q, k, v, *, causal):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(jamba, "flash_attention", spy)
    _, cache = jamba.prefill(model, torch.arange(20)[None], 32)
    jamba.decode_step(model, cache, torch.tensor([[3]]), 20)
    assert calls == [((1, 20, 4, 16), (1, 20, 2, 16), True)] * 2


def test_params_round_trip(setup):
    _, pcfg, tree, model = setup
    back = jamba.params_to_jax(model)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(back_flat) == len(flat)
    for path, a in flat:
        assert np.array_equal(back_flat[path], a), path
    again = jamba.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(np.shape, jamba.params_to_jax(again)) == \
        jax.tree.map(np.shape, tree)
