"""The dense family's options — QKV biases, the GELU MLP, an untied head and
sliding windows — through the port's transformer, against the reference's,
from the same weights.

``jax.random`` streams cannot be reproduced in torch, so both packages get
the same numpy-made weights in the reference's layout (per-layer arrays
stacked on a leading ``L`` axis; norm scales drawn away from one and
biases away from zero, so a swapped or missing one shows), carried into
the port by ``params_from_jax``, and the same numpy-made tokens.  The
config is the reduced ``qwen3-0.6b`` (2 layers, d_model 64, 4 query heads
and 2 kv heads of 16, d_ff 128, vocab 256) with each option alone
(windows 1, 7, 64 and one longer than the prompt) and all together, in
float32 compute.  Each case compares

* a 72-token prefill: the last position's logits and the whole KV cache;
* 8 decode steps after it: every step's logits and the cache after them
  (both packages' decode attention reads the whole cache and leaves the
  window out);
* the mean loss and every parameter's gradient (``jax.value_and_grad`` of
  the reference's ``loss_fn``, autograd of the port's).

The reference takes ``full_attention`` up to ``attn_chunk`` tokens; two
cases run a 40-token prompt at ``attn_chunk`` 8, where it takes
``chunked_attention``.  Tolerances, as in ``tests/test_torch_transformer.py``
and ``tests/test_torch_lm_train.py``: float32 logits and caches within
atol = rtol = 1e-4; the loss within rtol 1e-5 and each gradient within
1e-4 of its tensor's largest magnitude; one bfloat16 prefill with every
option within 3e-2 of each tensor's largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as C
from repro.models import transformer as R

from repro_torch.configs import get_config
from repro_torch.models import transformer
from repro_torch.models.common import gelu_mlp, layer_norm, nest_layers

TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
BF16_TOL = 3e-2
PROMPT, CACHE, STEPS = 72, 80, 8
OPTIONS = {
    "qkv_bias": {"qkv_bias": True},
    "gelu_mlp": {"ffn_mult": 2},
    "untied_head": {"tie_embeddings": False},
    "window_1": {"sliding_window": 1},
    "window_7": {"sliding_window": 7},
    "window_64": {"sliding_window": 64},
    "window_past_the_prompt": {"sliding_window": 4096},
    "all": {"qkv_bias": True, "ffn_mult": 2, "tie_embeddings": False,
            "sliding_window": 7},
}

ref_prefill = jax.jit(R.prefill, static_argnums=(2, 3))
ref_decode_step = jax.jit(R.decode_step, static_argnums=4)
ref_grad = jax.jit(jax.value_and_grad(R.loss_fn), static_argnums=2)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread: the reduced models' small CPU ops gain
    nothing from a thread pool, and parallel test workers each spinning a
    full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch="qwen3-0.6b", dt="float32", **changes):
    """(reference config, port config) of ``arch``, reduced, with
    ``changes``, in float32 or bfloat16 compute."""
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    ref = dataclasses.replace(ref_get_config(arch, reduced=True),
                              compute_dtype=jdt, **changes)
    port = dataclasses.replace(get_config(arch, reduced=True),
                               compute_dtype=tdt, **changes)
    return ref, port


def reference_tree(cfg, seed=0):
    """numpy weights in the reference's layout: norm scales near one,
    biases near zero, matrices at 1/sqrt(fan_in), the embedding at 0.5."""
    shapes = jax.eval_shape(lambda k: R.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name in ("ln1", "ln2", "q_norm", "k_norm", "final_norm"):
            return 1.0 + 0.1 * rng.normal(size=s.shape)
        if name in ("bq", "bk", "bv", "b_up", "b_down"):
            return 0.1 * rng.normal(size=s.shape)
        if name == "embed":
            return rng.normal(size=s.shape) * 0.5
        return rng.normal(size=s.shape) / np.sqrt(s.shape[-2])

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def tokens_of(S, vocab, B=2, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S))


def close(got, want, tol, *, scaled=False):
    """allclose at atol = rtol = tol; ``scaled``: atol = tol * max|want|."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    atol = tol * max(1.0, float(np.abs(want).max())) if scaled else tol
    np.testing.assert_allclose(np.asarray(got.detach().float().cpu()), want,
                               atol=atol, rtol=tol)


def check_serving(rcfg, pcfg, tree, prompt=PROMPT, cache_len=CACHE,
                  steps=STEPS, seed=3):
    """Prefill and ``steps`` decode steps of the port against the
    reference's, from the same weights and tokens (float32)."""
    tokens = tokens_of(prompt, rcfg.vocab, seed=seed)
    nxt = tokens_of(steps, rcfg.vocab, seed=seed + 1)
    want, w_cache = ref_prefill(tree, jnp.asarray(tokens, jnp.int32), rcfg,
                                cache_len)
    model = transformer.params_from_jax(tree, pcfg, "cpu")
    got, cache = transformer.prefill(model, torch.from_numpy(tokens),
                                     cache_len)
    assert got.shape == (2, 1, pcfg.vocab)
    close(got, want, TOL)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == w_cache[name].shape
        close(cache[name], w_cache[name], TOL)
    for t in range(steps):
        tok = nxt[:, t:t + 1]
        want, w_cache = ref_decode_step(tree, w_cache,
                                        jnp.asarray(tok, jnp.int32),
                                        jnp.int32(prompt + t), rcfg)
        got, cache = transformer.decode_step(model, cache,
                                             torch.from_numpy(tok),
                                             prompt + t)
        close(got, want, TOL)
    for name in ("k", "v"):
        close(cache[name], w_cache[name], TOL)


def port_grads(model) -> dict:
    """The model's gradients in the reference's tree layout (the experts'
    nested under ``layers["moe"]``)."""
    return nest_layers({n: p.grad.numpy()
                        for n, p in model.named_parameters()}, np.stack)


def check_training(rcfg, pcfg, tree, S=32, seed=5):
    """The mean loss and every gradient of the port against the
    reference's (float32); returns the names compared."""
    tokens = tokens_of(S + 1, rcfg.vocab, B=2, seed=seed)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    want_loss, want = ref_grad(jax.tree.map(jnp.asarray, tree),
                               {k: jnp.asarray(v, jnp.int32)
                                for k, v in batch.items()}, rcfg)
    model = transformer.params_from_jax(tree, pcfg, "cpu")
    loss = transformer.loss_fn(model, batch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss),
                                                 rel=LOSS_RTOL)
    got = port_grads(model)
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray,
                                                             want))[0]
    assert len(flat) == len(jax.tree.leaves(got))
    names = []
    for path, w in flat:
        g = got
        for key in path:
            g = g[key.key]
        name = "/".join(str(key.key) for key in path)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_REL * scale, (name, err, scale)
        names.append(name)
    return names


@pytest.fixture(scope="module")
def trees():
    cache = {}

    def get(rcfg):
        key = tuple(sorted(dataclasses.asdict(rcfg).items(), key=str))
        if key not in cache:
            cache[key] = reference_tree(rcfg)
        return cache[key]
    return get


@pytest.mark.parametrize("option", OPTIONS)
def test_serving_matches_reference(option, trees):
    rcfg, pcfg = configs(**OPTIONS[option])
    check_serving(rcfg, pcfg, trees(rcfg))


@pytest.mark.parametrize("option", OPTIONS)
def test_loss_and_gradients_match_reference(option, trees):
    rcfg, pcfg = configs(**OPTIONS[option])
    names = check_training(rcfg, pcfg, trees(rcfg), S=PROMPT)
    change = OPTIONS[option]
    if change.get("qkv_bias"):
        assert {"layers/bq", "layers/bk", "layers/bv"} <= set(names)
    if change.get("ffn_mult") == 2:
        assert {"layers/b_up", "layers/b_down"} <= set(names)
        assert "layers/w_gate" not in names
    assert ("lm_head" in names) == (change.get("tie_embeddings") is False)


@pytest.mark.parametrize("option", ["window_7", "all"])
def test_chunked_reference_branch(option, trees):
    """40 tokens at ``attn_chunk`` 8: the reference's ``chunked_attention``
    (five blocks) against the port's K2 function, in the prefill and in
    the training forward."""
    rcfg, pcfg = configs(attn_chunk=8, **OPTIONS[option])
    tree = trees(rcfg)
    check_serving(rcfg, pcfg, tree, prompt=40, cache_len=48, steps=2)
    check_training(rcfg, pcfg, tree, S=40)


def test_bfloat16_prefill_with_every_option(trees):
    """In bfloat16 the frameworks round at other places, and the reference
    casts the attention probabilities to bfloat16 before p v: logits and
    cache within 3e-2 of each tensor's largest magnitude."""
    rcfg, pcfg = configs(dt="bfloat16", **OPTIONS["all"])
    tree = trees(configs(**OPTIONS["all"])[0])
    tokens = tokens_of(PROMPT, rcfg.vocab)
    want, w_cache = ref_prefill(tree, jnp.asarray(tokens, jnp.int32), rcfg,
                                CACHE)
    model = transformer.params_from_jax(tree, pcfg, "cpu")
    got, cache = transformer.prefill(model, torch.from_numpy(tokens), CACHE)
    assert got.dtype == torch.bfloat16
    close(got, want, BF16_TOL, scaled=True)
    for name in ("k", "v"):
        assert cache[name].dtype == torch.bfloat16
        close(cache[name], w_cache[name], BF16_TOL, scaled=True)


def test_parameters_follow_the_options(trees):
    """The port's parameters are the reference's leaves, by name and shape,
    and ``init_params`` starts the biases at zero and ``lm_head`` at
    1/sqrt(d_model), as the reference's initializer does."""
    rcfg, pcfg = configs(**OPTIONS["all"])
    tree = trees(rcfg)
    model = transformer.params_from_jax(tree, pcfg, "cpu")
    back = transformer.params_to_jax(model)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(back_flat) == len(flat)
    for path, a in flat:
        assert np.array_equal(back_flat[path], a), path
    init = transformer.init_params(pcfg, torch.Generator().manual_seed(0),
                                   "cpu")
    got = transformer.params_to_jax(init)
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, tree)
    for name in ("bq", "bk", "bv", "b_up", "b_down"):
        assert np.all(got["layers"][name] == 0.0), name
    assert np.std(got["lm_head"]) == pytest.approx(0.8796 / np.sqrt(64),
                                                   rel=0.05)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_mlp_match_reference(dt):
    """``layer_norm`` (eps 1e-5, float32 inside) and ``gelu_mlp`` (tanh
    GELU) against the reference's: float32 within 1e-5 (1e-4 for the
    MLP's products), bfloat16 within 3e-2."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32) * 3 + 1
    scale, bias = (rng.normal(size=64).astype(np.float32) for _ in range(2))
    w_up = rng.normal(size=(64, 96)).astype(np.float32) / 8
    b_up = rng.normal(size=96).astype(np.float32)
    w_down = rng.normal(size=(96, 64)).astype(np.float32) / 10
    b_down = rng.normal(size=64).astype(np.float32)
    jdt, tdt, tol = ((jnp.float32, torch.float32, 1e-5) if dt == "float32"
                     else (jnp.bfloat16, torch.bfloat16, BF16_TOL))
    j = lambda a: jnp.asarray(a, jdt)
    t = lambda a: torch.from_numpy(a).to(tdt)
    want = C.layer_norm(j(x), j(scale), j(bias))
    got = layer_norm(t(x), t(scale), t(bias))
    assert got.dtype == tdt
    close(got, want, tol)
    want = C.gelu_mlp(j(x), j(w_up), j(b_up), j(w_down), j(b_down))
    got = gelu_mlp(t(x), t(w_up), t(b_up), t(w_down), t(b_down))
    close(got, want, max(tol, 1e-4), scaled=dt == "bfloat16")
