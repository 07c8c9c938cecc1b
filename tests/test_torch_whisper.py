"""The audio encoder-decoder ``whisper-small`` (reduced: 2 encoder and 2
decoder layers, d_model 64, 4 heads of 16, d_ff 128, 16 frames, vocab
384) through the port's ``models/whisper.py``, against the reference's,
from the same numpy-made weights (``tests/test_torch_mamba.py``'s
``fill_tree``: LayerNorm scales near one and biases near zero, the
reference's ``enc_layers`` / ``dec_layers`` stacked over the layers),
frames and tokens, in float32 compute:

* ``encode``: the encoder's output;
* a 24-token prefill: the last position's logits and the whole cache
  (``k`` / ``v`` and the cross ``xk`` / ``xv``);
* 6 decode steps after it, each step's logits and the cache after them,
  against the reference's ``decode_step``;
* decode against a longer prefill (the reference's 2e-3 prefill-vs-decode
  contract);
* the learned decoder positions wrapping past 448: the embedding at
  ``pos0`` 440 and decode steps at positions 446-450 of a 452-slot cache;
* the mean loss and every gradient, and the gradient with respect to the
  frames;
* the attention's calls to ``flash_attention`` (per prefill: the encoder's
  without the causal mask, the decoder's self-attention with it, the
  cross-attention without it against the 16 frames);
* the ``params_from_jax`` / ``params_to_jax`` round trip (``==``).

Tolerances: outputs, caches and decode steps within 1e-5 of each tensor's
largest magnitude; the loss within rtol 1e-5 and each gradient within 1e-4
of its tensor's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import whisper as RW
from test_torch_mamba import close, configs, fill_tree

from repro_torch.models import whisper
from repro_torch.models.common import nest_layers
from repro_torch.models.registry import get_model

ARCH = "whisper-small"
FWD_REL = 1e-5
GRAD_REL = 1e-4
LOSS_RTOL = 1e-5
DECODE_TOL = 2e-3
S, CACHE, STEPS = 24, 40, 6

ref_encode = jax.jit(RW.encode, static_argnums=2)
ref_prefill = jax.jit(RW.prefill, static_argnums=(3, 4))
ref_decode = jax.jit(RW.decode_step, static_argnums=4)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread: the reduced model's small CPU ops gain
    nothing from a thread pool, and parallel test workers each spinning a
    full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tokens_of(n, vocab, seed, B=2):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, n))


@pytest.fixture(scope="module")
def setup():
    rcfg, pcfg = configs(ARCH)
    shapes = jax.eval_shape(lambda k: RW.init_params(k, rcfg),
                            jax.random.PRNGKey(0))
    tree = fill_tree(shapes, seed=3)
    frames = np.random.default_rng(8).normal(
        size=(2, rcfg.encoder_frames, rcfg.d_model)).astype(np.float32)
    return rcfg, pcfg, tree, frames, whisper.params_from_jax(tree, pcfg,
                                                             "cpu")


def test_encoder_matches_reference(setup):
    rcfg, _, tree, frames, model = setup
    want = ref_encode(tree, frames, rcfg)
    with torch.no_grad():
        got = whisper.encode(model, torch.from_numpy(frames))
    close(got, want, FWD_REL)


def test_prefill_and_decode_match_reference(setup):
    rcfg, pcfg, tree, frames, model = setup
    tokens = tokens_of(S, pcfg.vocab, seed=3)
    nxt = tokens_of(STEPS, pcfg.vocab, seed=4)
    want, w_cache = ref_prefill(tree, frames, jnp.asarray(tokens, jnp.int32),
                                rcfg, CACHE)
    got, cache = whisper.prefill(model, torch.from_numpy(frames),
                                 torch.from_numpy(tokens), CACHE)
    assert got.shape == (2, 1, pcfg.vocab)
    close(got, want, FWD_REL)
    assert set(cache) == set(w_cache) == {"k", "v", "xk", "xv"}
    for name in w_cache:
        close(cache[name], w_cache[name], FWD_REL)
    for t in range(STEPS):
        tok = nxt[:, t:t + 1]
        want, w_cache = ref_decode(tree, w_cache, jnp.asarray(tok, jnp.int32),
                                   jnp.int32(S + t), rcfg)
        got, cache = whisper.decode_step(model, cache, torch.from_numpy(tok),
                                         S + t)
        close(got, want, FWD_REL)
    for name in w_cache:
        close(cache[name], w_cache[name], FWD_REL)


def test_decode_equals_the_longer_prefill(setup):
    _, pcfg, _, frames, model = setup
    fr = torch.from_numpy(frames)
    tokens = tokens_of(S + 4, pcfg.vocab, seed=6)
    _, cache = whisper.prefill(model, fr, torch.from_numpy(tokens[:, :S]),
                               CACHE)
    for t in range(4):
        got, cache = whisper.decode_step(
            model, cache, torch.from_numpy(tokens[:, S + t:S + t + 1]), S + t)
        longer, _ = whisper.prefill(
            model, fr, torch.from_numpy(tokens[:, :S + t + 1]), CACHE)
        close(got, longer, DECODE_TOL)


def test_positions_wrap_past_448(setup):
    rcfg, pcfg, tree, frames, model = setup
    tokens = tokens_of(16, pcfg.vocab, seed=9)
    want = RW._dec_embed(tree, jnp.asarray(tokens, jnp.int32), rcfg,
                         pos0=440)
    with torch.no_grad():
        got = model.embed_tokens(torch.from_numpy(tokens), 440)
    close(got, want, 0.0)
    cache_len = 452
    w_logits, w_cache = ref_prefill(tree, frames, jnp.asarray(tokens,
                                                              jnp.int32),
                                    rcfg, cache_len)
    _, cache = whisper.prefill(model, torch.from_numpy(frames),
                               torch.from_numpy(tokens), cache_len)
    for pos in range(446, 451):
        tok = tokens[:, pos % 16:pos % 16 + 1]
        want, w_cache = ref_decode(tree, w_cache, jnp.asarray(tok, jnp.int32),
                                   jnp.int32(pos), rcfg)
        got, cache = whisper.decode_step(model, cache, torch.from_numpy(tok),
                                         pos)
        close(got, want, FWD_REL)


def test_loss_and_gradients_match_reference(setup):
    rcfg, pcfg, tree, frames, _ = setup
    model = whisper.params_from_jax(tree, pcfg, "cpu")
    toks = tokens_of(S + 1, pcfg.vocab, seed=5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def ref_loss(params, fr):
        return RW.loss_fn(params, {**{k: jnp.asarray(v, jnp.int32)
                                      for k, v in batch.items()},
                                   "frames": fr}, rcfg)
    want_loss, (want, want_fr) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, tree), frames)
    fr = torch.from_numpy(frames).requires_grad_()
    loss = get_model(pcfg, "cpu").loss(model, {**batch, "frames": fr})
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
    assert {"enc_layers/bq", "dec_layers/x_wk", "dec_layers/x_bv",
            "dec_pos", "enc_ln/bias", "tok_embed"} <= names
    close(fr.grad, want_fr, GRAD_REL)


def test_attention_goes_through_the_wrapper(setup, monkeypatch):
    _, pcfg, _, frames, model = setup
    calls = []
    real = whisper.flash_attention

    def spy(q, k, v, *, causal):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(whisper, "flash_attention", spy)
    _, cache = whisper.prefill(model, torch.from_numpy(frames[:1]),
                               torch.arange(20)[None], 32)
    whisper.decode_step(model, cache, torch.tensor([[3]]), 20)
    enc = ((1, 16, 4, 16), (1, 16, 4, 16), False)
    dec = [((1, 20, 4, 16), (1, 20, 4, 16), True),
           ((1, 20, 4, 16), (1, 16, 4, 16), False)]
    assert calls == [enc] * 2 + dec * 2


def test_params_round_trip(setup):
    _, pcfg, tree, _, model = setup
    back = whisper.params_to_jax(model)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(back_flat) == len(flat)
    for path, a in flat:
        assert np.array_equal(back_flat[path], a), path
    again = whisper.init_params(pcfg, torch.Generator().manual_seed(0),
                                "cpu")
    assert jax.tree.map(np.shape, whisper.params_to_jax(again)) == \
        jax.tree.map(np.shape, tree)
