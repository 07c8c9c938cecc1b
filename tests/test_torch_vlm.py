"""The VLM backbone ``internvl2-1b`` (reduced: 2 layers, d_model 64, 4
query heads and 2 kv heads of 16, QKV biases, 8 patch tokens) through the
port's ``models/vlm.py``, against the reference's, from the same numpy-made
weights (``tests/test_torch_dense_options.py``'s helpers) and the same
seeded patch embeddings, in float32 compute:

* the prefill after the patches: last-position logits and the whole KV
  cache (patch positions first) within atol = rtol = 1e-4;
* the loss over the text positions (rtol 1e-5), every parameter's gradient
  and the gradient with respect to the patch embeddings (1e-4 of each
  tensor's largest magnitude);
* the model decoding right: ``decode_step`` at ``pos = patch_tokens + S``
  after a prefill of S tokens equals the prefill of S + 1 tokens (the
  reference's 2e-3 prefill-vs-decode contract) and the reference's
  ``decode_step`` at the same position (1e-4), for 4 steps;
* ``BatchedServer`` generates exactly the reference server's tokens (three
  requests on two slots), keeping its ``pos = len(prompt)``, which leaves
  the patch positions out (ROADMAP Queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve import BatchedServer as RefServer
from repro.launch.serve import Request as RefRequest
from repro.models import get_model as ref_get_model
from repro.models import transformer as R
from repro.models import vlm as RV
from test_torch_dense_options import (GRAD_REL, LOSS_RTOL, TOL, close,
                                      configs, port_grads, reference_tree,
                                      tokens_of)

from repro_torch.launch import serve
from repro_torch.models import transformer, vlm
from repro_torch.models.registry import get_model

ARCH = "internvl2-1b"
DECODE_TOL = 2e-3
S, CACHE = 24, 48

ref_prefill = jax.jit(RV.prefill, static_argnums=(3, 4))
ref_decode = jax.jit(RV.decode_step, static_argnums=4)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread: the reduced model's small CPU ops gain
    nothing from a thread pool, and parallel test workers each spinning a
    full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    rcfg, pcfg = configs(ARCH)
    tree = reference_tree(rcfg, seed=4)
    patches = np.random.default_rng(9).normal(
        size=(2, rcfg.patch_tokens, rcfg.d_model)).astype(np.float32)
    return rcfg, pcfg, tree, patches, _model(tree, pcfg)


def _model(tree, pcfg):
    return transformer.params_from_jax(tree, pcfg, "cpu")


def test_prefill_after_patches_matches_reference(setup):
    rcfg, pcfg, tree, patches, model = setup
    tokens = tokens_of(S, rcfg.vocab, seed=3)
    want, w_cache = ref_prefill(tree, jnp.asarray(tokens, jnp.int32),
                                jnp.asarray(patches), rcfg, CACHE)
    got, cache = vlm.prefill(model, torch.from_numpy(tokens),
                             torch.from_numpy(patches), CACHE)
    assert got.shape == (2, 1, pcfg.vocab)
    close(got, want, TOL)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == w_cache[name].shape
        close(cache[name], w_cache[name], TOL)
    P = pcfg.patch_tokens
    assert float(cache["k"][:, :, P + S:].abs().max()) == 0.0


def test_loss_on_text_and_gradients_match_reference(setup):
    rcfg, pcfg, tree, patches, _ = setup
    model = _model(tree, pcfg)
    toks = tokens_of(S + 1, rcfg.vocab, seed=5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def ref_loss(params, pe):
        return R.loss_fn(params, {**{k: jnp.asarray(v, jnp.int32)
                                     for k, v in batch.items()},
                                  "patch_embeds": pe}, rcfg)
    want_loss, (want, want_pe) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(patches))
    pe = torch.from_numpy(patches).requires_grad_()
    loss = get_model(pcfg, "cpu").loss(model, {**batch, "patch_embeds": pe})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss),
                                                 rel=LOSS_RTOL)
    got = port_grads(model)
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray,
                                                             want))[0]
    assert len(flat) == len(jax.tree.leaves(got))
    names = set()
    for path, w in flat:
        g = got
        for key in path:
            g = g[key.key]
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= GRAD_REL * scale, path
        names.add("/".join(str(key.key) for key in path))
    assert {"layers/bq", "layers/bk", "layers/bv"} <= names
    want_pe = np.asarray(want_pe)
    assert float(np.abs(want_pe).max()) > 0
    assert float(np.abs(pe.grad.numpy() - want_pe).max()) <= \
        GRAD_REL * float(np.abs(want_pe).max())


def test_decode_after_the_patches_equals_the_longer_prefill(setup):
    rcfg, pcfg, tree, patches, model = setup
    P = pcfg.patch_tokens
    tokens = tokens_of(S + 4, rcfg.vocab, seed=6)
    pe = torch.from_numpy(patches)
    _, cache = vlm.prefill(model, torch.from_numpy(tokens[:, :S]), pe, CACHE)
    _, w_cache = ref_prefill(tree, jnp.asarray(tokens[:, :S], jnp.int32),
                             jnp.asarray(patches), rcfg, CACHE)
    for t in range(4):
        tok = tokens[:, S + t:S + t + 1]
        got, cache = vlm.decode_step(model, cache, torch.from_numpy(tok),
                                     P + S + t)
        longer, _ = vlm.prefill(model, torch.from_numpy(tokens[:, :S + t + 1]),
                                pe, CACHE)
        close(got, longer.numpy(), DECODE_TOL, scaled=True)
        want, w_cache = ref_decode(tree, w_cache, jnp.asarray(tok, jnp.int32),
                                   jnp.int32(P + S + t), rcfg)
        close(got, want, TOL)


def _requests(make, vocab):
    rng = np.random.default_rng(0)
    return [make(rid, rng.integers(0, vocab, size=n).astype(np.int32),
                 max_new=6) for rid, n in enumerate((16, 11, 16))]


def _summary(stats):
    return (stats["ticks"], stats["tokens"],
            [(r.rid, tuple(r.generated), r.done) for r in stats["completed"]])


def test_server_generates_the_reference_tokens(setup):
    rcfg, pcfg, tree, _, model = setup
    ref = RefServer(ARCH, reduced=True, batch=2, cache_len=40)
    api = ref_get_model(rcfg)
    ref.cfg = rcfg
    ref.api = dataclasses.replace(api, prefill=jax.jit(api.prefill,
                                                       static_argnums=2))
    ref.decode = jax.jit(api.decode)
    ref.params = jax.tree.map(jnp.asarray, tree)
    for req in _requests(RefRequest, rcfg.vocab):
        ref.submit(req)
    want = ref.run()

    port = serve.BatchedServer(ARCH, reduced=True, batch=2, cache_len=40,
                               device="cpu", params=model)
    port.cfg = pcfg
    port.api = get_model(pcfg, device="cpu")
    port.decode = port.api.decode
    batch = port.prefill_batch(np.arange(5))
    assert batch["patch_embeds"].shape == (1, pcfg.patch_tokens,
                                           pcfg.d_model)
    assert float(batch["patch_embeds"].abs().max()) == 0.0
    for req in _requests(serve.Request, pcfg.vocab):
        port.submit(req)
    got = port.run()
    assert _summary(got) == _summary(want)
    assert len(got["completed"]) == 3
    assert all(len(r.generated) == 6 for r in got["completed"])
