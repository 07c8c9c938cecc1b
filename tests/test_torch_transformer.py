"""The port's dense transformer (``qwen3-0.6b``) against the reference, from
the same weights.

``jax.random`` streams cannot be reproduced in torch, so both packages get
the same numpy-made weights (reference layout, per-layer arrays stacked on
a leading ``L`` axis; carried into the port by ``params_from_jax``) and the
same numpy-made inputs, at the reduced ``qwen3-0.6b`` config (2 layers,
d_model 64, 4 query heads and 2 kv heads of 16, d_ff 128, vocab 256).  The
norm scales are drawn away from one so that a swapped or missing norm
shows.  The prefill's attention goes through ``flash_attention`` (its
plain version on the CPU); the reference takes ``full_attention`` up to
``attn_chunk`` tokens and ``chunked_attention`` beyond.

Tolerances: float32 compute within atol = rtol = 1e-4; bfloat16 compute
within rtol = 3e-2 and atol = 3e-2 per layer, and through the whole model
(prefill, decode step) atol = 3e-2 times the tensor's largest magnitude,
as in ``tests/test_torch_rwkv6.py``: the frameworks round bfloat16 at
different points, and the reference casts the attention probabilities to
bfloat16 before the product with v where K2's plain version (what its
wrapper runs on the CPU) keeps them in float32.  The reference's own
prefill-vs-decode contract is 2e-3 (``tests/test_models_smoke.py``).  The reference runs under ``jax.jit``,
compiled once per case.
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
from repro_torch.models.transformer import FAMILIES
from repro_torch.models.common import (apply_rope, decode_attention,
                                       rope_cos_sin)
from repro_torch.models.registry import get_model

FULL_PARAMS = 596_049_920
ref_prefill = jax.jit(R.prefill, static_argnums=(2, 3))
ref_decode_step = jax.jit(R.decode_step, static_argnums=4)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
PROMPT, CACHE = 12, 16


def configs(dt, **changes):
    jdt, tdt, _ = DTYPES[dt]
    ref = dataclasses.replace(ref_get_config("qwen3-0.6b", reduced=True),
                              compute_dtype=jdt, **changes)
    port = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                               compute_dtype=tdt, **changes)
    return ref, port


def reference_tree(cfg, seed=0):
    """numpy weights in the reference's layout, at its scales."""
    shapes = jax.eval_shape(lambda k: R.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name in ("ln1", "ln2", "q_norm", "k_norm", "final_norm"):
            return 1.0 + 0.1 * rng.normal(size=s.shape)
        if name == "embed":
            return rng.normal(size=s.shape) * 0.5
        return rng.normal(size=s.shape) / np.sqrt(s.shape[-2])

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def tree():
    return reference_tree(configs("float32")[0])


def tokens_of(S, B=2, seed=3):
    return np.random.default_rng(seed).integers(0, 256, size=(B, S))


def to_torch(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def close(got, want, tol, *, scaled=False):
    """allclose at atol = rtol = tol; ``scaled``: atol = tol * max|want|."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    atol = tol * max(1.0, float(np.abs(want).max())) if scaled else tol
    np.testing.assert_allclose(np.asarray(got.detach().float().cpu()), want,
                               atol=atol, rtol=tol)


def test_params_from_jax_round_trips(tree):
    cfg = configs("float32")[1]
    model = transformer.params_from_jax(tree, cfg, "cpu")
    back = transformer.params_to_jax(model)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(back_flat) == len(flat)
    for path, a in flat:
        assert np.array_equal(back_flat[path], a), path
    # the reference's (in, out) orientation is kept: x @ W
    layer = model.layers[1]
    assert layer.wq.shape == (cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert layer.w_down.shape == (cfg.d_ff, cfg.d_model)
    assert np.array_equal(layer.wo.detach().numpy(), tree["layers"]["wo"][1])


@pytest.mark.parametrize("dt", DTYPES)
def test_block_fwd_matches_reference(tree, dt):
    rcfg, pcfg = configs(dt)
    jdt, tdt, tol = DTYPES[dt]
    x = np.random.default_rng(1).normal(size=(2, PROMPT, 64))
    x = x.astype(np.float32)
    p0 = {n: a[0] for n, a in tree["layers"].items()}
    want, (w_k, w_v) = jax.jit(
        lambda p, x: R.block_fwd(p, x, rcfg, positions=jnp.arange(PROMPT),
                                 mode="prefill"))(p0, jnp.asarray(x, jdt))
    layer = transformer.params_from_jax(tree, pcfg, "cpu").layers[0]
    cos, sin = rope_cos_sin(torch.arange(PROMPT), pcfg.head_dim,
                            pcfg.rope_theta)
    got, (g_k, g_v) = layer(torch.from_numpy(x).to(tdt), cos, sin)
    assert got.dtype == tdt
    for g, w in ((got, want), (g_k, w_k), (g_v, w_v)):
        close(g, w, tol)


@pytest.fixture(scope="module")
def prefills(tree):
    """The reference's prefill and one decode step after it, per compute
    type."""
    tokens, next_tok = tokens_of(PROMPT), tokens_of(1, seed=4)
    out = {}
    for dt in DTYPES:
        rcfg, _ = configs(dt)
        logits, cache = ref_prefill(tree, jnp.asarray(tokens, jnp.int32),
                                    rcfg, CACHE)
        d_logits, d_cache = ref_decode_step(
            tree, cache, jnp.asarray(next_tok, jnp.int32), jnp.int32(PROMPT),
            rcfg)
        out[dt] = (logits, cache, d_logits, d_cache)
    return tokens, next_tok, out


@pytest.mark.parametrize("dt", DTYPES)
def test_prefill_matches_reference(tree, prefills, dt):
    _, pcfg = configs(dt)
    tol = DTYPES[dt][2]
    tokens, _, out = prefills
    want, w_cache = out[dt][:2]
    model = transformer.params_from_jax(tree, pcfg, "cpu")
    got, g_cache = transformer.prefill(model, torch.from_numpy(tokens), CACHE)
    assert got.shape == (2, 1, pcfg.vocab)
    scaled = dt == "bfloat16"
    close(got, want, tol, scaled=scaled)
    assert set(g_cache) == set(w_cache) == {"k", "v"}
    for name in w_cache:
        assert tuple(g_cache[name].shape) == w_cache[name].shape == \
            (2, 2, CACHE, 2, 16)
        assert g_cache[name].dtype == pcfg.compute_dtype
        close(g_cache[name], w_cache[name], tol, scaled=scaled)


@pytest.mark.parametrize("dt", DTYPES)
def test_decode_step_matches_reference(tree, prefills, dt):
    _, pcfg = configs(dt)
    tol = DTYPES[dt][2]
    _, next_tok, out = prefills
    _, w_cache, want, w_new = out[dt]
    model = transformer.params_from_jax(tree, pcfg, "cpu")
    cache = {n: to_torch(a, pcfg.compute_dtype) for n, a in w_cache.items()}
    got, g_new = transformer.decode_step(model, cache,
                                         torch.from_numpy(next_tok), PROMPT)
    assert g_new is cache                      # updated in place
    scaled = dt == "bfloat16"
    close(got, want, tol, scaled=scaled)
    for name in w_new:
        close(g_new[name], w_new[name], tol, scaled=scaled)


def test_decode_step_after_a_full_cache_matches_reference(tree):
    """A prompt of exactly ``cache_len`` tokens leaves the next decode step
    at ``pos == cache_len``: the reference's ``dynamic_update_slice``
    clamps the write to the last entry, and so must the port (float32)."""
    rcfg, pcfg = configs("float32")
    tokens, next_tok = tokens_of(CACHE, seed=7), tokens_of(1, seed=8)
    logits, w_cache = ref_prefill(tree, jnp.asarray(tokens, jnp.int32), rcfg,
                                  CACHE)
    want, w_new = ref_decode_step(tree, w_cache,
                                  jnp.asarray(next_tok, jnp.int32),
                                  jnp.int32(CACHE), rcfg)
    model = transformer.params_from_jax(tree, pcfg, "cpu")
    got_p, cache = transformer.prefill(model, torch.from_numpy(tokens), CACHE)
    close(got_p, logits, 1e-4)
    got, g_new = transformer.decode_step(model, cache,
                                         torch.from_numpy(next_tok), CACHE)
    close(got, want, 1e-4)
    for name in ("k", "v"):
        close(g_new[name], w_new[name], 1e-4)


def test_prompt_longer_than_attn_chunk_matches_chunked_reference(tree):
    """With ``attn_chunk`` 8, a 20-token prompt takes the reference's
    ``chunked_attention`` (two whole blocks and a ragged one); the port's
    prefill attention is K2's function at every length."""
    rcfg, pcfg = configs("float32", attn_chunk=8)
    tokens = tokens_of(20, seed=6)
    want, w_cache = ref_prefill(tree, jnp.asarray(tokens, jnp.int32), rcfg,
                                24)
    model = transformer.params_from_jax(tree, pcfg, "cpu")
    got, g_cache = transformer.prefill(model, torch.from_numpy(tokens), 24)
    close(got, want, 1e-4)
    for name in w_cache:
        close(g_cache[name], w_cache[name], 1e-4)


@pytest.mark.parametrize("S", [8, 13])
def test_decode_steps_equal_prefill(tree, S):
    """S single-token decode steps from an empty cache == a prefill of the
    S tokens (float32), at the reference's 2e-3."""
    _, pcfg = configs("float32")
    api = get_model(pcfg, device="cpu")
    model = transformer.params_from_jax(tree, pcfg, "cpu")
    tokens = torch.from_numpy(tokens_of(S, B=1, seed=5))
    logits_p, cache_p = api.prefill(model, {"tokens": tokens}, CACHE)
    cache = transformer.make_cache(pcfg, 1, CACHE, "cpu")
    for t in range(S):
        logits_d, cache = api.decode(model, cache, tokens[:, t:t + 1], t)
    close(logits_d, logits_p.numpy(), 2e-3)
    for name in ("k", "v"):
        close(cache[name], cache_p[name].numpy(), 2e-3)


def test_rope_matches_reference():
    """At qwen3's head size and theta, out to 4096 positions.  The
    reference runs op by op here: under ``jax.jit`` XLA folds the frequency
    formula differently and its float32 angles move by one ulp (2.4e-4 at
    position 4096, as far from the exact angle as either framework's), so
    the comparison would measure the compiler, not the port."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, 64, 3, 128)).astype(np.float32)
    pos = np.sort(rng.integers(0, 4096, size=64))
    want = C.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    cos, sin = rope_cos_sin(torch.from_numpy(pos), 128, 1e6)
    got = apply_rope(torch.from_numpy(x), cos, sin)
    close(got, want, 1e-4)


@pytest.mark.parametrize("dt", DTYPES)
def test_decode_attention_matches_reference(dt):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, 1, 8, 32)).astype(np.float32)
    kc, vc = (rng.normal(size=(2, 24, 2, 32)).astype(np.float32)
              for _ in range(2))
    want = jax.jit(C.decode_attention)(
        *(jnp.asarray(a, jdt) for a in (q, kc, vc)), 13)
    got = decode_attention(*(torch.from_numpy(a).to(tdt) for a in (q, kc, vc)),
                           13)
    assert got.dtype == tdt
    close(got, want, tol)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_equal_the_reference(reduced):
    """Every field the port's config keeps has the reference's value."""
    port = get_config("qwen3-0.6b", reduced=reduced)
    ref = ref_get_config("qwen3-0.6b", reduced=reduced)
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(got, torch.dtype):
            got, want = str(got)[6:], jnp.dtype(want).name
        assert got == want, f.name
    assert (port.head_dim, port.q_per_kv) == (ref.head_dim, ref.q_per_kv)


def test_full_width_parameter_count():
    cfg = get_config("qwen3-0.6b")
    assert (cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.n_kv,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == \
        (28, 1024, 16, 8, 128, 3072, 151936)
    model = transformer.Transformer(cfg, device=torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == FULL_PARAMS
    shapes = jax.eval_shape(
        lambda k: R.init_params(k, ref_get_config("qwen3-0.6b")),
        jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape))
               for a in jax.tree.leaves(shapes)) == FULL_PARAMS


def test_init_params_is_seeded_and_shaped_like_reference():
    _, pcfg = configs("float32")
    a = transformer.init_params(pcfg, torch.Generator().manual_seed(3), "cpu")
    b = transformer.init_params(pcfg, torch.Generator().manual_seed(3), "cpu")
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    got = transformer.params_to_jax(a)
    ref = jax.eval_shape(lambda k: R.init_params(k, configs("float32")[0]),
                         jax.random.PRNGKey(0))
    assert jax.tree.map(lambda x: x.shape, got) == \
        jax.tree.map(lambda x: x.shape, ref)
    layers = got["layers"]
    assert np.all(layers["q_norm"] == 1.0) and np.all(layers["ln2"] == 1.0)
    # a +-2 std truncated normal has std 0.8796; dense scale 1/sqrt(fan_in)
    assert np.std(layers["w_down"]) == pytest.approx(0.8796 / np.sqrt(128),
                                                     rel=0.05)
    assert np.std(got["embed"]) == pytest.approx(0.02, rel=0.05)


@pytest.mark.parametrize("change", [{"sliding_window": 64},
                                    {"tie_embeddings": False},
                                    {"ffn_mult": 2}])
def test_unported_options_raise(change):
    """The three dense options this test once pinned as unported are
    ported: each builds and runs (prefill, a decode step, the loss with
    its gradients; ``tests/test_torch_dense_options.py`` holds them to the
    reference).  So are the families it once pinned: MoE and VLM
    (``tests/test_torch_moe_models.py``, ``tests/test_torch_vlm.py``), and
    the hybrid and audio families (``tests/test_torch_jamba.py``,
    ``tests/test_torch_whisper.py`` hold them to the reference).  The
    transformer itself still refuses a family it does not build."""
    base = get_config("qwen3-0.6b", reduced=True)
    cfg = dataclasses.replace(base, **change)
    runs = {"dense": cfg,
            "moe": get_config("granite-moe-3b-a800m", reduced=True),
            "vlm": get_config("internvl2-1b", reduced=True),
            "hybrid": get_config("jamba-1.5-large-398b", reduced=True),
            "audio": get_config("whisper-small", reduced=True)}
    for family, run in runs.items():
        assert run.family == family
        api = get_model(run, device="cpu")
        model = api.init(torch.Generator().manual_seed(0))
        names = {n for n, _ in model.named_parameters()}
        assert ("lm_head" in names) == (family == "hybrid"
                                        or not run.tie_embeddings)
        if family in FAMILIES:
            assert ("layers.0.b_up" in names) == (run.ffn_mult != 3)
            assert ("layers.0.moe.router" in names) == (family == "moe")
        tokens = torch.from_numpy(tokens_of(PROMPT) % run.vocab)
        batch = {"tokens": tokens, "labels": tokens}
        if family == "vlm":
            batch["patch_embeds"] = torch.randn(
                (2, run.patch_tokens, run.d_model),
                generator=torch.Generator().manual_seed(1))
        if family == "audio":
            batch["frames"] = torch.randn(
                (2, run.encoder_frames, run.d_model),
                generator=torch.Generator().manual_seed(1))
        logits, cache = api.prefill(model, batch, CACHE + run.patch_tokens)
        logits_d, _ = api.decode(model, cache, tokens[:, :1],
                                 PROMPT + run.patch_tokens)
        loss = api.loss(model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        assert logits.shape == logits_d.shape == (2, 1, run.vocab), family
        assert all(torch.isfinite(t).all() for t in (logits, logits_d, loss))
        assert all(torch.isfinite(g).all() for g in grads)
    for family in ("hybrid", "audio"):
        with pytest.raises(ValueError, match="not a transformer's"):
            transformer.Transformer(dataclasses.replace(cfg, family=family),
                                    device="cpu")


def test_prompt_longer_than_cache_raises():
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        transformer.prefill(model, torch.zeros((1, 9), dtype=torch.long), 8)
