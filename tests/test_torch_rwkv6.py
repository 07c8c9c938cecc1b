"""The port's RWKV6 against the reference, from the same weights.

``jax.random`` streams cannot be reproduced in torch, so both packages get
the same numpy-made weights (reference layout, per-layer arrays stacked on
a leading ``L`` axis; carried into the port by ``params_from_jax``) and the
same numpy-made inputs, at the reduced ``rwkv6-1.6b`` config (2 layers,
d_model 64, 2 heads of 32).  The weights are drawn away from the
initializer's constants (mixing coefficients, decay, bonus and norm scales
all vary per channel) so that a swapped or missing term shows.

Tolerances: float32 compute within atol = rtol = 1e-4; bfloat16 compute
within rtol = 3e-2 and atol = 3e-2 per layer.  Through the whole model in
bfloat16 (prefill, decode step) atol is 3e-2 times the tensor's largest
magnitude: the frameworks round bfloat16 at different points (XLA's CPU
backend keeps some fused elementwise chains in float32, PyTorch rounds after
every op), and the WKV state sums outer products of those bfloat16 k and v,
so its error follows the state's scale, not each entry's.  For scale: on
these inputs the reference's own bfloat16 WKV state lies 0.117 from its
float32 state (largest entry 9.46), and the port's lies 0.089 from the
reference's.  The reference's own prefill-vs-decode contract is 2e-3
(``tests/test_models_smoke.py``).  The reference runs under ``jax.jit``,
compiled once per case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models import rwkv6 as R
from repro.models.common import rms_norm as ref_rms_norm

from repro_torch.configs import get_config
from repro_torch.models import rwkv6
from repro_torch.models.common import rms_norm
from repro_torch.models.registry import get_model

FULL_PARAMS = 1_580_795_904
ref_time_mix = jax.jit(R.time_mix, static_argnums=2)
ref_channel_mix = jax.jit(R.channel_mix, static_argnums=2)
ref_block_fwd = jax.jit(R.block_fwd, static_argnums=2)
ref_prefill = jax.jit(R.prefill, static_argnums=2)
ref_decode_step = jax.jit(R.decode_step, static_argnums=4)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def configs(dt):
    jdt, tdt, _ = DTYPES[dt]
    ref = dataclasses.replace(ref_get_config("rwkv6-1.6b", reduced=True),
                              compute_dtype=jdt)
    port = dataclasses.replace(get_config("rwkv6-1.6b", reduced=True),
                               compute_dtype=tdt)
    return ref, port


def reference_tree(cfg, seed=0):
    """numpy weights in the reference's layout, at its scales."""
    shapes = jax.eval_shape(lambda k: R.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        shape = s.shape
        if name.startswith("mu_"):
            return rng.uniform(0.0, 1.0, shape)
        if name == "w0":
            return rng.uniform(-3.0, -0.5, shape)
        if name == "u":
            return rng.normal(size=shape) * 0.3
        if name in ("ln1", "ln2", "gn_scale", "final_norm"):
            return 1.0 + 0.1 * rng.normal(size=shape)
        if name == "embed":
            return rng.normal(size=shape) * 0.5
        fan_in = shape[-2]
        return rng.normal(size=shape) / np.sqrt(fan_in)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def tree():
    return reference_tree(configs("float32")[0])


def layer0(tree):
    return {n: a[0] for n, a in tree["layers"].items()}


def inputs(d, B=2, S=16, seed=1):
    rng = np.random.default_rng(seed)
    H, hd = d // 32, 32
    return dict(x=rng.normal(size=(B, S, d)).astype(np.float32),
                shift=rng.normal(size=(B, 1, d)).astype(np.float32),
                wkv=(rng.normal(size=(B, H, hd, hd)) * 0.3).astype(np.float32))


def close(got, want, tol, *, scaled=False):
    """allclose at atol = rtol = tol; ``scaled``: atol = tol * max|want|."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    atol = tol * max(1.0, float(np.abs(want).max())) if scaled else tol
    np.testing.assert_allclose(np.asarray(got.detach().float().cpu()), want,
                               atol=atol, rtol=tol)


def test_params_from_jax_round_trips(tree):
    cfg = configs("float32")[1]
    model = rwkv6.params_from_jax(tree, cfg, "cpu")
    back = rwkv6.params_to_jax(model)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(back_flat) == len(flat)
    for path, a in flat:
        assert np.array_equal(back_flat[path], a), path
    # the reference's (in, out) orientation is kept: x @ W
    layer = model.layers[1]
    assert layer.ck.shape == (cfg.d_model, cfg.d_ff)
    assert layer.cv.shape == (cfg.d_ff, cfg.d_model)
    assert np.array_equal(layer.cv.detach().numpy(), tree["layers"]["cv"][1])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_reference(tree, dt, with_state):
    rcfg, pcfg = configs(dt)
    jdt, tdt, tol = DTYPES[dt]
    inp = inputs(pcfg.d_model)
    kw_ref, kw = {}, {}
    if with_state:
        kw_ref = dict(shift_state=jnp.asarray(inp["shift"]).astype(jdt),
                      wkv_state=jnp.asarray(inp["wkv"]))
        kw = dict(shift_state=torch.from_numpy(inp["shift"]).to(tdt),
                  wkv_state=torch.from_numpy(inp["wkv"]))
    want, (w_shift, w_wkv) = ref_time_mix(
        layer0(tree), jnp.asarray(inp["x"]).astype(jdt), rcfg, **kw_ref)
    layer = rwkv6.params_from_jax(tree, pcfg, "cpu").layers[0]
    got, (g_shift, g_wkv) = layer.time_mix(
        torch.from_numpy(inp["x"]).to(tdt), **kw)
    assert got.dtype == tdt and g_wkv.dtype == torch.float32
    close(got, want, tol)
    close(g_shift, w_shift, tol)
    close(g_wkv, w_wkv, tol)


@pytest.mark.parametrize("dt", DTYPES)
def test_channel_mix_matches_reference(tree, dt):
    rcfg, pcfg = configs(dt)
    jdt, tdt, tol = DTYPES[dt]
    inp = inputs(pcfg.d_model)
    want, w_shift = ref_channel_mix(
        layer0(tree), jnp.asarray(inp["x"]).astype(jdt), rcfg,
        shift_state=jnp.asarray(inp["shift"]).astype(jdt))
    layer = rwkv6.params_from_jax(tree, pcfg, "cpu").layers[0]
    got, g_shift = layer.channel_mix(
        torch.from_numpy(inp["x"]).to(tdt),
        shift_state=torch.from_numpy(inp["shift"]).to(tdt))
    close(got, want, tol)
    close(g_shift, w_shift, tol)


@pytest.mark.parametrize("dt", DTYPES)
def test_block_fwd_matches_reference(tree, dt):
    rcfg, pcfg = configs(dt)
    jdt, tdt, tol = DTYPES[dt]
    inp = inputs(pcfg.d_model, S=12)
    want, w_st = ref_block_fwd(layer0(tree),
                               jnp.asarray(inp["x"]).astype(jdt), rcfg)
    layer = rwkv6.params_from_jax(tree, pcfg, "cpu").layers[0]
    got, g_st = layer(torch.from_numpy(inp["x"]).to(tdt))
    close(got, want, tol)
    for g, w in zip(g_st, w_st):
        close(g, w, tol)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    s = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    for jdt, tdt, tol in DTYPES.values():
        want = ref_rms_norm(jnp.asarray(x).astype(jdt), jnp.asarray(s))
        got = rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(s))
        assert got.dtype == tdt
        close(got, want, tol)


@pytest.fixture(scope="module")
def prefills(tree):
    """The reference's prefill (20 tokens: chunk 20) and one decode step
    after it, per compute type."""
    tokens = np.random.default_rng(3).integers(0, 384, size=(2, 20))
    next_tok = np.random.default_rng(4).integers(0, 384, size=(2, 1))
    out = {}
    for dt in DTYPES:
        rcfg, _ = configs(dt)
        logits, state = ref_prefill(tree, jnp.asarray(tokens, jnp.int32),
                                    rcfg)
        d_logits, d_state = ref_decode_step(tree, state,
                                          jnp.asarray(next_tok, jnp.int32),
                                          jnp.int32(20), rcfg)
        out[dt] = (logits, state, d_logits, d_state)
    return tokens, next_tok, out


@pytest.mark.parametrize("dt", DTYPES)
def test_prefill_matches_reference(tree, prefills, dt):
    _, pcfg = configs(dt)
    tol = DTYPES[dt][2]
    tokens, _, out = prefills
    want, w_state = out[dt][:2]
    model = rwkv6.params_from_jax(tree, pcfg, "cpu")
    got, g_state = rwkv6.prefill(model, torch.from_numpy(tokens))
    assert got.shape == (2, 1, pcfg.vocab)
    scaled = dt == "bfloat16"
    close(got, want, tol, scaled=scaled)
    assert set(g_state) == set(w_state) == {"shift_tm", "wkv", "shift_cm"}
    for name in w_state:
        assert tuple(g_state[name].shape) == w_state[name].shape
        assert g_state[name].dtype == (torch.float32 if name == "wkv"
                                       else pcfg.compute_dtype)
        close(g_state[name], w_state[name], tol, scaled=scaled)


@pytest.mark.parametrize("dt", DTYPES)
def test_decode_step_matches_reference(tree, prefills, dt):
    _, pcfg = configs(dt)
    tol = DTYPES[dt][2]
    _, next_tok, out = prefills
    _, w_state, want, w_new = out[dt]
    model = rwkv6.params_from_jax(tree, pcfg, "cpu")
    state = {n: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(
        pcfg.compute_dtype if n != "wkv" else torch.float32)
        for n, a in w_state.items()}
    got, g_new = rwkv6.decode_step(model, state, torch.from_numpy(next_tok),
                                   20)
    scaled = dt == "bfloat16"
    close(got, want, tol, scaled=scaled)
    for name in w_new:
        close(g_new[name], w_new[name], tol, scaled=scaled)


@pytest.mark.parametrize("S", [8, 11])
def test_prefill_equals_decode_steps(tree, S):
    """Prefill of S tokens == S single-token decode steps (float32), at
    the reference's 2e-3; S = 11 takes the odd-length chunk (11)."""
    _, pcfg = configs("float32")
    api = get_model(pcfg, device="cpu")
    model = rwkv6.params_from_jax(tree, pcfg, "cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(0, pcfg.vocab, size=(1, S)))
    logits_p, state_p = api.prefill(model, {"tokens": tokens}, 16)
    cache = rwkv6.init_state(pcfg, 1, "cpu")
    for t in range(S):
        logits_d, cache = api.decode(model, cache, tokens[:, t:t + 1], t)
    close(logits_d, logits_p.numpy(), 2e-3)
    close(cache["wkv"], state_p["wkv"].numpy(), 2e-3)


def test_wkv_chunk_follows_reference_selection():
    cfg = get_config("rwkv6-1.6b")
    for S, chunk in [(512, 256), (256, 256), (128, 128), (300, 4), (511, 1),
                     (20, 20), (768, 256), (640, 128)]:
        assert rwkv6.wkv_chunk(cfg, S) == chunk


@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_equal_the_reference(reduced):
    """Every field the port's config keeps has the reference's value."""
    port = get_config("rwkv6-1.6b", reduced=reduced)
    ref = ref_get_config("rwkv6-1.6b", reduced=reduced)
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(got, torch.dtype):
            got, want = str(got)[6:], jnp.dtype(want).name
        assert got == want, f.name


def test_full_width_parameter_count():
    cfg = get_config("rwkv6-1.6b")
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == \
        (24, 2048, 7168, 65536)
    assert cfg.param_dtype == torch.float32
    assert cfg.compute_dtype == torch.bfloat16
    model = rwkv6.RWKV6(cfg, device=torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == FULL_PARAMS
    shapes = jax.eval_shape(
        lambda k: R.init_params(k, ref_get_config("rwkv6-1.6b")),
        jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape))
               for a in jax.tree.leaves(shapes)) == FULL_PARAMS


def test_init_params_is_seeded_and_shaped_like_reference():
    _, pcfg = configs("float32")
    a = rwkv6.init_params(pcfg, torch.Generator().manual_seed(3), "cpu")
    b = rwkv6.init_params(pcfg, torch.Generator().manual_seed(3), "cpu")
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    got = rwkv6.params_to_jax(a)
    ref = jax.eval_shape(lambda k: R.init_params(k, configs("float32")[0]),
                         jax.random.PRNGKey(0))
    assert jax.tree.map(lambda x: x.shape, got) == \
        jax.tree.map(lambda x: x.shape, ref)
    layers = got["layers"]
    assert np.all(layers["w0"] == -6.0) and np.all(layers["u"] == 0.0)
    assert np.all(layers["mu_k"] == 0.5) and np.all(layers["ln1"] == 1.0)
    # a +-2 std truncated normal has std 0.8796; dense scale 1/sqrt(fan_in)
    assert np.std(layers["ck"]) == pytest.approx(0.8796 / 8, rel=0.05)
    assert np.std(got["embed"]) == pytest.approx(0.02, rel=0.05)


def test_unported_configs_and_families_raise():
    """Every config and family this test once pinned as unported is
    ported: each arch id of the reference builds in the port (reduced, on
    the CPU), the hybrid and audio families among them; an unknown arch
    raises KeyError and an unknown family ValueError, as in the
    reference."""
    families = set()
    for arch in REF_ARCH_IDS:
        cfg = get_config(arch, reduced=True)
        assert cfg.name == ref_get_config(arch, reduced=True).name
        api = get_model(cfg, device="cpu")
        assert api.cfg is cfg
        families.add(cfg.family)
    assert families == {"dense", "moe", "vlm", "ssm", "hybrid", "audio"}
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("jamba-2-mini")
    cfg = dataclasses.replace(get_config("rwkv6-1.6b", reduced=True),
                              family="speech")
    with pytest.raises(ValueError, match="unknown family"):
        get_model(cfg, device="cpu")


def test_cast_cache_follows_parameter_updates(tree):
    """Outside autograd (the inference entry points) a cast is kept until
    the parameter changes; under autograd every use casts anew, on the
    graph, so the parameter gets its gradient and nothing is kept."""
    _, pcfg = configs("bfloat16")
    layer = rwkv6.params_from_jax(tree, pcfg, "cpu").layers[0]
    with torch.no_grad():
        w1 = layer.w("wr", torch.bfloat16)
        assert w1.dtype == torch.bfloat16 and \
            layer.w("wr", torch.bfloat16) is w1
        layer.wr.mul_(2.0)
        w2 = layer.w("wr", torch.bfloat16)
        assert torch.equal(w2, layer.wr.detach().to(torch.bfloat16))
    assert layer.w("wr", torch.float32) is layer.wr
    w3 = layer.w("wr", torch.bfloat16)
    assert w3 is not w2 and w3.grad_fn is not None
    assert torch.equal(w3.detach(), w2)
    w3.float().sum().backward()
    assert layer.wr.grad is not None and torch.equal(
        layer.wr.grad, torch.ones_like(layer.wr))
