"""The MoE FFN of the port (``repro_torch/models/moe.py``) against the
reference's ``repro/models/moe.py``, piece by piece, on the same numpy-made
inputs.

* ``expert_capacity`` ``==`` over a grid of (S, E, K, cf), with S = 1 and
  whole-number values of K S / E cf in it.
* The routing (``buf``, ``tok_slot``, ``keep``, ``slot``, the sorted
  pairs' tokens) ``==`` the reference's ``_route_row`` (over every row) on
  the same logits; the gates (``w_slot``) within 1e-6 relative: XLA's and
  torch's float32 ``exp`` differ in the last bit for about one value in
  ten, so the softmax cannot agree bit for bit.
* The combine against both of the reference's routes, the scatter and the
  gather, called on the same expert outputs and the reference's own
  routing (gates included): ``==`` the gather route, which sums each
  token's picks one at a time in ascending expert order as the port does;
  within 1e-6 of the largest magnitude of the scatter route, whose sum
  over the experts XLA reduces in another order at K = 8 (there the
  reference's two routes differ from each other by an ulp).
* ``moe_ffn`` and its gradients (x and the four weights) in float32 within
  1e-5 (the output) and 1e-4 (the gradients) of each tensor's largest
  magnitude, at ``moe_ff_chunks`` 1 and 2, on a row long enough that
  tokens are dropped; one bfloat16 call within 3e-2.
* ``aux_load_balance_loss`` and the counterpart of
  ``tests/test_models_smoke.py::test_moe_capacity_drops_are_bounded``.
"""

import dataclasses
import functools
import itertools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as R

from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models import transformer

OUT_REL = 1e-5
GRAD_REL = 1e-4
BF16_REL = 3e-2
GATE_RTOL = 1e-6
SCATTER_REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread: the small CPU ops gain nothing from a
    thread pool, and parallel test workers each spinning a full pool
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch="qwen3-moe-235b-a22b", dt="float32", **changes):
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    ref = dataclasses.replace(ref_get_config(arch, reduced=True),
                              compute_dtype=jdt, **changes)
    port = dataclasses.replace(get_config(arch, reduced=True),
                               compute_dtype=tdt, **changes)
    return ref, port


def weights(cfg, seed=0) -> dict:
    """numpy MoE weights of one layer in the reference's layout; the
    router's first column is 3x the others, so expert 0 is picked more
    often than its capacity allows."""
    rng = np.random.default_rng(seed)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    router = rng.normal(size=(d, E)) / np.sqrt(d)
    router[:, 0] *= 3.0
    return {"router": router,
            "w_gate": rng.normal(size=(E, d, ff)) / np.sqrt(d),
            "w_up": rng.normal(size=(E, d, ff)) / np.sqrt(d),
            "w_down": rng.normal(size=(E, ff, d)) / np.sqrt(ff)}


def port_moe(cfg, w) -> moe.MoEFFN:
    m = moe.MoEFFN(cfg, "cpu")
    with torch.no_grad():
        for name, a in w.items():
            getattr(m, name).copy_(torch.from_numpy(a))
    return m


def rel(got, want) -> float:
    got = np.asarray(got.detach().float()) if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def ref_route(logits, x, C, E, K):
    return jax.vmap(lambda xr, lr: R._route_row(xr, lr, C, E, K))(x, logits)


GRID = list(itertools.product((1, 2, 3, 7, 8, 40, 64, 100, 512, 4096),
                              (5, 8, 40, 128), (1, 2, 8),
                              (1.0, 1.25, 1.5, 2.0)))


def test_expert_capacity_equals_reference():
    whole = 0
    for S, E, K, cf in GRID:
        cfg = SimpleNamespace(moe_top_k=K, moe_experts=E, capacity_factor=cf)
        assert moe.expert_capacity(S, cfg) == R.expert_capacity(S, cfg), \
            (S, E, K, cf)
        whole += float(K * S / E * cf).is_integer()
    assert whole > 50
    decode = SimpleNamespace(moe_top_k=8, moe_experts=128,
                             capacity_factor=1.25)
    assert moe.expert_capacity(1, decode) == 4


@pytest.mark.parametrize("B,S,E,K", [(2, 64, 8, 2), (1, 37, 5, 2),
                                     (3, 20, 40, 8), (1, 1, 128, 8)])
def test_routing_equals_reference(B, S, E, K):
    rng = np.random.default_rng(S * E + K)
    logits = rng.normal(size=(B, S, E)).astype(np.float32)
    x = rng.normal(size=(B, S, 16)).astype(np.float32)
    cfg = SimpleNamespace(moe_top_k=K, moe_experts=E, capacity_factor=1.25)
    C = moe.expert_capacity(S, cfg)
    buf, (tok, w, keep, slot, st, sw) = ref_route(logits, x, C, E, K)
    r = moe.route(torch.from_numpy(logits), C, E, K)
    got_buf, got_tok, got_w = moe.dispatch(torch.from_numpy(x), r)
    assert np.array_equal(got_buf.numpy(), np.asarray(buf))
    assert np.array_equal(got_tok.numpy(), np.asarray(tok))
    assert np.array_equal(r.keep.numpy(), np.asarray(keep))
    assert np.array_equal(r.slot.numpy(), np.asarray(slot))
    assert np.array_equal(r.token.numpy(), np.asarray(st))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(w), rtol=GATE_RTOL,
                               atol=0)
    np.testing.assert_allclose(r.gate.numpy(), np.asarray(sw),
                               rtol=GATE_RTOL, atol=0)


@pytest.mark.parametrize("B,S,E,K", [(2, 64, 8, 2), (1, 300, 5, 2),
                                     (2, 20, 40, 8)])
def test_combine_equals_both_reference_routes(B, S, E, K):
    rng = np.random.default_rng(S + E)
    logits = rng.normal(size=(B, S, E)).astype(np.float32)
    d = 24
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    cfg = SimpleNamespace(moe_top_k=K, moe_experts=E, capacity_factor=1.0)
    C = moe.expert_capacity(S, cfg)
    out = rng.normal(size=(B, E, C, d)).astype(np.float32)
    _, info = ref_route(logits, x, C, E, K)
    scatter = jax.jit(jax.vmap(
        lambda o, i: R._combine_row_scatter(o, i, S, d)))(out, info)
    gather = jax.jit(jax.vmap(lambda o, i: R._combine_row_gather(
        o.reshape(E * C, d), i, S, d)))(out, info)
    keep, slot, st, sw = (torch.from_numpy(np.array(a)) for a in info[2:])
    assert not bool(keep.all())            # some pairs are dropped
    r = moe.Routing(idx=torch.zeros((B, S, K), dtype=torch.long),
                    gates=None, expert=slot // C, token=st.long(), gate=sw,
                    keep=keep, slot=slot.long(), C=C, E=E)
    got = moe.combine(torch.from_numpy(out), r).numpy()
    assert np.array_equal(got, np.asarray(gather))
    assert rel(got, scatter) <= SCATTER_REL


_ref_moe = jax.jit(R.moe_ffn, static_argnums=2)


@pytest.mark.parametrize("chunks", [1, 2])
def test_moe_ffn_and_gradients_match_reference(chunks):
    rcfg, pcfg = configs(moe_ff_chunks=chunks)
    w = {k: v.astype(np.float32) for k, v in weights(rcfg).items()}
    x = np.random.default_rng(5).normal(
        size=(2, 96, rcfg.d_model)).astype(np.float32)
    C = moe.expert_capacity(96, pcfg)
    m = port_moe(pcfg, w)
    xt = torch.from_numpy(x).requires_grad_()
    r = moe.route(moe.router_logits(m, xt.detach()), C, pcfg.moe_experts,
                  pcfg.moe_top_k)
    assert not bool(r.keep.all())          # the row drops tokens
    y = moe.moe_ffn(m, xt)
    want = _ref_moe(w, x, rcfg)
    assert rel(y, want) <= OUT_REL
    cot = np.random.default_rng(6).normal(size=y.shape).astype(np.float32)
    gw, gx = jax.jit(jax.grad(
        lambda p, xx: jnp.sum(R.moe_ffn(p, xx, rcfg) * cot),
        argnums=(0, 1)))(w, x)
    (y * torch.from_numpy(cot)).sum().backward()
    assert rel(xt.grad, gx) <= GRAD_REL
    for name in w:
        assert rel(getattr(m, name).grad, gw[name]) <= GRAD_REL, name


def test_moe_ffn_bfloat16_matches_reference():
    rcfg, pcfg = configs(dt="bfloat16")
    w = {k: v.astype(np.float32) for k, v in weights(rcfg, 1).items()}
    x = np.random.default_rng(7).normal(size=(1, 40, rcfg.d_model))
    want = _ref_moe(w, jnp.asarray(x, jnp.bfloat16), rcfg)
    got = moe.moe_ffn(port_moe(pcfg, w),
                      torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert rel(got, want) <= BF16_REL


def test_aux_load_balance_loss_matches_reference():
    rcfg, pcfg = configs()
    logits = np.random.default_rng(2).normal(
        size=(2, 30, rcfg.moe_experts)).astype(np.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)),
                           rcfg.moe_top_k)
    want = R.aux_load_balance_loss(jnp.asarray(logits), idx, rcfg)
    got = moe.aux_load_balance_loss(torch.from_numpy(logits),
                                    torch.from_numpy(np.array(idx)), pcfg)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_moe_capacity_drops_are_bounded():
    """With capacity factor 1.25, > 60% of routed tokens survive dispatch
    (the reference's structure check on the combine)."""
    cfg = get_config("qwen3-moe-235b-a22b", reduced=True)
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).to(
        cfg.compute_dtype)
    with torch.no_grad():
        y = model.layers[0].moe(x)
    assert y.shape == x.shape
    assert float((y.float().abs().sum(-1) > 0).float().mean()) > 0.6
