"""The sliding window of the port's attention (K2's and K2''s plain
versions and their wrappers) against the reference's.

The reference masks ``kpos > qpos - window`` beside the causal mask in its
model attention, ``full_attention`` and ``chunked_attention``
(``src/repro/models/common.py:235-236,276-277``); its Pallas kernel takes
no window.  The same numpy-made q, k, v and output gradient, in float32,
go at windows 1, 7, 64 and one at least S long (no effect), with GQA 2:1,
MQA and MHA, to

* ``attention_plain`` and ``flash_attention`` (its CPU route) against
  ``full_attention`` and ``chunked_attention`` (at a small ``chunk``, so it
  crosses several blocks and pads the last), with K and V repeated per
  query head as the reference's model does: atol = rtol = 2e-5, the
  reference's float32 flash tolerance; in bfloat16 at 2e-2;
* ``attention_lse_plain`` against a float64 numpy log-sum-exp over the
  kept keys;
* ``flash_bwd_plain`` fed the forward's output and log-sum-exp, autograd
  through ``flash_attention`` and ``FlashAttention`` (the route K2 / K2'
  take on the card) against ``jax.vjp`` of both reference branches: dq, dk
  and dv within 1e-5 of each tensor's largest magnitude, as in
  ``tests/test_torch_attention_grad.py`` (where the reference's tensor is
  exactly zero, dq at window 1, of the three gradients' largest).

The kernels themselves are held to these plain versions on the card by
``tests/test_torch_flash_kernel.py``, ``tests/test_torch_flash_bwd_kernel.py``
(cases marked ``cuda``) and ``chip_smoke.py`` phase 19.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as C

from repro_torch.kernels.flash import (FlashAttention, attention_lse_plain,
                                       attention_plain, flash_attention,
                                       flash_attention_bwd, flash_bwd_plain)

FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_REL = 1e-5
WINDOWS = (1, 7, 64, 4096)
SHAPES = [
    # (B, S, H, KV, hd): self-attention, as the model calls it
    (2, 40, 4, 2, 16),          # GQA 2:1
    (1, 77, 4, 1, 32),          # MQA, a length off every block
    (1, 24, 3, 3, 8),           # MHA, the smallest head size of a config
]
#: the chunked branch's query block (the model's attn_chunk, made small)
CHUNK = 16


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: its small CPU ops gain
    nothing from a thread pool, and parallel test workers each spinning a
    full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, KV, hd, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                      (B, S, H, hd))]


def _ref_attention(q, k, v, window, branch):
    g = q.shape[2] // k.shape[2]
    kf, vf = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
    if branch == "full":
        return C.full_attention(q, kf, vf, causal=True, window=window)
    return C.chunked_attention(q, kf, vf, causal=True, window=window,
                               chunk=CHUNK)


# compiled once per shape and window (op-by-op dispatch costs more)
_ref_fwd = jax.jit(_ref_attention, static_argnames=("window", "branch"))


_ref_vjp = jax.jit(
    lambda q, k, v, do, window, branch: jax.vjp(
        lambda *a: _ref_attention(*a, window, branch), q, k, v)[1](do),
    static_argnames=("window", "branch"))


def _check_grads(got, want):
    """Each gradient within GRAD_REL of its largest magnitude.  At window 1
    a row sees one key, its softmax is constant and dq is exactly 0 in the
    reference; the port's P (dP - D) leaves rounding of dP - D there, held
    to GRAD_REL of the largest magnitude of the three gradients."""
    largest = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        scale = np.abs(w).max() or largest
        err = np.abs(g - w).max()
        assert err <= GRAD_REL * scale, (name, err, scale)


@pytest.mark.parametrize("dt", FWD_TOL)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_window_matches_reference_attention(shape, window, dt):
    arrays = _inputs(*shape)[:3]
    jdt = jnp.float32 if dt == "float32" else jnp.bfloat16
    tdt = torch.float32 if dt == "float32" else torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    q, k, v = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
               for a in (jq, jk, jv))
    got = attention_plain(q, k, v, causal=True, window=window)
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v, causal=True, window=window),
                       got)
    assert flash_attention.launches == before          # CPU: no kernel ran
    tol = FWD_TOL[dt]
    for branch in ("full", "chunked"):
        want = _ref_fwd(jq, jk, jv, window=window, branch=branch)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol, err_msg=branch)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_lse_is_over_the_kept_keys(shape, window):
    B, S, H, KV, hd = shape
    q, k = (torch.from_numpy(a) for a in _inputs(*shape)[:2])
    lse = attention_lse_plain(q, k, causal=True, window=window)
    s = np.einsum("bshd,bthd->bhst", q.numpy().astype(np.float64),
                  np.repeat(k.numpy(), H // KV, 2).astype(np.float64))
    s = s / np.sqrt(hd)
    pos = np.arange(S)
    keep = (pos[None, :] <= pos[:, None]) & \
        (pos[None, :] > pos[:, None] - window)
    s = np.where(keep, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (B, H, S) and torch.isfinite(lse).all()
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)
    if window == 1:      # one key a row: its lse is the row's own score
        np.testing.assert_allclose(
            lse.numpy(), np.diagonal(np.where(keep, s, 0.0), 0, 2, 3),
            rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_window_gradients_match_jax_grad(shape, window):
    arrays = _inputs(*shape)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    jarr = [jnp.asarray(a) for a in arrays]
    full = _ref_vjp(*jarr, window=window, branch="full")
    chunked = _ref_vjp(*jarr, window=window, branch="chunked")
    # the plain backward from the forward's output and lse (K2''s inputs)
    out = attention_plain(q, k, v, causal=True, window=window)
    lse = attention_lse_plain(q, k, causal=True, window=window)
    plain = flash_bwd_plain(q, k, v, out, do, lse, causal=True,
                            window=window)
    assert all(torch.equal(a, b) for a, b in zip(
        flash_attention_bwd(q, k, v, out, do, lse, causal=True,
                            window=window), plain))
    _check_grads(plain, full)
    _check_grads(plain, chunked)
    # autograd through the wrapper (plain version) and FlashAttention
    for route in ("wrapper", "function"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = (flash_attention(*leaves, causal=True, window=window)
               if route == "wrapper"
               else FlashAttention.apply(*leaves, True, window))
        _check_grads(torch.autograd.grad(out, leaves, do), full)


def test_window_validation():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 1, 16))
    with pytest.raises(ValueError, match="only with the causal mask"):
        flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="integer >= 0"):
        flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="integer >= 0"):
        FlashAttention.apply(q, k, v, True, 2.5)
    # window 0 is no window; a window >= S is none either
    assert torch.equal(flash_attention(q, k, v, window=0),
                       flash_attention(q, k, v))
    assert torch.equal(flash_attention(q, k, v, window=8),
                       flash_attention(q, k, v))
