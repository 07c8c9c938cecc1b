"""Attention gradients of the port against ``jax.grad`` of the reference.

The reference has no backward Pallas kernel: its model differentiates
``full_attention`` (S <= ``attn_chunk``) and ``chunked_attention``
(longer sequences, online softmax over query blocks) with ``jax.grad``,
after repeating K and V per query head.  The same numpy-made q, k, v and
output gradient go, in float32, to

* ``jax.vjp`` of the reference's attention (both branches; the chunked one
  at a small ``chunk`` so it crosses several blocks and pads the last);
* the port's ``flash_attention`` on the CPU (autograd through
  ``attention_plain``);
* the port's ``FlashAttention`` on the CPU (its forward's log-sum-exp,
  ``attention_lse_plain``, and its backward, ``flash_bwd_plain``: the
  equations K2' computes);

at the ``FLASH_SWEEP`` shapes (GQA 4:1, MQA, a length that is not a
multiple of the tile, cross lengths) and a ragged 77-token shape at hd 16.
dq, dk and dv agree within 1e-5 of each tensor's largest magnitude.  K2'
itself is held to ``flash_bwd_plain`` on the card by
``tests/test_torch_flash_bwd_kernel.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as C

from repro_torch.kernels.flash import (FlashAttention, attention_lse_plain,
                                       flash_attention, flash_bwd_plain)

REL = 1e-5
SHAPES = [
    # (B, S, T, H, KV, hd, causal)
    (1, 64, 64, 2, 2, 32, True),
    (2, 128, 128, 4, 2, 64, True),
    (1, 200, 200, 4, 4, 64, True),          # not a multiple of the tile
    (2, 128, 256, 8, 2, 128, False),        # cross lengths, GQA 4:1
    (1, 96, 96, 8, 1, 64, True),            # MQA
    (2, 77, 77, 4, 1, 16, True),            # ragged, hd 16
]
#: the chunked branch's query block (the model's attn_chunk, made small)
CHUNK = 32


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: its many small CPU ops
    gain nothing from a thread pool, and parallel test workers each
    spinning a full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, T, H, KV, hd, seed=42):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd),
                      (B, S, H, hd))]


def _vjp(q, k, v, do, causal, branch):
    g = q.shape[2] // k.shape[2]

    def attn(q, k, v):
        kf, vf = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
        if branch == "full":
            return C.full_attention(q, kf, vf, causal=causal)
        return C.chunked_attention(q, kf, vf, causal=causal, chunk=CHUNK)

    return jax.vjp(attn, q, k, v)[1](do)


# compiled once per shape (op-by-op dispatch costs more than the compile)
_vjp = jax.jit(_vjp, static_argnames=("causal", "branch"))


def _ref_grads(arrays, causal, branch):
    return [np.asarray(x) for x in _vjp(*(jnp.asarray(a) for a in arrays),
                                        causal=causal, branch=branch)]


def _check(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= REL * scale, (name, err, scale)


@pytest.fixture(scope="module")
def ref_grads():
    cache = {}

    def get(shape, branch):
        if (shape, branch) not in cache:
            cache[shape, branch] = _ref_grads(_inputs(*shape[:6]), shape[6],
                                              branch)
        return cache[shape, branch]
    return get


@pytest.mark.parametrize(
    "shape,branch",
    [(s, "full") for s in SHAPES]
    # the model's chunked branch is causal self-attention
    + [(s, "chunked") for s in SHAPES if s[6] and s[1] == s[2]], ids=str)
def test_autograd_through_the_plain_version_matches_jax_grad(
        shape, branch, ref_grads):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(*shape[:6]))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=shape[6])
    _check(torch.autograd.grad(out, leaves, do), ref_grads(shape, branch))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_flash_attention_function_matches_jax_grad(shape, ref_grads):
    """FlashAttention on the CPU: the forward's lse and the backward's
    flash_bwd_plain, the equations of K2'."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(*shape[:6]))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FlashAttention.apply(*leaves, shape[6])
    _check(torch.autograd.grad(out, leaves, do), ref_grads(shape, "full"))


@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
def test_flash_bwd_plain_from_lse_matches_jax_grad(shape, ref_grads):
    """The plain backward fed the forward's output and log-sum-exp, as K2'
    is; the lse is the row's log-sum-exp of the masked, scaled scores."""
    B, S, T, H, KV, hd, causal = shape
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(*shape[:6]))
    out = flash_attention(q, k, v, causal=causal)
    lse = attention_lse_plain(q, k, causal=causal)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    s = np.einsum("bshd,bthd->bhst", q.numpy().astype(np.float64),
                  np.repeat(k.numpy(), H // KV, 2).astype(np.float64))
    s = s / np.sqrt(hd)
    if causal:
        s = np.where(np.tril(np.ones((S, T), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)
    _check(flash_bwd_plain(q, k, v, out, do, lse, causal=causal),
           ref_grads(shape, "full"))
