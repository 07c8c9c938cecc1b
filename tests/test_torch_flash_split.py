"""K2 / K2' with a key offset and split-key attention against the reference.

The reference shards the keys' sequence over "model" where the query
heads do not divide it (``repro/models/common.py::_kv_seq_spec``, inside
``full_attention``); the port runs each rank's block of the keys with the
block's offset and combines the blocks' softmaxes
(``repro_torch/kernels/flash/split.py``).  On the CPU, with the same
numpy-made float32 q, k, v and output gradient:

* the plain versions with a key offset (``attention_plain``,
  ``attention_lse_plain``, ``flash_bwd_plain``: the functions K2 / K2'
  compute) on each block of the keys, summed by the log-sum-exp
  combine, against ``jax.vjp`` of the reference's ``full_attention`` over
  the whole sequence: the forward within 2e-5 and dq, dk, dv within 1e-4
  (absolute), the flash contracts in float32;
* the rows a block sees no key of: a zero output row, lse -inf, zero dq,
  no NaN (every block but the first under the causal mask);
* ``split_key_local`` (autograd through the plain ops) and
  ``SplitKeyAttention`` (the plain versions, K2 / K2' on the card) over M
  ranks simulated by threads whose ``reduce`` meets at a barrier: even
  and uneven blocks, an empty one, causal and not, with a window.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as C

from repro_torch.kernels.flash import (attention_lse_plain, attention_plain,
                                       flash_bwd_plain)
from repro_torch.kernels.flash.kernel import mask_pairs
from repro_torch.kernels.flash.split import (SplitKeyAttention, key_blocks,
                                             split_key_local)

FWD_ATOL, GRAD_ATOL = 2e-5, 1e-4
# (B, S, H, KV, hd, M, causal, window)
CASES = [
    (2, 32, 6, 2, 16, 4, True, 0),         # even blocks, GQA 3:1
    (1, 37, 3, 1, 16, 4, True, 0),         # uneven: 10, 10, 10, 7
    (2, 40, 4, 4, 32, 2, False, 0),        # no mask (whisper's encoder)
    (1, 48, 4, 2, 16, 3, True, 7),         # a window inside the blocks
    (1, 5, 2, 1, 16, 4, True, 0),          # 2, 2, 1 and an empty block
]
IDS = ["even", "uneven", "no_mask", "window", "empty_block"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, KV, hd, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                      (B, S, H, hd))]


def _vjp(q, k, v, do, causal, window):
    g = q.shape[2] // k.shape[2]

    def attn(q, k, v):
        return C.full_attention(q, jnp.repeat(k, g, axis=2),
                                jnp.repeat(v, g, axis=2), causal=causal,
                                window=window)

    out, vjp = jax.vjp(attn, q, k, v)
    return (out,) + tuple(vjp(do))


_jitted = jax.jit(_vjp, static_argnames=("causal", "window"))


def _reference(q, k, v, do, causal, window):
    """(out, dq, dk, dv) of the reference's whole attention, as numpy."""
    return tuple(np.asarray(x)
                 for x in _jitted(q, k, v, do, causal, window))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_offset_blocks_combine_to_the_references_attention(case):
    """The plain K2 / K2' on each block with its offset, combined by the
    log-sum-exp, give the reference's whole attention and gradients."""
    B, S, H, KV, hd, M, causal, window = case
    q, k, v, do = _inputs(B, S, H, KV, hd)
    want = _reference(q, k, v, do, causal, window)
    q, k, v, do = map(_t, (q, k, v, do))
    parts = []
    for lo, hi in key_blocks(S, M):
        if hi > lo:
            kb, vb = k[:, lo:hi], v[:, lo:hi]
            parts.append((lo, hi, attention_plain(
                q, kb, vb, causal=causal, window=window, k_offset=lo),
                attention_lse_plain(q, kb, causal=causal, window=window,
                                    k_offset=lo)))
    lse = torch.logsumexp(torch.stack([p[3] for p in parts]), dim=0)
    out = sum(torch.exp(p[3] - lse).transpose(1, 2)[..., None] * p[2]
              for p in parts)
    np.testing.assert_allclose(out.numpy(), want[0], atol=FWD_ATOL, rtol=0)
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for lo, hi, _, _ in parts:
        gq, gk, gv = flash_bwd_plain(q, k[:, lo:hi], v[:, lo:hi], out, do,
                                     lse, causal=causal, window=window,
                                     k_offset=lo)
        dq += gq
        dk[:, lo:hi], dv[:, lo:hi] = gk, gv
    for got, w in zip((dq, dk, dv), want[1:]):
        np.testing.assert_allclose(got.numpy(), w, atol=GRAD_ATOL, rtol=0)


def test_rows_before_the_block_see_no_key():
    """Under the causal mask the rows before a block's first key keep no
    key of it: zero output, lse -inf, zero dq (from the block's own lse
    too), no NaN; the pairs counted are those kept."""
    B, S, H, KV, hd = 1, 24, 2, 1, 16
    q, k, v, do = map(_t, _inputs(B, S, H, KV, hd))
    lo = 16
    kb, vb = k[:, lo:], v[:, lo:]
    out = attention_plain(q, kb, vb, k_offset=lo)
    lse = attention_lse_plain(q, kb, k_offset=lo)
    assert torch.all(out[:, :lo] == 0)
    assert torch.all(torch.isneginf(lse[..., :lo]))
    assert torch.isfinite(out).all() and torch.isfinite(lse[..., lo:]).all()
    dq, dk, dv = flash_bwd_plain(q, kb, vb, out, do, lse, k_offset=lo)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert torch.all(dq[:, :lo] == 0)
    # row lo + i keeps keys lo .. lo + i of the block
    assert mask_pairs(S, S - lo, True, 0, lo) == sum(range(1, S - lo + 1))
    assert mask_pairs(S, S - lo, True, 3, lo) == 3 * (S - lo) - 3


def _threaded(M, fn):
    """fn(m, reduce) on M threads; ``reduce`` sums or maxes a tensor over
    them at a barrier.  Returns the results in rank order."""
    barrier = threading.Barrier(M, timeout=60)
    slots, outs, errors = [None] * M, [None] * M, []

    def run(m):
        def reduce(t, op):
            slots[m] = t.clone()
            barrier.wait()
            stack = torch.stack(slots)
            barrier.wait()
            return stack.sum(0) if op == "sum" else stack.amax(0)
        try:
            outs[m] = fn(m, reduce)
        except BaseException as e:          # reported below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(m,)) for m in range(M)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return outs


@pytest.mark.parametrize("route", ["autograd", "function"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_key_attention_over_simulated_ranks(case, route):
    """Each simulated rank holds q whole and its block of k, v: the
    output is the reference's on every rank, dq (summed over the ranks)
    too, and the blocks' dk, dv joined are the reference's."""
    B, S, H, KV, hd, M, causal, window = case
    q, k, v, do = _inputs(B, S, H, KV, hd)
    want = _reference(q, k, v, do, causal, window)
    q, k, v, do = map(_t, (q, k, v, do))
    blocks = key_blocks(S, M)

    def rank(m, reduce):
        lo, hi = blocks[m]
        qm = q.clone().requires_grad_(True)
        km, vm = (t[:, lo:hi].clone().requires_grad_(True) for t in (k, v))
        if route == "autograd":
            out = split_key_local(qm, km, vm, k_offset=lo, reduce=reduce,
                                  causal=causal, window=window)
        else:
            out = SplitKeyAttention.apply(qm, km, vm, lo, causal, window,
                                          reduce)
        return (out.detach(),) + torch.autograd.grad(out, (qm, km, vm), do)

    outs = _threaded(M, rank)
    for out, dq, _, _ in outs:
        np.testing.assert_allclose(out.numpy(), want[0], atol=FWD_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(dq.numpy(), want[1], atol=GRAD_ATOL,
                                   rtol=0)
    for i in (2, 3):
        joined = torch.cat([o[i] for o in outs], dim=1)
        np.testing.assert_allclose(joined.numpy(), want[i], atol=GRAD_ATOL,
                                   rtol=0)
