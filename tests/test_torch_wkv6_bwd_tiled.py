"""The WKV6 backward in the decomposition K3' computes, in plain PyTorch,
against the reference and the per-token reverse walk.

``wkv6_bwd_tiled_plain`` computes the backward as K3' does: the gradient
state at each 64-token tile's end by a reverse walk over the tiles, then
every tile from its entering state, in 16-token sub-tiles, with dlogw from
c = rowsum(S o G) at the tile's end.  From the same numpy-made r, k, v,
log w, u, a nonzero s0 and output gradients on both y and the final state
(float32), it is held

* to ``jax.vjp`` of the reference's ``wkv_chunked`` at the reference's
  ``WKV_SWEEP`` shapes (``tests/test_kernels.py``): every gradient (dr, dk,
  dv, dlogw, du, ds0) within 1e-4 of its tensor's largest magnitude;
* to ``wkv6_bwd_plain`` (the per-token walk, which never overflows) under a
  strong decay (log w about -4.5 a token, where the reference's chunked
  form overflows float32) and at ragged lengths (130 and 511 tokens: the
  last tile is 2 and 63 tokens), within the same 1e-4.

``chip_smoke.py`` holds the CUDA kernel to this plain version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv6 import wkv_chunked

from repro_torch.kernels.rwkv6 import wkv6_bwd_plain, wkv6_bwd_tiled_plain

REL = 1e-4
WKV_SWEEP = [
    # (B, S, H, hd, chunk), as in tests/test_kernels.py
    (1, 64, 1, 16, 16),
    (2, 128, 2, 32, 32),
    (1, 256, 4, 64, 64),
    (2, 96, 2, 8, 32),
    (1, 128, 2, 64, 128),                   # single chunk == full seq
]
#: (B, S, H, hd, log_decay): log w = -exp(N(0, 0.5) + log_decay)
WALK_CASES = [(1, 130, 2, 16, 1.5), (1, 511, 2, 8, 1.5), (2, 130, 2, 8, -2.0),
              (1, 511, 1, 16, -2.0), (1, 9, 2, 8, 1.5)]
NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: its many small CPU ops
    gain nothing from a thread pool, and parallel test workers each
    spinning a full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, hd, seed=7, log_decay=-2.0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = (n(B, S, H, hd) * 0.5 for _ in range(3))
    logw = -np.exp(n(B, S, H, hd) * 0.5 + log_decay)
    u, s0 = n(H, hd) * 0.3, n(B, H, hd, hd) * 0.2
    dy, ds = n(B, S, H, hd) * 0.5, n(B, H, hd, hd) * 0.2
    return [r, k, v, logw, u, s0], dy, ds


def _check(got, want):
    for name, g, w in zip(NAMES, got, want):
        g, w = (x.detach().numpy() if isinstance(x, torch.Tensor) else x
                for x in (g, w))
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert g.shape == w.shape and err <= REL * scale, (name, err, scale)


def _vjp(r, k, v, logw, u, s0, dy, ds, chunk):
    return jax.vjp(lambda *a: wkv_chunked(*a, chunk=chunk),
                   r, k, v, logw, u, s0)[1]((dy, ds))


# compiled once per shape (op-by-op dispatch costs more than the compile)
_vjp = jax.jit(_vjp, static_argnames="chunk")


def _jax_vjp(args, dy, ds, chunk):
    return [np.asarray(g) for g in _vjp(*(jnp.asarray(a) for a in args),
                                        jnp.asarray(dy), jnp.asarray(ds),
                                        chunk=chunk)]


def _torch(args, dy, ds):
    return [torch.from_numpy(a) for a in args], torch.from_numpy(dy), \
        torch.from_numpy(ds)


@pytest.mark.parametrize("shape", WKV_SWEEP, ids=str)
def test_tiled_backward_matches_jax_vjp_of_wkv_chunked(shape):
    B, S, H, hd, chunk = shape
    args, dy, ds = _inputs(B, S, H, hd)
    targs, tdy, tds = _torch(args, dy, ds)
    got = wkv6_bwd_tiled_plain(*targs, tdy, tds)
    _check(got, _jax_vjp(args, dy, ds, chunk))


@pytest.mark.parametrize("case", WALK_CASES, ids=str)
def test_tiled_backward_matches_the_reverse_walk(case):
    B, S, H, hd, log_decay = case
    args, dy, ds = _torch(*_inputs(B, S, H, hd, log_decay=log_decay))
    got = wkv6_bwd_tiled_plain(*args, dy, ds)
    assert all(torch.isfinite(g).all() for g in got)
    _check(got, wkv6_bwd_plain(*args, dy, ds))


def test_tiles_and_sub_tiles_of_other_sizes_agree():
    """The decomposition is exact for any tiling: 32-token tiles of
    8-token sub-tiles give the same gradients as the kernel's 64 / 16."""
    args, dy, ds = _torch(*_inputs(1, 100, 2, 8, log_decay=1.5))
    _check(wkv6_bwd_tiled_plain(*args, dy, ds, tile=32, sub=8),
           wkv6_bwd_tiled_plain(*args, dy, ds))
