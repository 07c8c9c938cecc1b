"""WKV6 scan gradients of the port against ``jax.grad`` of the reference.

The reference has no backward Pallas kernel: its model differentiates the
chunked scan ``models/rwkv6.py::wkv_chunked`` with ``jax.grad``.  From the
same numpy-made r, k, v, log w, u, a nonzero s0 and output gradients on
both y and the final state (float32):

* ``wkv6_bwd_plain`` — the reverse walk K3' computes, with dlogw from
  running sums instead of a per-token product of state and gradient — is
  held to autograd through the per-token recurrence ``wkv6_plain``,
  including a decay strong enough to overflow the chunked form;
* autograd through the port's ``wkv6`` on the CPU (the chunked plain
  version) and ``wkv6_bwd`` (its CPU route) are held to ``jax.vjp`` of the
  reference's ``wkv_chunked``, at the reference's ``WKV_SWEEP`` shapes
  (``tests/test_kernels.py``) and at head sizes 1 and 2, which the port's
  ``wkv6`` pads to 4 around its kernels.

Every gradient (dr, dk, dv, dlogw, du, ds0) agrees within 1e-4 of its
tensor's largest magnitude.  K3' itself is held to ``wkv6_bwd_plain`` on
the card by ``tests/test_torch_wkv6_bwd_kernel.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv6 import wkv_chunked

from repro_torch.kernels.rwkv6 import (wkv6, wkv6_bwd, wkv6_bwd_plain,
                                       wkv6_plain)

REL = 1e-4
WKV_SWEEP = [
    # (B, S, H, hd, chunk), as in tests/test_kernels.py
    (1, 64, 1, 16, 16),
    (2, 128, 2, 32, 32),
    (1, 256, 4, 64, 64),
    (2, 96, 2, 8, 32),
    (1, 128, 2, 64, 128),                   # single chunk == full seq
]
PADDED = [(1, 32, 2, 1, 8), (2, 48, 2, 2, 16)]
NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: the per-token walks are
    many small CPU ops that gain nothing from a thread pool, and parallel
    test workers each spinning a full pool oversubscribe the cores."""
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
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
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


def _autograd(fn, args, dy, ds):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, s = fn(*leaves)
    return torch.autograd.grad((y, s), leaves,
                               (torch.from_numpy(dy), torch.from_numpy(ds)))


@pytest.mark.parametrize("log_decay", [-2.0, 1.5], ids=["mild", "strong"])
@pytest.mark.parametrize("shape", [(2, 40, 2, 8), (1, 70, 3, 16)], ids=str)
def test_reverse_walk_matches_autograd_through_the_recurrence(shape,
                                                              log_decay):
    """Under the strong decay log w is about -4.5 a token: the chunked
    form's k exp(-L) overflows there, the walk does not divide by w."""
    args, dy, ds = _inputs(*shape, log_decay=log_decay)
    want = [g.numpy() for g in _autograd(wkv6_plain, args, dy, ds)]
    got = wkv6_bwd_plain(*(torch.from_numpy(a) for a in args),
                         torch.from_numpy(dy), torch.from_numpy(ds))
    _check(got, want)


@pytest.mark.parametrize("shape", WKV_SWEEP + PADDED, ids=str)
def test_port_gradients_match_jax_grad_of_wkv_chunked(shape):
    B, S, H, hd, chunk = shape
    args, dy, ds = _inputs(B, S, H, hd)
    want = _jax_vjp(args, dy, ds, chunk)
    _check(_autograd(lambda *a: wkv6(*a, chunk=chunk), args, dy, ds), want)
    if hd >= 4:
        _check(wkv6_bwd(*(torch.from_numpy(a) for a in args),
                        torch.from_numpy(dy), torch.from_numpy(ds)), want)


def test_dlogw_identity_equals_the_per_token_product():
    """dlogw_t = w_t sum_j G_t S_{t-1} (the per-token product the walk
    avoids), computed directly in float64, equals the walk's running-sum
    form on a short sequence with s0 and dS_final nonzero."""
    args, dy, ds = _inputs(1, 12, 2, 4)
    r, k, v, lw, u, s0 = (torch.from_numpy(a).double() for a in args)
    dy, ds = torch.from_numpy(dy).double(), torch.from_numpy(ds).double()
    w = torch.exp(lw)
    states, S = [], s0
    for t in range(r.shape[1]):
        states.append(S)
        S = w[:, t][..., None] * S + torch.einsum("bhk,bhv->bhkv", k[:, t],
                                                  v[:, t])
    G, want = ds, [None] * r.shape[1]
    for t in reversed(range(r.shape[1])):
        want[t] = w[:, t] * (G * states[t]).sum(-1)
        G = w[:, t][..., None] * G + torch.einsum("bhk,bhv->bhkv", r[:, t],
                                                  dy[:, t])
    got = wkv6_bwd_plain(r, k, v, lw, u, s0, dy, ds)[3]
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(),
                               rtol=1e-5, atol=1e-6)
