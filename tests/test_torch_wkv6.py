"""K3 parity: the port's WKV6 scan against the reference.

The same numpy-made inputs go through the reference (the per-token oracle
``wkv6_ref`` and the Pallas kernel ``wkv6``, run in interpret mode on the
CPU as its own tests run it) and through the port's plain versions
(``wkv6_plain``, the per-token recurrence, and ``wkv6_chunked_plain``, the
reference's chunked math, and ``wkv6_tiled_plain``, the CUDA kernel's
two-pass decomposition over 64-token tiles), over the reference's
``WKV_SWEEP`` shapes.  Tolerances are the reference's own (``tests/test_kernels.py``):
atol = rtol = 1e-4 in float32 and 3e-2 in bfloat16 (r/k/v rounded to
bfloat16 the same way in both frameworks; all arithmetic is float32).  The
CUDA kernel against the plain version is in ``test_torch_wkv6_kernel.py``,
which imports no JAX and so runs on the card too.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6 import wkv6 as ref_wkv6
from repro.kernels.rwkv6 import wkv6_ref
from repro.models.rwkv6 import wkv_chunked

from repro_torch.kernels.rwkv6 import wkv6, wkv6_plain, wkv6_tiled_plain

WKV_SWEEP = [
    # (B, S, H, hd, chunk), as in tests/test_kernels.py
    (1, 64, 1, 16, 16),
    (2, 128, 2, 32, 32),
    (1, 256, 4, 64, 64),
    (2, 96, 2, 8, 32),
    (1, 128, 2, 64, 128),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def make_inputs(B, S, H, hd, seed=7, log_decay=-2.0):
    """float32 numpy inputs at the reference's scales
    (``tests/test_kernels.py``); ``log_decay`` centres log(-log w)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(r=f(B, S, H, hd) * 0.5, k=f(B, S, H, hd) * 0.5,
                v=f(B, S, H, hd) * 0.5,
                logw=-np.exp(f(B, S, H, hd) * 0.5 + log_decay),
                u=f(H, hd) * 0.3, s0=f(B, H, hd, hd) * 0.2)


def as_jax(x, dtype):
    return [jnp.asarray(x[n]).astype(dtype) for n in ("r", "k", "v")] + \
        [jnp.asarray(x[n]) for n in ("logw", "u", "s0")]


def as_torch(x, dtype):
    return [torch.from_numpy(x[n]).to(dtype) for n in ("r", "k", "v")] + \
        [torch.from_numpy(x[n]) for n in ("logw", "u", "s0")]


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.cpu(), np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@functools.lru_cache(maxsize=None)
def reference(B, S, H, hd, chunk, dt):
    """The reference's oracle and Pallas kernel on the case's inputs,
    computed once per case (interpret mode is the slow part)."""
    jdt = DTYPES[dt][0]
    x = as_jax(make_inputs(B, S, H, hd), jdt)
    return {"oracle": wkv6_ref(*x), "pallas": ref_wkv6(*x, chunk=chunk)}


@pytest.mark.parametrize("B,S,H,hd,chunk", WKV_SWEEP)
@pytest.mark.parametrize("dt", DTYPES)
def test_plain_recurrence_matches_reference(B, S, H, hd, chunk, dt):
    _, tdt, tol = DTYPES[dt]
    y, s = wkv6_plain(*as_torch(make_inputs(B, S, H, hd), tdt))
    assert y.dtype == s.dtype == torch.float32
    for y_ref, s_ref in reference(B, S, H, hd, chunk, dt).values():
        close(y, y_ref, tol)
        close(s, s_ref, tol)


@pytest.mark.parametrize("B,S,H,hd,chunk", WKV_SWEEP)
@pytest.mark.parametrize("dt", DTYPES)
def test_chunked_plain_matches_reference(B, S, H, hd, chunk, dt):
    _, tdt, tol = DTYPES[dt]
    # on CPU tensors the wrapper computes the plain chunked version
    y, s = wkv6(*as_torch(make_inputs(B, S, H, hd), tdt), chunk=chunk)
    assert y.shape == (B, S, H, hd) and s.shape == (B, H, hd, hd)
    for y_ref, s_ref in reference(B, S, H, hd, chunk, dt).values():
        close(y, y_ref, tol)
        close(s, s_ref, tol)


def test_chunk_of_one_matches_reference():
    """chunk = 1 (what the model picks for an odd prompt length) against
    the reference's chunked path at chunk 1."""
    x = make_inputs(1, 7, 2, 16, seed=5)
    y, s = wkv6(*as_torch(x, torch.float32), chunk=1)
    y_ref, s_ref = wkv_chunked(*as_jax(x, jnp.float32), chunk=1)
    close(y, y_ref, 1e-5)
    close(s, s_ref, 1e-5)


@pytest.mark.parametrize("B,S,H,hd", [shape[:4] for shape in WKV_SWEEP]
                         + [(1, 511, 2, 16), (1, 130, 2, 32)])
def test_tiled_plain_matches_reference(B, S, H, hd):
    """The kernel's decomposition (64-token tiles that cross any chunk,
    ragged at S = 511 and 130) against the reference's oracle, in float32."""
    x = make_inputs(B, S, H, hd)
    y, s = wkv6_tiled_plain(*as_torch(x, torch.float32))
    y_ref, s_ref = wkv6_ref(*as_jax(x, jnp.float32))
    close(y, y_ref, 1e-4)
    close(s, s_ref, 1e-4)


def test_tiled_plain_strong_decay_matches_reference():
    """log w about -4.5 a token: the reference's chunked form overflows
    float32 in a 64-token chunk (k exp(-L)); the sub-tile-relative exponents
    stay finite and agree with the oracle."""
    x = make_inputs(1, 256, 2, 32, log_decay=1.5)
    assert float(np.mean(x["logw"])) < -4.0
    y, s = wkv6_tiled_plain(*as_torch(x, torch.float32))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    y_ref, s_ref = wkv6_ref(*as_jax(x, jnp.float32))
    close(y, y_ref, 1e-4)
    close(s, s_ref, 1e-4)
