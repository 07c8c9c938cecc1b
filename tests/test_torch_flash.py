"""The port's flash attention (K2's wrapper) against the reference's.

The same numpy-made q, k, v (standard normal, as ``tests/test_kernels.py``
draws them) go at every ``FLASH_SWEEP`` row, in float32 and bfloat16, to

* the port's ``flash_attention`` on the CPU, i.e. its plain version
  ``attention_plain``;
* the reference's Pallas kernel ``repro.kernels.flash.ops.flash_attention``
  in interpret mode, as ``tests/test_kernels.py`` runs it;
* the reference's oracle ``attention_ref``;

and, where the model calls them, to the reference's model attention:
``full_attention`` and ``chunked_attention`` at a small ``chunk`` (with K
and V repeated per query head, as ``models/transformer.py`` does).

Tolerances: the reference's own, atol = rtol = 2e-5 in float32 and 2e-2
in bfloat16.  In bfloat16 the reference's ``attention_ref`` and
``full_attention`` cast the probabilities to bfloat16 before the product
with v and ``chunked_attention`` casts the unnormalised ones, while the
Pallas kernel and the port keep them in float32; they agree at 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import attention_ref
from repro.kernels.flash.ops import flash_attention as ref_flash
from repro.models import common as C

from repro_torch.kernels.flash import attention_plain, flash_attention

# compiled once per shape (op-by-op dispatch costs more than the compile)
attention_ref = jax.jit(attention_ref, static_argnames="causal")
full_attention = jax.jit(C.full_attention, static_argnames="causal")
chunked_attention = jax.jit(C.chunked_attention,
                            static_argnames=("causal", "chunk"))

FLASH_SWEEP = [
    # (B, S, T, H, KV, hd, causal, block), as in tests/test_kernels.py
    (1, 64, 64, 2, 2, 32, True, 32),
    (2, 128, 128, 4, 2, 64, True, 64),
    (1, 200, 200, 4, 4, 64, True, 64),      # non-multiple of block
    (2, 128, 256, 8, 2, 128, False, 64),    # cross lengths, GQA 4:1
    (1, 96, 96, 8, 1, 64, True, 32),        # MQA
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def inputs(B, S, T, H, KV, hd, dt, seed=42):
    """numpy-made q, k, v, rounded to the working type once and handed to
    both packages as the same values."""
    jdt, tdt, _ = DTYPES[dt]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))]
    jax_in = [jnp.asarray(a, jdt) for a in arrays]
    torch_in = [torch.from_numpy(np.array(a, np.float32)).to(tdt)
                for a in jax_in]
    return jax_in, torch_in


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,blk", FLASH_SWEEP)
def test_port_matches_reference_kernel_and_oracle(B, S, T, H, KV, hd,
                                                  causal, blk, dt):
    (jq, jk, jv), (q, k, v) = inputs(B, S, T, H, KV, hd, dt)
    tol = DTYPES[dt][2]
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before        # CPU: no kernel ran
    assert got.dtype == q.dtype and got.shape == q.shape
    close(got, ref_flash(jq, jk, jv, causal=causal, block_q=blk,
                         block_k=blk), tol)
    close(got, attention_ref(jq, jk, jv, causal=causal), tol)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,blk",
                         [r for r in FLASH_SWEEP if r[1] == r[2]])
def test_port_matches_model_attention(B, S, T, H, KV, hd, causal, blk, dt):
    """Against the two functions the reference's transformer calls on a
    prefill (``full_attention`` up to ``attn_chunk`` tokens,
    ``chunked_attention`` beyond), at a chunk that leaves a ragged last
    block (S = 200 with chunk 64)."""
    (jq, jk, jv), (q, k, v) = inputs(B, S, T, H, KV, hd, dt, seed=3)
    tol = DTYPES[dt][2]
    g = H // KV
    jk, jv = jnp.repeat(jk, g, axis=2), jnp.repeat(jv, g, axis=2)
    got = flash_attention(q, k, v, causal=causal)
    close(got, full_attention(jq, jk, jv, causal=causal), tol)
    close(got, chunked_attention(jq, jk, jv, causal=causal, chunk=blk), tol)


def test_plain_is_the_wrapper_on_cpu():
    _, (q, k, v) = inputs(1, 40, 40, 4, 2, 32, "float32")
    assert torch.equal(flash_attention(q, k, v),
                       attention_plain(q, k, v, causal=True))
