"""K2' (the flash-attention backward) and its autograd route, held to the
port's plain versions.

This file imports no JAX, so it runs on the card as well as here:

    python -m pytest -q -m cuda tests/test_torch_flash_bwd_kernel.py  # GPU

On the CPU, ``flash_attention_bwd`` computes ``flash_bwd_plain`` and
launches nothing, and ``flash_attention`` with grad is autograd through
``attention_plain``.  On the card (cases marked ``cuda``, which skip
without a GPU): a CUDA call that needs a gradient goes through
``FlashAttention`` (K2 with its log-sum-exp; K2' in the backward, counted)
and gives q, k and v their gradients; K2' is held to ``flash_bwd_plain``
(float32 on the same inputs) within atol = rtol = 1e-4 for float32 inputs
and 3e-2 for bfloat16, at the ``FLASH_SWEEP`` shapes, a ragged shape at hd
16, qwen3-0.6b's training layer, a ragged shape without the causal mask
and whisper-small's cross-attention and encoder layers; with a sliding window (1, 7, 64, 100
and one longer than S) at the causal ones, K2's log-sum-exp over the kept
keys within 2e-5 and free of NaN; and at head size 8 (zero-padded to 16 by
the wrapper) through the autograd route.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash import (FlashAttention, attention_lse_plain,
                                       attention_plain, flash_attention,
                                       flash_attention_bwd, flash_bwd_plain)
from repro_torch.kernels.flash import kernel as flash_kernel

SHAPES = [
    # (B, S, T, H, KV, hd, causal)
    (1, 64, 64, 2, 2, 32, True),
    (2, 128, 128, 4, 2, 64, True),
    (1, 200, 200, 4, 4, 64, True),
    (2, 128, 256, 8, 2, 128, False),
    (1, 96, 96, 8, 1, 64, True),
    (2, 77, 77, 4, 1, 16, True),
    (4, 512, 512, 16, 8, 128, True),        # qwen3-0.6b's training layer
    (2, 77, 131, 4, 2, 16, False),          # ragged, no causal mask
    (1, 64, 1500, 12, 12, 64, False),       # whisper-small's cross layer
    (1, 1500, 1500, 12, 12, 64, False),     # and its encoder layer
]
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
WINDOWS = (1, 7, 64, 100, 4096)


def inputs(B, S, T, H, KV, hd, dtype=torch.float32, device="cpu", seed=42):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device=device, dtype=dtype)
            for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd),
                      (B, S, H, hd))]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: its many small CPU ops
    gain nothing from a thread pool, and parallel test workers each
    spinning a full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("no GPU visible: the CUDA kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES[:3] + SHAPES[5:6], ids=str)
def test_cpu_route_is_the_plain_version_and_launches_nothing(shape):
    q, k, v, do = inputs(*shape[:6])
    causal = shape[6]
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out = attention_plain(q, k, v, causal=causal)
    lse = attention_lse_plain(q, k, causal=causal)
    got = flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    want = flash_bwd_plain(q, k, v, out, do, lse, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(FlashAttention.apply(*leaves, causal),
                               leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(auto, want))
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


@pytest.mark.parametrize("window", [1, 7, 100])
def test_cpu_windowed_route_is_the_plain_version(window):
    q, k, v, do = inputs(2, 77, 77, 4, 1, 16)
    out = attention_plain(q, k, v, causal=True, window=window)
    lse = attention_lse_plain(q, k, causal=True, window=window)
    want = flash_bwd_plain(q, k, v, out, do, lse, causal=True, window=window)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(FlashAttention.apply(*leaves, True, window),
                               leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(auto, want))
    assert all(torch.equal(a, b) for a, b in zip(
        flash_attention_bwd(q, k, v, out, do, lse, window=window), want))


def test_bwd_rejects_mismatched_shapes():
    q, k, v, do = inputs(1, 8, 8, 2, 1, 16)
    lse = attention_lse_plain(q, k)
    with pytest.raises(ValueError, match="does not match q"):
        flash_attention_bwd(q, k, v, q[:, :4], do, lse)
    with pytest.raises(ValueError, match="lse has shape"):
        flash_attention_bwd(q, k, v, q, do, lse[:, :1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_matches_plain_backward(shape, dtype, gpu):
    q, k, v, do = inputs(*shape[:6], dtype=dtype, device=gpu)
    causal = shape[6]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out, lse = flash_kernel._forward(q, k, v, causal, True)
        n = flash_attention_bwd.launches
        got = flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
        torch.cuda.synchronize()
        assert flash_attention_bwd.launches == n + 1
        want = flash_bwd_plain(*(t.float() for t in (q, k, v, out, do)),
                               lse, causal=causal)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    tol = TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert torch.allclose(g.float(), w, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[6]], ids=str)
def test_windowed_kernel_matches_plain_backward(shape, dtype, window, gpu):
    q, k, v, do = inputs(*shape[:6], dtype=dtype, device=gpu)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out, lse = flash_kernel._forward(q, k, v, True, True, window)
        want_lse = attention_lse_plain(q, k, causal=True, window=window)
        assert torch.isfinite(lse).all()
        torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)
        got = flash_attention_bwd(q, k, v, out, do, lse, causal=True,
                                  window=window)
        want = flash_bwd_plain(*(t.float() for t in (q, k, v, out, do)),
                               lse, causal=True, window=window)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    tol = TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert torch.allclose(g.float(), w, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 7])
def test_padded_head_size_through_autograd(window, gpu):
    """Head size 8 (command-r-35b's reduced config): the forward and the
    backward kernels run at 16 with zero columns, the gradients are sliced
    back; float32, against autograd through the plain version."""
    q, k, v, do = inputs(2, 100, 100, 8, 2, 8, device=gpu)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n = flash_attention_bwd.launches
    got = torch.autograd.grad(
        flash_attention(*leaves, causal=True, window=window), leaves, do)
    assert flash_attention_bwd.launches == n + 1
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        attention_plain(*ref, causal=True, window=window), ref, do)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.allclose(g, w, atol=TOL[torch.float32],
                              rtol=TOL[torch.float32])


@pytest.mark.cuda
def test_cuda_autograd_goes_through_both_kernels(gpu):
    q, k, v, do = inputs(2, 96, 96, 4, 2, 64, dtype=torch.bfloat16,
                         device=gpu)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n_fwd, n_bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*leaves, causal=True)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, do)
    assert flash_attention.launches == n_fwd + 1
    assert flash_attention_bwd.launches == n_bwd + 1
    assert all(g is not None and g.abs().sum() > 0 for g in grads)
