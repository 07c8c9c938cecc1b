"""K3' (the WKV6 scan's backward) and its autograd route, held to the
port's plain versions.

This file imports no JAX, so it runs on the card as well as here:

    python -m pytest -q -m cuda tests/test_torch_wkv6_bwd_kernel.py  # GPU

On the CPU, ``wkv6_bwd`` computes ``wkv6_bwd_plain`` and launches
nothing, and ``wkv6`` with grad is autograd through the chunked plain
version, which the walk equals.  On the card (cases marked ``cuda``, which
skip without a GPU): a CUDA call that needs a gradient goes through
``WKV6`` (K3 keeping its tile states; K3' in the backward, counted) and
gives r, k, v, log w, u and s0 their gradients, also at head sizes 1 and 2
(padded to 4); K3' is held to ``wkv6_bwd_plain`` within atol = rtol = 1e-4
for float32 r/k/v and 3e-2 for bfloat16, with a nonzero s0 and a gradient
on the final state, at the ``WKV_SWEEP`` shapes, tiles crossing chunks
with a ragged last tile, and rwkv6-1.6b's training layer.  On any
machine: ``chip_smoke.wkv6_bwd_bound_ms`` counts K3''s products at the
tensor cores' TF32 rate.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv6 import (WKV6, wkv6, wkv6_bwd,
                                       wkv6_bwd_plain)

SHAPES = [
    # (B, S, H, hd, chunk)
    (1, 64, 1, 16, 16),
    (2, 128, 2, 32, 32),
    (1, 256, 4, 64, 64),
    (2, 96, 2, 8, 32),
    (1, 130, 2, 64, 2),                     # tiles cross chunks, ragged
    (4, 512, 32, 64, 256),                  # rwkv6-1.6b's training layer
]
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
#: the CPU route's cases: small, and a ragged tile crossing chunks of 2
CPU_SHAPES = [(1, 64, 1, 16, 16), (2, 96, 2, 8, 32), (1, 70, 2, 16, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: its many small CPU ops
    gain nothing from a thread pool, and parallel test workers each
    spinning a full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(B, S, H, hd, dtype=torch.float32, device="cpu", seed=7):
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(device)
    r, k, v = (n(B, S, H, hd).mul_(0.5).to(dtype) for _ in range(3))
    logw = -torch.exp(n(B, S, H, hd) * 0.5 - 2.0)
    return ([r, k, v, logw, n(H, hd) * 0.3, n(B, H, hd, hd) * 0.2],
            n(B, S, H, hd) * 0.5, n(B, H, hd, hd) * 0.2)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("no GPU visible: the CUDA kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", CPU_SHAPES, ids=str)
def test_cpu_route_is_the_plain_walk_and_equals_autograd(shape):
    B, S, H, hd, chunk = shape
    args, dy, ds = inputs(B, S, H, hd)
    before = (wkv6.launches, wkv6_bwd.launches)
    got = wkv6_bwd(*args, dy, ds)
    want = wkv6_bwd_plain(*args, dy, ds)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    leaves = [t.clone().requires_grad_() for t in args]
    auto = torch.autograd.grad(wkv6(*leaves, chunk=chunk), leaves, (dy, ds))
    for a, b in zip(got, auto):
        assert torch.allclose(a, b, atol=1e-4, rtol=1e-4)
    assert (wkv6.launches, wkv6_bwd.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_matches_plain_walk(shape, dtype, gpu):
    B, S, H, hd, chunk = shape
    args, dy, ds = inputs(B, S, H, hd, dtype=dtype, device=gpu)
    n = wkv6_bwd.launches
    got = wkv6_bwd(*args, dy, ds)
    torch.cuda.synchronize()
    assert wkv6_bwd.launches == n + 1
    want = wkv6_bwd_plain(*args, dy, ds)
    tol = TOL[dtype]
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.allclose(g.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [1, 2, 64])
def test_cuda_autograd_goes_through_both_kernels(hd, gpu):
    args, dy, ds = inputs(2, 96, 2, hd, device=gpu)
    leaves = [t.clone().requires_grad_() for t in args]
    n_fwd, n_bwd = wkv6.launches, wkv6_bwd.launches
    y, s = wkv6(*leaves, chunk=32)
    assert y.grad_fn is not None
    grads = torch.autograd.grad((y, s), leaves, (dy, ds))
    assert (wkv6.launches, wkv6_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    want = wkv6_bwd_plain(*args, dy, ds)
    for g, w in zip(grads, want):
        assert torch.allclose(g, w, atol=1e-4, rtol=1e-4)
    assert WKV6 is not None


@pytest.mark.cuda
def test_kernel_rejects_states_of_another_shape(gpu):
    args, dy, ds = inputs(1, 128, 2, 16, device=gpu)
    states = torch.zeros((2, 1, 16, 16), device=gpu)   # one tile, not two
    with pytest.raises(ValueError, match="states"):
        wkv6_bwd(*args, dy, ds, states=states)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bound_counts_tensor_core_products(dtype):
    """``chip_smoke.wkv6_bwd_bound_ms`` counts K3''s products at the TF32
    tensor-core rate (three TF32 products each for float32), so at
    rwkv6-1.6b's training layer the bytes moved are the bound (for
    bfloat16 r/k/v, below the per-token walk's time on the CUDA cores)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    B, S, H, hd = 4, 512, 32, 64
    es = torch.tensor([], dtype=dtype).element_size()
    elems = B * S * H * hd
    moved = (elems * (6 * es + 12) + 2 * H * hd * 4
             + 3 * B * H * hd * hd * 4)
    ms, by = smoke.wkv6_bwd_bound_ms(B, S, H, hd, dtype)
    assert by == "bytes"
    assert ms == pytest.approx(moved / smoke.HBM_BYTES_PER_S * 1e3)
    ops = 10 * hd * hd * B * S * H
    assert ops * 3 / smoke.PEAK_TF32 * 1e3 < ms
    if dtype == torch.bfloat16:
        assert ms < ops / smoke.PEAK_OPS[torch.float32] * 1e3
