"""K3's wrapper and CUDA kernel, held against the port's plain versions.

This file imports no JAX, so it runs on the card as well as here:

    python -m pytest -q -m cuda tests/test_torch_wkv6_kernel.py   # on a GPU

On the CPU the wrapper must compute the plain chunked version and launch
nothing; on a CUDA tensor it launches the kernel (counted) or raises.  The
kernel is held within the reference's tolerances (atol = rtol = 1e-4 in
float32, 3e-2 in bfloat16) of the plain chunked version on the card, at the
reference's ``WKV_SWEEP`` shapes and at chunks the model's selection loop
produces for other prompt lengths (31, 1), at lengths whose 64-token tiles
cross chunks and end ragged (511, 130, 124, 9), and under a decay strong
enough to overflow the chunked form; those cases skip without a GPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.rwkv6 import (wkv6, wkv6_chunked_plain, wkv6_plain,
                                       wkv6_tiled_plain)
from repro_torch.models import rwkv6

WKV_SWEEP = [
    # (B, S, H, hd, chunk), as in tests/test_kernels.py
    (1, 64, 1, 16, 16),
    (2, 128, 2, 32, 32),
    (1, 256, 4, 64, 64),
    (2, 96, 2, 8, 32),
    (1, 128, 2, 64, 128),
]
ODD_CHUNKS = [(1, 62, 2, 64, 31), (1, 9, 2, 64, 1)]
#: the kernel's 64-token tiles across chunks of 1, 2 and 31, with a ragged
#: last tile, and a head of 2 (zero-padded to 4 by the wrapper)
CROSSING = [(1, 511, 2, 64, 1), (1, 130, 2, 64, 1), (1, 130, 2, 64, 2),
            (1, 9, 2, 64, 1), (1, 124, 2, 64, 31), (2, 70, 2, 2, 7)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def inputs(B, S, H, hd, dtype=torch.float32, device="cpu", seed=7,
           log_decay=-2.0):
    """numpy-made inputs at the reference's scales; ``log_decay`` centres
    log(-log w)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    r, k, v = (f(B, S, H, hd) * 0.5 for _ in range(3))
    logw = -torch.exp(f(B, S, H, hd) * 0.5 + log_decay)
    u, s0 = f(H, hd) * 0.3, f(B, H, hd, hd) * 0.2
    return [t.to(device=device, dtype=dtype) for t in (r, k, v)] + \
        [t.to(device) for t in (logw, u, s0)]


def close(got, want, tol):
    torch.testing.assert_close(got.cpu(), want.cpu(), atol=tol, rtol=tol)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("no GPU visible: the CUDA kernel runs only on the card")
    return torch.device("cuda")


def test_wrapper_takes_plain_version_on_cpu_and_validates():
    x = inputs(1, 64, 1, 16)
    before = wkv6.launches
    y, s = wkv6(*x, chunk=16)
    y_p, s_p = wkv6_chunked_plain(*x, 16)
    assert torch.equal(y, y_p) and torch.equal(s, s_p)
    assert wkv6.launches == before                # no kernel ran
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        wkv6(*x, chunk=48)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        wkv6_chunked_plain(*x, 0)


@pytest.mark.parametrize("chunk", [1, 16, 32, 64])
def test_chunked_plain_is_the_recurrence_at_any_chunk(chunk):
    x = inputs(2, 64, 2, 16, seed=5)
    y_rec, s_rec = wkv6_plain(*x)
    y, s = wkv6(*x, chunk=chunk)
    close(y, y_rec, 1e-4)
    close(s, s_rec, 1e-4)


def test_state_threading():
    """Two halves with the state carried between them == the whole."""
    r, k, v, lw, u, s0 = x = inputs(2, 128, 2, 32, seed=3)
    y_full, s_full = wkv6(*x, chunk=32)
    y1, s1 = wkv6(r[:, :64], k[:, :64], v[:, :64], lw[:, :64], u, s0,
                  chunk=32)
    y2, s2 = wkv6(r[:, 64:], k[:, 64:], v[:, 64:], lw[:, 64:], u, s1,
                  chunk=32)
    close(torch.cat([y1, y2], 1), y_full, 1e-4)
    close(s2, s_full, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,chunk", WKV_SWEEP + ODD_CHUNKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kernel_matches_plain_on_gpu(gpu, B, S, H, hd, chunk, dtype):
    x = inputs(B, S, H, hd, dtype, gpu)
    before = wkv6.launches
    y, s = wkv6(*x, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    assert y.dtype == s.dtype == torch.float32
    y_p, s_p = wkv6_chunked_plain(*x, chunk)
    close(y, y_p, TOL[dtype])
    close(s, s_p, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,chunk", CROSSING)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kernel_tiles_cross_chunks_on_gpu(gpu, B, S, H, hd, chunk, dtype):
    x = inputs(B, S, H, hd, dtype, gpu)
    y, s = wkv6(*x, chunk=chunk)
    torch.cuda.synchronize()
    for y_p, s_p in (wkv6_chunked_plain(*x, chunk), wkv6_tiled_plain(*x)):
        close(y, y_p, TOL[dtype])
        close(s, s_p, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kernel_survives_strong_decay_on_gpu(gpu, dtype):
    """log w about -4.5 a token: k exp(-L) of the chunked form overflows
    float32 within a 64-token chunk; the kernel's exponents never exceed 0,
    so it stays finite and agrees with the per-token recurrence."""
    x = inputs(1, 256, 2, 64, dtype, gpu, log_decay=1.5)
    y_c, _ = wkv6_chunked_plain(*x, 64)
    assert not torch.isfinite(y_c).all()
    y, s = wkv6(*x, chunk=64)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    y_p, s_p = wkv6_plain(*x)
    close(y, y_p, TOL[dtype])
    close(s, s_p, TOL[dtype])


@pytest.mark.cuda
def test_launches_count_scans_not_cuda_launches(gpu):
    """Each call runs two passes on the card but counts one scan."""
    x = inputs(1, 200, 2, 64, torch.bfloat16, gpu)
    before = wkv6.launches
    for chunk in (1, 8, 200):
        wkv6(*x, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 3


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(gpu):
    x = inputs(1, 32, 1, 48, device=gpu)
    with pytest.raises(ValueError, match="head size 48"):
        wkv6(*x, chunk=32)
    x = inputs(1, 32, 1, 16, torch.float16, gpu)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wkv6(*x, chunk=32)
    x = inputs(1, 32, 1, 16, device=gpu)
    x[5] = x[5].cpu()
    with pytest.raises(ValueError, match="s0"):
        wkv6(*x, chunk=32)


@pytest.mark.cuda
def test_model_prefill_on_gpu_matches_cpu(gpu):
    """The reduced model's prefill on the card (through K3) against the
    same weights on the CPU (plain), in float32 with TF32 off."""
    cfg = get_config("rwkv6-1.6b", reduced=True)
    cfg = type(cfg)(**{**cfg.__dict__, "compute_dtype": torch.float32})
    cpu = rwkv6.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = rwkv6.RWKV6(cfg, gpu)
    dev.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = wkv6.launches
        got, g_state = rwkv6.prefill(dev, tokens.to(gpu))
        assert wkv6.launches == before + cfg.num_layers
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    want, w_state = rwkv6.prefill(cpu, tokens)
    close(got, want, 1e-4)
    close(g_state["wkv"], w_state["wkv"], 1e-4)


def test_bound_counts_the_cheapest_exact_form():
    """``chip_smoke.wkv6_bound_ms`` takes the least operations over the
    exact forms of the scan, not the kernel's own 64-token tiling: at the
    served layer shape that leaves the bytes as the bound."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    B, S, H, hd = 1, 512, 32, 64
    moved = B * S * H * hd * (3 * 2 + 4 + 4) + H * hd * 4 \
        + 2 * B * H * hd * hd * 4
    ms, by = smoke.wkv6_bound_ms(B, S, H, hd, torch.bfloat16)
    assert by == "bytes"
    assert ms == pytest.approx(moved / smoke.HBM_BYTES_PER_S * 1e3)
    # wide heads are operation-bound: no dearer than the recurrence or
    # 64-token tiles, and no cheaper than 4 hd^2 per token (q S and the
    # state update are needed at any tile length)
    hd = 256
    ms, by = smoke.wkv6_bound_ms(1, S, 4, hd, torch.float32)
    peak = smoke.PEAK_OPS[torch.float32] / 1e3
    tiles64 = (S // 64) * (4 * 64 * hd * hd + 2 * 64 * 63 * hd
                           + 8 * 64 * hd + hd * hd)
    assert by == "operations"
    assert 4 * S * hd * hd * 4 / peak < ms
    assert ms <= min(S * (5 * hd * hd + 6 * hd), tiles64) * 4 / peak
