"""K2's wrapper and CUDA kernel, held against the port's plain version.

This file imports no JAX, so it runs on the card as well as here:

    python -m pytest -q -m cuda tests/test_torch_flash_kernel.py   # on a GPU

On the CPU the wrapper must compute the plain version and launch nothing,
and the plain version must be the dense softmax attention it documents
(checked against a float64 numpy loop over the query rows).  On a CUDA
tensor the wrapper launches the kernel (counted) or raises.  The kernel is
held within the reference's tolerances (atol = rtol = 2e-5 in float32,
2e-2 in bfloat16) of the plain version on the card, at the reference's
``FLASH_SWEEP`` shapes, the served layer shape of ``qwen3-0.6b`` and a
2048-token causal prompt, and at the edges of the tensor-core kernel's
tiles (a ragged length at hd 16, a non-causal cross shape with T not a
multiple of 64, MQA over three query tiles), at Whisper's encoder and
cross-attention shapes (1500 keys, no causal mask), a ragged shape
without the mask and Jamba's attention layer; with a sliding window (1, 7,
64, 100 and one longer than S) at the causal shapes, where a row's first
key tile can lie wholly outside its window (no NaN may appear); and at head
sizes the kernel is not built for (8 and 48, zero-padded by the wrapper);
those cases skip without a GPU.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.flash import attention_plain, flash_attention
from repro_torch.kernels.flash import kernel as flash_kernel
from repro_torch.models import transformer

FLASH_SWEEP = [
    # (B, S, T, H, KV, hd, causal), as in tests/test_kernels.py
    (1, 64, 64, 2, 2, 32, True),
    (2, 128, 128, 4, 2, 64, True),
    (1, 200, 200, 4, 4, 64, True),          # non-multiple of the tile
    (2, 128, 256, 8, 2, 128, False),        # cross lengths, GQA 4:1
    (1, 96, 96, 8, 1, 64, True),            # MQA
]
MODEL_SHAPES = [
    (1, 512, 512, 16, 8, 128, True),        # qwen3-0.6b, a served prefill
    (1, 2048, 2048, 16, 8, 128, True),      # the reference's chunked branch
]
#: the edges of the bfloat16 tensor-core kernel's 64 x 64 tiles
MMA_EDGES = [
    (2, 77, 77, 4, 1, 16, True),            # ragged S and T, hd 16
    (1, 50, 100, 4, 2, 64, False),          # cross, T not a multiple of 64
    (2, 130, 130, 8, 1, 128, True),         # MQA over three query tiles
]
#: the hybrid and audio layers: Whisper's encoder (1500 frames, no causal
#: mask) and cross-attention (a 64-token prompt against 1500 frames), a
#: small ragged shape without the mask, and Jamba's attention layer
HYBRID_AUDIO = [
    (1, 1500, 1500, 12, 12, 64, False),
    (1, 64, 1500, 12, 12, 64, False),
    (2, 77, 131, 4, 2, 16, False),
    (1, 512, 512, 64, 8, 128, True),
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
WINDOWS = (1, 7, 64, 100, 4096)
#: the causal shapes above: the window is taken with the causal mask only
WINDOW_SHAPES = [s for s in FLASH_SWEEP + MODEL_SHAPES + MMA_EDGES if s[6]]


def inputs(B, S, T, H, KV, hd, dtype=torch.float32, device="cpu", seed=42):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device=device, dtype=dtype)
            for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))]


def numpy_attention(q, k, v, causal):
    """Row by row in float64: softmax over the allowed keys, then v."""
    q, k, v = (t.double().numpy() for t in (q, k, v))
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = np.zeros(q.shape)
    for b in range(B):
        for h in range(H):
            kh, vh = k[b, :, h // (H // KV)], v[b, :, h // (H // KV)]
            for s in range(S):
                n = min(s + 1, T) if causal else T
                sc = kh[:n] @ q[b, s, h] / math.sqrt(hd)
                p = np.exp(sc - sc.max())
                out[b, s, h] = p @ vh[:n] / p.sum()
    return out


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("no GPU visible: the CUDA kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("B,S,T,H,KV,hd,causal",
                         [(1, 9, 9, 4, 2, 8, True),
                          (2, 5, 12, 2, 1, 4, True),
                          (1, 12, 5, 3, 3, 4, True),
                          (1, 7, 11, 4, 4, 8, False)])
def test_plain_is_softmax_attention(B, S, T, H, KV, hd, causal):
    """Start-aligned causal mask (S < T and S > T too), GQA by head
    index, float32 arithmetic."""
    q, k, v = inputs(B, S, T, H, KV, hd, seed=1)
    got = attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(got.double().numpy(),
                               numpy_attention(q, k, v, causal),
                               atol=1e-6, rtol=1e-5)


def test_wrapper_takes_plain_version_on_cpu_and_validates():
    q, k, v = inputs(1, 40, 40, 4, 2, 32)
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v, causal=False),
                       attention_plain(q, k, v, causal=False))
    assert flash_attention.launches == before         # no kernel ran
    out = flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    with pytest.raises(ValueError, match="not a multiple"):
        flash_attention(*inputs(1, 8, 8, 3, 2, 16))
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, k[..., :16], v)
    with pytest.raises(ValueError, match="expected torch.float32"):
        flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match=r"\(B, S, H, hd\)"):
        flash_attention(q[0], k, v)


def test_prefill_attention_goes_through_the_wrapper(monkeypatch):
    """Every layer of a prefill calls ``flash_attention`` once (on the CPU
    it takes the plain version); a decode step does not."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    calls = []

    def spy(q, k, v, *, causal, window=0):
        calls.append((tuple(q.shape), tuple(k.shape), causal, window))
        return flash_attention(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(transformer, "flash_attention", spy)
    _, cache = transformer.prefill(model, torch.arange(20)[None], 32)
    transformer.decode_step(model, cache, torch.tensor([[3]]), 20)
    assert calls == [((1, 20, 4, 16), (1, 20, 2, 16), True, 0)] * \
        cfg.num_layers


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal",
                         FLASH_SWEEP + MODEL_SHAPES + MMA_EDGES
                         + HYBRID_AUDIO)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kernel_matches_plain_on_gpu(gpu, B, S, T, H, KV, hd, causal, dtype):
    q, k, v = inputs(B, S, T, H, KV, hd, dtype, gpu)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
def test_tensor_core_kernel_takes_a_misaligned_view(gpu):
    """A q that starts 2 bytes into its storage is copied to an aligned
    address before the 16-byte cp.async loads."""
    q, k, v = inputs(1, 64, 64, 2, 2, 32, torch.bfloat16, gpu)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=gpu)
    view = flat[1:].view(q.shape)
    view.copy_(q)
    assert view.data_ptr() % 16 != 0
    torch.testing.assert_close(flash_attention(view, k, v),
                               flash_attention(q, k, v), atol=0, rtol=0)


@pytest.mark.cuda
def test_tensor_core_kernel_uses_hmma_and_two_blocks_per_sm(gpu):
    """Every head size of the bfloat16 kernel compiles to tensor-core
    instructions, and at hd 128 two blocks fit on one SM."""
    counts = _build.tensor_core_ops(
        _build.sass(flash_kernel.LIB_NAME, flash_kernel.SOURCES),
        "flash_fwd_mma_kernel")
    assert len(counts) == len(flash_kernel.HEAD_DIMS)
    assert all(n > 0 for n in counts.values()), counts
    assert flash_kernel.blocks_per_sm(128) >= 2


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(gpu):
    """A head size above the largest built one (smaller ones are
    zero-padded), another type, a mix of devices."""
    q, k, v = inputs(1, 32, 32, 2, 2, 160, device=gpu)
    with pytest.raises(ValueError, match="head size 160"):
        flash_attention(q, k, v)
    q, k, v = inputs(1, 32, 32, 2, 2, 32, torch.float16, gpu)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q, k, v)
    q, k, v = inputs(1, 32, 32, 2, 2, 32, device=gpu)
    with pytest.raises(ValueError, match="expected torch.float32 on cuda"):
        flash_attention(q, k.cpu(), v)


@pytest.mark.cuda
def test_model_prefill_on_gpu_matches_cpu(gpu):
    """The reduced model's prefill on the card (through K2) against the
    same weights on the CPU (plain), in float32 with TF32 off."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    cfg = type(cfg)(**{**cfg.__dict__, "compute_dtype": torch.float32})
    cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    dev = transformer.Transformer(cfg, gpu)
    dev.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = flash_attention.launches
        got, g_cache = transformer.prefill(dev, tokens.to(gpu), 48)
        assert flash_attention.launches == before + cfg.num_layers
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    want, w_cache = transformer.prefill(cpu, tokens, 48)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        torch.testing.assert_close(g_cache[name].cpu(), w_cache[name],
                                   atol=1e-4, rtol=1e-4)


def test_kernel_head_dim_pads_to_the_next_built_size():
    sizes = (1, 8, 16, 17, 48, 64, 100, 128)
    assert [flash_kernel.kernel_head_dim(hd) for hd in sizes] == \
        [16, 16, 16, 32, 64, 64, 128, 128]
    with pytest.raises(ValueError, match="head size 160"):
        flash_kernel.kernel_head_dim(160)
    q, k, v = inputs(1, 4, 4, 2, 2, 8)
    padded = flash_kernel._pad_hd((q, k, v), 16)
    assert all(t.shape[-1] == 16 and torch.equal(t[..., :8], u)
               and not t[..., 8:].any() for t, u in zip(padded, (q, k, v)))


@pytest.mark.cuda
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal", WINDOW_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_windowed_kernel_matches_plain_on_gpu(gpu, B, S, T, H, KV, hd,
                                              causal, dtype, window):
    q, k, v = inputs(B, S, T, H, KV, hd, dtype, gpu)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_plain(q, k, v, causal=True, window=window)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("hd", [8, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_padded_head_size_matches_plain_on_gpu(gpu, hd, dtype, window):
    """command-r-35b's reduced head size (8) and one between built sizes
    (48) go through the kernel zero-padded, at the true scale."""
    q, k, v = inputs(2, 100, 100, 8, 2, hd, dtype, gpu)
    out = flash_attention(q, k, v, causal=True, window=window)
    assert out.shape == q.shape and out.is_contiguous()
    want = attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_aligned16_copies_only_misaligned_views():
    t = torch.arange(40, dtype=torch.bfloat16)
    assert flash_kernel.aligned16(t) is t
    view = t[1:33]
    got = flash_kernel.aligned16(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    cols = t[:32].view(4, 8)[:, :4]            # not contiguous
    got = flash_kernel.aligned16(cols)
    assert got.is_contiguous() and torch.equal(got, cols)


def test_tensor_core_ops_counts_the_named_kernels():
    text = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi16EEEvPK13__nv_bfloat16
        /*0000*/                   LDC R1, c[0x0][0x28] ;       /* 0x00000a00ff017b82 */
        /*0100*/                   HMMA.16816.F32.BF16 R20, R4, R8, RZ ;   /* 0x0 */
        /*0110*/               @P0 HMMA.16816.F32.BF16 R24, R4, R10, R24 ;
        /*0120*/                   LDSM.16.M88.4 R8, [R2] ;
\t\tFunction : _ZN12_GLOBAL__N_120flash_fwd_f32_kernelILi16EEEvPKfS2_S2_Pfiiiiif
        /*0000*/                   HMMA.1688.F32 R0, R2, R4, R0 ;
\t\tFunction : _ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi32EEEvPK13__nv_bfloat16
        /*0000*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0010*/                   FFMA R1, R2, R3, R1 ;  // HMMA in a comment
"""
    assert _build.tensor_core_ops(text, "flash_fwd_mma_kernel") == {
        "_ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi16EEEvPK13__nv_bfloat16": 2,
        "_ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi32EEEvPK13__nv_bfloat16": 1,
    }
    assert _build.tensor_core_ops(text, "nothing_of_the_kind") == {}


def test_bound_counts_the_causal_pairs():
    """``chip_smoke.flash_bound_ms`` counts q, k, v read once and the
    output written once, and 4 hd operations per query-key pair the mask
    keeps: at the served shape in bfloat16 that leaves the bytes as the
    bound, in float32 (no tensor cores) the operations."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ms, by = smoke.flash_bound_ms(1, 512, 512, 16, 8, 128, True,
                                  torch.bfloat16)
    assert by == "bytes"
    assert ms == pytest.approx(6_291_456 / smoke.HBM_BYTES_PER_S * 1e3)
    ms, by = smoke.flash_bound_ms(1, 512, 512, 16, 8, 128, True,
                                  torch.float32)
    flops = 4 * 128 * (512 * 513 // 2) * 16
    assert flops == 1_075_838_976
    assert by == "operations"
    assert ms == pytest.approx(flops / smoke.PEAK_OPS[torch.float32] * 1e3)
    # start-aligned causal pairs with more queries than keys, and no mask
    ms_c, _ = smoke.flash_bound_ms(1, 600, 400, 8, 8, 128, True,
                                   torch.float32)
    ms_n, _ = smoke.flash_bound_ms(1, 600, 400, 8, 8, 128, False,
                                   torch.float32)
    pairs_c = sum(min(s + 1, 400) for s in range(600))
    assert ms_c / ms_n == pytest.approx(pairs_c / (600 * 400))


def test_bound_counts_the_pairs_inside_the_window():
    """Under a sliding window the bounds of K2 and K2' count only the pairs
    the window keeps: row s sees min(s + 1, window) keys."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.mask_pairs(512, 512, True, 128) == \
        128 * 129 // 2 + (512 - 128) * 128 == 57_408
    assert smoke.mask_pairs(512, 512, True, 4096) == \
        smoke.mask_pairs(512, 512, True) == 512 * 513 // 2
    assert smoke.mask_pairs(600, 400, True, 7) == \
        sum(max(0, min(s, 399) - max(0, s - 6) + 1) for s in range(600))
    # float32 operations bind at the served shape: the bound scales with
    # the pairs
    for bound in (smoke.flash_bound_ms, smoke.flash_bwd_bound_ms):
        full, _ = bound(1, 512, 512, 16, 8, 128, True, torch.float32)
        win, by = bound(1, 512, 512, 16, 8, 128, True, torch.float32,
                        window=128)
        assert by == "operations"
        assert win / full == pytest.approx(57_408 / (512 * 513 // 2))
