"""Wrapper of the hand-written Hopper WKV6 scan kernel (K3).

``wkv6`` is the port's counterpart of ``repro.kernels.rwkv6.ops.wkv6``
(model layout around the Pallas TPU kernel ``kernel.py::wkv6_fwd``).  For
tensors on the CPU it computes the plain chunked version
(:func:`~repro_torch.kernels.rwkv6.ref.wkv6_chunked_plain`); for CUDA
tensors it launches ``csrc/wkv6.cu`` or raises — it never falls back.  The
kernel's two passes (the state entering each 64-token tile, then every
tile's outputs; :func:`~repro_torch.kernels.rwkv6.ref.wkv6_tiled_plain` is
the same decomposition in plain PyTorch) read the model layout (B, S, H,
hd) in place, so nothing is transposed; the library is built at first use
(``kernels/_build.py``) and both passes are launched on PyTorch's current
stream without synchronising.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import load_library
from ..flash.kernel import aligned16
from .ref import wkv6_chunked_plain

LIB_NAME = "repro_torch_wkv6"
SOURCES = (Path(__file__).resolve().parent / "csrc" / "wkv6.cu",)
#: head sizes taken: the kernel reads 4-vectors of heads of at most 64, and
#: the wrapper zero-pads heads of 1 and 2 to 4
HEAD_DIMS = (1, 2, 4, 8, 16, 32, 64)
#: tokens per tile of the kernel (its scratch holds one state per tile)
TILE = 64

_ENTRY = {torch.float32: "wkv6_f32", torch.bfloat16: "wkv6_bf16"}


def _library() -> ctypes.CDLL:
    lib = load_library(LIB_NAME, SOURCES)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.wkv6_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.wkv6_blocks_per_sm.restype = ctypes.c_int
    return lib


def blocks_per_sm(pass_: int, dtype=torch.bfloat16) -> int:
    """Blocks of pass 1 (the states) or 2 (the outputs) of the ``dtype``
    entry resident on one SM (CUDA's occupancy calculator)."""
    n = _library().wkv6_blocks_per_sm(pass_, int(dtype == torch.bfloat16))
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


def wkv6(r, k, v, logw, u, s0, *, chunk: int = 128):
    """The chunked WKV6 scan in model layout.

    r/k/v/logw: (B, S, H, hd), r/k/v in float32 or bfloat16; u: (H, hd);
    s0: (B, H, hd, hd).  logw, u and s0 are taken in float32.  Returns
    (y (B, S, H, hd) float32, S_final (B, H, hd, hd) float32) — a drop-in
    for ``models.rwkv6.wkv_chunked``.  ``S`` must be a multiple of
    ``chunk``, as the reference requires; the kernel takes its own 64-token
    tiles whatever the chunk (the chunked form is exact for any tiling).
    Each call adds one to ``wkv6.launches``: it counts scans, not the two
    CUDA launches a scan makes.
    """
    B, S, H, hd = r.shape
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of "
                         f"chunk {chunk}")
    dev = r.device
    if dev.type == "cpu":
        return wkv6_chunked_plain(r, k, v, logw, u, s0, chunk)
    if dev.type != "cuda":
        raise ValueError(f"wkv6 runs on cpu or cuda, not {dev}")
    dtype = r.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"wkv6 takes float32 or bfloat16 r/k/v, not {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd} not taken by the kernel "
                         f"(one of {HEAD_DIMS})")
    logw, u, s0 = (t.to(dtype=torch.float32) for t in (logw, u, s0))
    shapes = {"k": (k, dtype, (B, S, H, hd)), "v": (v, dtype, (B, S, H, hd)),
              "logw": (logw, torch.float32, (B, S, H, hd)),
              "u": (u, torch.float32, (H, hd)),
              "s0": (s0, torch.float32, (B, H, hd, hd))}
    for name, (t, want_dtype, shape) in shapes.items():
        if t.device != dev or t.dtype != want_dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                             f"{want_dtype} on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if hd < 4:      # zeros add nothing: k, v, r = 0 and log w = 0
        pad = 4 - hd
        r, k, v, logw, u = (torch.nn.functional.pad(t, (0, pad))
                            for t in (r, k, v, logw, u))
        s0 = torch.nn.functional.pad(s0, (0, pad, 0, pad))
        y, s_out = wkv6(r, k, v, logw, u, s0, chunk=chunk)
        return y[..., :hd].contiguous(), s_out[..., :hd, :hd].contiguous()
    # the kernel reads 4-vectors
    r, k, v, logw, u, s0 = (aligned16(t) for t in (r, k, v, logw, u, s0))
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
    s_out = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    scratch = torch.empty((B * H, -(-S // TILE), hd, hd),
                          dtype=torch.float32, device=dev)
    fn = getattr(_library(), _ENTRY[dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
                 scratch.data_ptr(), B, S, H, hd, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv6.launches += 1
    return y, s_out


wkv6.launches = 0
