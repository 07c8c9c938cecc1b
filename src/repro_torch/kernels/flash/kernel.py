"""Wrapper of the hand-written Hopper flash-attention forward kernel (K2).

``flash_attention`` is the port's counterpart of
``repro.kernels.flash.ops.flash_attention`` (the GQA wrapper around the
Pallas TPU kernel ``kernel.py::flash_attention_fwd``).  For tensors on the
CPU it computes the plain version
(:func:`~repro_torch.kernels.flash.ref.attention_plain`); for CUDA tensors
it launches ``csrc/flash.cu`` or raises — it never falls back.  bfloat16
inputs take the tensor-core kernel (``flash_fwd_mma_kernel``), float32
inputs the exact float32 kernel on the CUDA cores.  The kernels read the
model layout (B, S, H, hd) / (B, T, KV, hd) in place: K and V are not
repeated per query head and nothing is padded on the host.  They are built
at first use (``kernels/_build.py``) and launched on PyTorch's current
stream without synchronising.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .._build import load_library
from .ref import attention_plain

LIB_NAME = "repro_torch_flash"
SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash.cu",)
#: head sizes the kernel takes (a template parameter of the kernel)
HEAD_DIMS = (16, 32, 64, 128)

_ENTRY = {torch.float32: "flash_fwd_f32", torch.bfloat16: "flash_fwd_bf16"}


def _library() -> ctypes.CDLL:
    lib = load_library(LIB_NAME, SOURCES)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.flash_fwd_bf16_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.flash_fwd_bf16_blocks_per_sm.restype = ctypes.c_int
    return lib


def blocks_per_sm(hd: int) -> int:
    """Blocks of the bfloat16 kernel resident on one SM at head size ``hd``
    (CUDA's occupancy calculator, at the kernel's registers and shared
    memory)."""
    n = _library().flash_fwd_bf16_blocks_per_sm(hd)
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the bfloat16 kernel
    copies 16 bytes at a time with cp.async); a view at another offset is
    copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q, k, v, *, causal: bool = True):
    """softmax(q k^T / sqrt(hd), mask) v in model layout.

    q: (B, S, H, hd); k, v: (B, T, KV, hd) with H a multiple of KV, all of
    one type (float32 or bfloat16 on the card).  The causal mask keeps
    ``kpos <= qpos`` counted from 0.  Returns (B, S, H, hd) in q's type.
    Every kernel launch adds one to ``flash_attention.launches``.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, S, H, hd) q and "
                         "(B, T, KV, hd) k and v")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, KV, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} "
                         "kv heads")
    dev, dtype = q.device, q.dtype
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                             f"{dtype} on {dev}")
    if dev.type == "cpu":
        return attention_plain(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {dev}")
    if dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes float32 or bfloat16, "
                        f"not {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd} not taken by the kernel "
                         f"(one of {HEAD_DIMS})")
    if min(B, S, T) < 1:
        raise ValueError(f"empty attention: B {B}, S {S}, T {T}")
    q, k, v = (aligned16(t) for t in (q, k, v))
    out = torch.empty_like(q)
    fn = getattr(_library(), _ENTRY[dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, T, H, KV, hd, int(bool(causal)),
                 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
