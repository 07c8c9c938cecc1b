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
repeated per query head.  A head size the kernels are not built for (one of
``HEAD_DIMS``) is zero-padded on the host to the next one, the kernels
given the true scale 1/sqrt(hd), and the outputs sliced back (zero columns
add nothing to q k^T, and give zero output and gradient columns); a head
size above 128 raises.  ``window`` > 0 is the reference's sliding window
(keys ``kpos > qpos - window`` kept, beside the causal mask), taken by both
kernels and both plain versions.  ``_forward`` and
:func:`flash_attention_bwd` take ``k_offset``, the position of key 0 (k
and v one block of the keys' sequence: ``split.py``'s split-key
attention).  The kernels are built at first use
(``kernels/_build.py``) and launched on PyTorch's current stream without
synchronising.

Fake tensors (``torch._subclasses.fake_tensor``: the dry run's shapes
without data): a fake CUDA call builds, loads and launches nothing and
moves no launch counter; it allocates the outputs (and K2's lse) in their
shapes and types and charges the kernel's operations and bytes to the
active ``utils/cost.py`` counter (:func:`flash_cost`,
:func:`flash_bwd_cost`: the query-key pairs the mask keeps).  A real
launch charges the same.  A fake CPU call takes the plain version, as a
real one does.

Training: when grad is enabled and an input requires grad, a CUDA call goes
through :class:`FlashAttention`, whose forward also writes each query
row's log-sum-exp and whose backward launches K2' (``csrc/flash_bwd.cu``,
:func:`flash_attention_bwd`; plain version
:func:`~repro_torch.kernels.flash.ref.flash_bwd_plain`).  On CPU tensors
``flash_attention`` is autograd through ``attention_plain``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from ...utils.cost import charge
from .._build import load_library
from .ref import attention_lse_plain, attention_plain, flash_bwd_plain

LIB_NAME = "repro_torch_flash"
SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash.cu",)
BWD_LIB_NAME = "repro_torch_flash_bwd"
BWD_SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_bwd.cu",)
#: head sizes the kernel takes (a template parameter of the kernel)
HEAD_DIMS = (16, 32, 64, 128)

_ENTRY = {torch.float32: "flash_fwd_f32", torch.bfloat16: "flash_fwd_bf16"}
_BWD_ENTRY = {torch.float32: "flash_bwd_f32",
              torch.bfloat16: "flash_bwd_bf16"}


def _library() -> ctypes.CDLL:
    lib = load_library(LIB_NAME, SOURCES)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.flash_fwd_bf16_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.flash_fwd_bf16_blocks_per_sm.restype = ctypes.c_int
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = load_library(BWD_LIB_NAME, BWD_SOURCES)
    for name in _BWD_ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.flash_bwd_bf16_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.flash_bwd_bf16_blocks_per_sm.restype = ctypes.c_int
    return lib


def blocks_per_sm(hd: int, kernel: str = "fwd") -> int:
    """Blocks of a bfloat16 kernel resident on one SM at head size ``hd``
    (CUDA's occupancy calculator, at the kernel's registers and shared
    memory): the forward (``"fwd"``), or the backward's dk/dv
    (``"dkdv"``) or dq (``"dq"``) kernel."""
    if kernel == "fwd":
        n = _library().flash_fwd_bf16_blocks_per_sm(hd)
    else:
        n = _bwd_library().flash_bwd_bf16_blocks_per_sm(
            hd, ("dkdv", "dq").index(kernel))
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the bfloat16 kernel
    copies 16 bytes at a time with cp.async); a view at another offset is
    copied.  A fake tensor has no address: it is only made contiguous."""
    t = t.contiguous()
    return t if is_fake(t) or t.data_ptr() % 16 == 0 else t.clone()


def mask_pairs(S: int, T: int, causal: bool, window: int = 0,
               k_offset: int = 0) -> int:
    """The query-key pairs the mask keeps: all S T, or under the
    start-aligned causal mask kpos <= qpos, and under a window > 0 only
    kpos > qpos - window besides, the keys at positions k_offset ..
    k_offset + T - 1."""
    s = np.arange(S, dtype=np.int64) - k_offset     # in the block's keys
    hi = np.minimum(s, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(0, s - window + 1) if window > 0 else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_cost(B, S, T, H, KV, hd, causal, window, dtype,
               with_lse=False, k_offset=0) -> tuple:
    """(operations, bytes) of one K2 call: 4 hd a kept pair and query head
    (the score and its share of p v); q, k, v read and the output (and the
    lse) written once."""
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = esize * (2 * B * S * H * hd + 2 * B * T * KV * hd) \
        + (4 * B * H * S if with_lse else 0)
    return 4 * hd * mask_pairs(S, T, causal, window, k_offset) * B * H, \
        nbytes


def flash_bwd_cost(B, S, T, H, KV, hd, causal, window, dtype,
                   k_offset=0) -> tuple:
    """(operations, bytes) of one K2' call: the five hd-deep products
    (q k^T, dO v^T, P^T dO, dS^T q, dS k) over the kept pairs; q, k, v, o,
    dO and lse read and dq, dk, dv written once."""
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = esize * (4 * B * S * H * hd + 4 * B * T * KV * hd) \
        + 4 * B * H * S
    return 10 * hd * mask_pairs(S, T, causal, window, k_offset) * B * H, \
        nbytes


def kernel_head_dim(hd: int) -> int:
    """The head size the kernels run ``hd`` at: the least of ``HEAD_DIMS``
    not below it (``hd`` itself when the kernels are built for it)."""
    for size in HEAD_DIMS:
        if hd <= size:
            return size
    raise ValueError(f"head size {hd} not taken by the kernel (at most "
                     f"{HEAD_DIMS[-1]}; smaller ones are zero-padded to one "
                     f"of {HEAD_DIMS})")


def _pad_hd(tensors, hd_kernel: int) -> list:
    """Each (..., hd) tensor zero-padded to (..., hd_kernel)."""
    return [t if t.shape[-1] == hd_kernel else
            torch.nn.functional.pad(t, (0, hd_kernel - t.shape[-1]))
            for t in tensors]


def _check(q, k, v, causal: bool = True, window: int = 0,
           k_offset: int = 0) -> tuple:
    """Validate the shapes, devices, types, the window and the key offset;
    returns (B, S, T, H, KV, hd)."""
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not {dev}")
    if int(window) != window or window < 0:
        raise ValueError(f"window {window!r}: expected an integer >= 0 "
                         "(0: none)")
    if window > 0 and not causal:
        raise ValueError("a sliding window is taken only with the causal "
                         "mask (the model's attention is causal)")
    if int(k_offset) != k_offset or k_offset < 0:
        raise ValueError(f"k_offset {k_offset!r}: expected an integer >= 0")
    if dev.type == "cuda":
        if dtype not in _ENTRY:
            raise TypeError(f"flash_attention takes float32 or bfloat16, "
                            f"not {dtype}")
        kernel_head_dim(hd)
        if min(B, S, T) < 1:
            raise ValueError(f"empty attention: B {B}, S {S}, T {T}")
    return B, S, T, H, KV, hd


def _forward(q, k, v, causal: bool, with_lse: bool, window: int = 0,
             k_offset: int = 0):
    """(out, lse or None) of K2 on CUDA tensors (checked by ``_check``)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    dev = q.device
    cost = flash_cost(B, S, T, H, KV, hd, causal, window, q.dtype, with_lse,
                      k_offset)
    if is_fake(q):
        lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
               if with_lse else None)
        charge("flash_attention", *cost)
        return torch.empty_like(q, memory_format=torch.contiguous_format), \
            lse
    hd_k = kernel_head_dim(hd)
    q, k, v = (aligned16(t) for t in _pad_hd((q, k, v), hd_k))
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if with_lse else None)
    fn = getattr(_library(), _ENTRY[q.dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, S, T, H, KV, hd_k, int(bool(causal)), int(window),
                 int(k_offset), 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    charge("flash_attention", *cost)
    if hd_k != hd:
        out = out[..., :hd].contiguous()
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """softmax(q k^T / sqrt(hd), mask) v in model layout.

    q: (B, S, H, hd); k, v: (B, T, KV, hd) with H a multiple of KV, all of
    one type (float32 or bfloat16 on the card).  The causal mask keeps
    ``kpos <= qpos`` counted from 0; ``window`` > 0 (with ``causal`` only)
    also keeps only ``kpos > qpos - window``.  Returns (B, S, H, hd) in
    q's type.  On CUDA tensors that need a gradient it goes through
    :class:`FlashAttention` (K2 with its log-sum-exp, K2' in the
    backward).  Every forward kernel launch adds one to
    ``flash_attention.launches``.  DTensors (the dry run's sharded layers)
    run through ``local_map`` on each rank's blocks, in q's placements
    (heads or the batch split); where k's sequence is split over a mesh
    dim that q is whole on (the reference's ``_kv_seq_spec``), each rank
    attends to its block of the keys, at the offset of its coordinate
    there, and the blocks' softmaxes are combined over that dim
    (``split.py::split_key_attention``).
    """
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        from .split import split_key_attention, split_key_dim
        if split_key_dim(q, k) is not None:
            return split_key_attention(q, k, v, causal=causal, window=window)
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.experimental import local_map
        place = [Replicate() if p.is_partial() else p for p in q.placements]
        q, k, v = (t if list(t.placements) == place
                   else t.redistribute(t.device_mesh, place)
                   for t in (q, k, v))
        return local_map(
            functools.partial(flash_attention, causal=causal, window=window),
            out_placements=place, in_placements=(place, place, place),
            device_mesh=q.device_mesh)(q, k, v)
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, False, window)[0]


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int = 0, k_offset: int = 0):
    """K2': (dq, dk, dv) of ``flash_attention`` at the output gradient
    ``do``, from the forward's output ``o`` and log-sum-exp ``lse``
    ((B, H, S) float32, of the same ``causal``, ``window`` and
    ``k_offset``; or the output and lse of the whole key sequence, of
    which k and v are the block at ``k_offset``: then dk and dv are the
    block's, dq its share); each in its input's type.  CPU tensors take the
    plain version (:func:`~repro_torch.kernels.flash.ref.flash_bwd_plain`);
    CUDA tensors launch ``csrc/flash_bwd.cu`` or raise: three kernels, D
    (rowsum(do o o)), dk/dv (a block per kv head and 64-key tile) and dq
    (a block per query head and 64-row tile), on the tensor cores for
    bfloat16 and on the CUDA cores for float32.  Each call adds one to
    ``flash_attention_bwd.launches``."""
    B, S, T, H, KV, hd = _check(q, k, v, causal, window, k_offset)
    dtype, dev = q.dtype, q.device
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != (B, S, H, hd) or t.device != dev:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does "
                             f"not match q {tuple(q.shape)} on {dev}")
    if tuple(lse.shape) != (B, H, S):
        raise ValueError(f"lse has shape {tuple(lse.shape)}, expected "
                         f"{(B, H, S)}")
    if dev.type == "cpu":
        return flash_bwd_plain(q, k, v, o, do, lse, causal=causal,
                               window=window, k_offset=k_offset)
    cost = flash_bwd_cost(B, S, T, H, KV, hd, causal, window, dtype,
                          k_offset)
    if is_fake(q):
        charge("flash_attention_bwd", *cost)
        return tuple(torch.empty(t.shape, dtype=dtype, device=dev)
                     for t in (q, k, v))
    hd_k = kernel_head_dim(hd)
    q, k, v, o, do = (aligned16(t) for t in _pad_hd(
        [t.to(dtype) for t in (q, k, v, o, do)], hd_k))
    lse = lse.to(torch.float32).contiguous()
    dq, dk, dv = (torch.empty(t.shape, dtype=dtype, device=dev)
                  for t in (q, k, v))
    D = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    fn = getattr(_bwd_library(), _BWD_ENTRY[dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), D.data_ptr(), B, S, T, H, KV, hd_k,
                 int(bool(causal)), int(window), int(k_offset),
                 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd.launches += 1
    charge("flash_attention_bwd", *cost)
    if hd_k != hd:
        dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention with a hand-written backward: the forward keeps q, k, v,
    the output and its log-sum-exp (K2 on CUDA tensors; the plain
    versions on CPU tensors) and the backward is
    :func:`flash_attention_bwd` (K2' on CUDA tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, window: int = 0):
        _check(q, k, v, causal, window)
        if q.device.type == "cpu":
            out = attention_plain(q, k, v, causal=causal, window=window)
            lse = attention_lse_plain(q, k, causal=causal, window=window)
        else:
            q, k, v = (aligned16(t) for t in (q, k, v))
            out, lse = _forward(q, k, v, causal, True, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, out, do, lse,
                                    causal=ctx.causal, window=ctx.window)
        return tuple(g if need else None for g, need
                     in zip(grads, ctx.needs_input_grad)) + (None, None)
