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

Training: when grad is enabled and an input requires grad, a CUDA call goes
through :class:`WKV6`, which keeps the forward's pass-1 scratch (the state
entering each 64-token tile) for its backward, K3' (``csrc/wkv6_bwd.cu``,
:func:`wkv6_bwd`; plain versions
:func:`~repro_torch.kernels.rwkv6.ref.wkv6_bwd_plain`, the per-token walk,
and :func:`~repro_torch.kernels.rwkv6.ref.wkv6_bwd_tiled_plain`, the
kernel's tiled decomposition).  That scratch is
(B * H, ceil(S / 64), hd, hd) float32: 16.8 MB per layer and micro-batch at
rwkv6-1.6b's training shape (4 x 512 tokens, 32 heads of 64), held until
the layer's backward (under ``remat="layer"`` only for the layer being
recomputed).  On CPU tensors ``wkv6`` is autograd through the chunked
plain version.

Fake tensors (the dry run's shapes without data): a fake CUDA call
builds, loads and launches nothing and moves no launch counter; it
allocates the outputs in their shapes and types and charges the scan's
operations and bytes to the active ``utils/cost.py`` counter
(:func:`wkv6_cost`, :func:`wkv6_bwd_cost`), as a real launch does.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import is_fake

from ...utils.cost import charge
from .._build import load_library
from ..flash.kernel import aligned16
from .ref import wkv6_bwd_plain, wkv6_chunked_plain

LIB_NAME = "repro_torch_wkv6"
SOURCES = (Path(__file__).resolve().parent / "csrc" / "wkv6.cu",)
BWD_LIB_NAME = "repro_torch_wkv6_bwd"
BWD_SOURCES = (Path(__file__).resolve().parent / "csrc" / "wkv6_bwd.cu",)
#: head sizes taken: the kernel reads 4-vectors of heads of at most 64, and
#: the wrapper zero-pads heads of 1 and 2 to 4
HEAD_DIMS = (1, 2, 4, 8, 16, 32, 64)
#: tokens per tile of the kernel (its scratch holds one state per tile)
TILE = 64

#: head sizes the backward takes (the wrapper pads smaller heads to 4)
BWD_HEAD_DIMS = (4, 8, 16, 32, 64)

_ENTRY = {torch.float32: "wkv6_f32", torch.bfloat16: "wkv6_bf16"}
_BWD_ENTRY = {torch.float32: "wkv6_bwd_f32", torch.bfloat16: "wkv6_bwd_bf16"}


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


def _bwd_library() -> ctypes.CDLL:
    lib = load_library(BWD_LIB_NAME, BWD_SOURCES)
    for name in _BWD_ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.wkv6_bwd_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.wkv6_bwd_blocks_per_sm.restype = ctypes.c_int
    return lib


def blocks_per_sm(pass_: int, dtype=torch.bfloat16, *,
                  backward: bool = False) -> int:
    """Blocks of pass 1 (the states) or 2 (the outputs) of the ``dtype``
    entry resident on one SM (CUDA's occupancy calculator); with
    ``backward``, of the backward K3': pass 1 is B1 (the gradient states),
    pass 2 is B2 (the tiles)."""
    lib, fn = ((_bwd_library(), "wkv6_bwd_blocks_per_sm") if backward
               else (_library(), "wkv6_blocks_per_sm"))
    n = getattr(lib, fn)(pass_, int(dtype == torch.bfloat16))
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
    On CUDA tensors that need a gradient it goes through :class:`WKV6`
    (K3 keeping its tile states, K3' in the backward).  Each call adds one
    to ``wkv6.launches``: it counts scans, not the two CUDA launches a scan
    makes.
    """
    from torch.distributed.tensor import DTensor
    if isinstance(r, DTensor):
        return _on_blocks(r, k, v, logw, u, s0, chunk)
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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u, s0)):
        return WKV6.apply(r, k, v, logw, u, s0)
    return _launch(r, k, v, logw, u, s0)[:2]


wkv6.launches = 0


def _on_blocks(r, k, v, logw, u, s0, chunk):
    """``wkv6`` on DTensors (the dry run's sharded layers): each rank's
    blocks through ``local_map``, r / k / v / log w split as r is over the
    batch and the heads (a partial sum summed first), u and s0 split to
    match."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = r.device_mesh
    x_pl = [Replicate() if p.is_partial() or (p.is_shard() and p.dim not in
                                              (0, 2)) else p
            for p in r.placements]
    u_pl = [Shard(0) if p == Shard(2) else Replicate() for p in x_pl]
    s_pl = [Shard(1) if p == Shard(2) else p for p in x_pl]

    def put(t, pl):
        if not isinstance(t, DTensor):      # a plain tensor is replicated
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t if list(t.placements) == pl else t.redistribute(mesh, pl)

    from torch.distributed.tensor import DTensor
    args = [put(t, x_pl) for t in (r, k, v, logw)] + [put(u, u_pl),
                                                        put(s0, s_pl)]
    return local_map(lambda *a: wkv6(*a, chunk=chunk),
                     out_placements=(x_pl, s_pl),
                     in_placements=(x_pl,) * 4 + (u_pl, s_pl),
                     device_mesh=mesh)(*args)


def wkv6_cost(B, S, H, hd, dtype) -> tuple:
    """(operations, bytes) of one K3 scan: the chunked form over the
    kernel's 64-token tiles (q S and the state update, 2 n hd^2 each; q k'^T
    and its product with v below the diagonal, n (n - 1) hd each; decays,
    exponentials and bonus, 8 n hd; the state's decay, hd^2, for a tile of
    n); r, k, v, log w, u and s0 read and y and S_final written once."""
    esize = torch.empty((), dtype=dtype).element_size()
    elems = B * S * H * hd
    tiles = [TILE] * (S // TILE) + ([S % TILE] if S % TILE else [])
    ops = sum(4 * n * hd * hd + 2 * n * (n - 1) * hd + 8 * n * hd + hd * hd
              for n in tiles)
    return ops * B * H, (elems * (3 * esize + 4 + 4) + H * hd * 4
                         + 2 * B * H * hd * hd * 4)


def wkv6_bwd_cost(B, S, H, hd, dtype) -> tuple:
    """(operations, bytes) of one K3' call: the per-token walk's products
    (10 hd^2 a token and head); the forward's inputs, dy and dS_final read
    and the six gradients written once."""
    esize = torch.empty((), dtype=dtype).element_size()
    elems = B * S * H * hd
    return 10 * hd * hd * B * S * H, (
        elems * (3 * esize + 4 + 4) + H * hd * 4 + 2 * B * H * hd * hd * 4
        + elems * (3 * esize + 4) + H * hd * 4 + B * H * hd * hd * 4)


def _launch(r, k, v, logw, u, s0):
    """K3 on checked CUDA inputs (hd >= 4): (y, S_final, states), states
    the pass-1 scratch (B * H, ceil(S / 64), hd, hd) float32.  On fake
    tensors: the three outputs allocated and the scan's work charged
    (``utils/cost.py``), nothing launched."""
    B, S, H, hd = r.shape
    dev = r.device
    cost = wkv6_cost(B, S, H, hd, r.dtype)
    if is_fake(r):
        charge("wkv6", *cost)
        return (torch.empty((B, S, H, hd), dtype=torch.float32, device=dev),
                torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev),
                torch.empty((B * H, -(-S // TILE), hd, hd),
                            dtype=torch.float32, device=dev))
    # the kernel reads 4-vectors
    r, k, v, logw, u, s0 = (aligned16(t) for t in (r, k, v, logw, u, s0))
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
    s_out = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    scratch = torch.empty((B * H, -(-S // TILE), hd, hd),
                          dtype=torch.float32, device=dev)
    fn = getattr(_library(), _ENTRY[r.dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
                 scratch.data_ptr(), B, S, H, hd, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv6.launches += 1
    charge("wkv6", *cost)
    return y, s_out, scratch


def wkv6_bwd(r, k, v, logw, u, s0, dy, ds_final, *, states=None):
    """K3': (dr, dk, dv, dlogw, du, ds0) of :func:`wkv6` at the output
    gradients ``dy`` (B, S, H, hd) and ``ds_final`` (B, H, hd, hd); dr, dk
    and dv in r's type, the rest float32, du summed over the batch.  CPU
    tensors take the plain version
    (:func:`~repro_torch.kernels.rwkv6.ref.wkv6_bwd_plain`); CUDA tensors
    launch ``csrc/wkv6_bwd.cu`` or raise: three kernels, B1 (G at each
    64-token tile's end, into a float32 scratch of (B * H, ceil(S / 64),
    hd, hd): 16.8 MB at rwkv6-1.6b's training layer, freed after the call),
    B2 (every tile's gradients at once) and B3 (du over the batch and the
    tiles); :func:`~repro_torch.kernels.rwkv6.ref.wkv6_bwd_tiled_plain` is
    the same decomposition in plain PyTorch.  ``states`` is K3's pass-1
    scratch from the forward of the same inputs; without it one K3 launch
    recomputes it.  Each call adds one to ``wkv6_bwd.launches``."""
    B, S, H, hd = r.shape
    dtype, dev = r.dtype, r.device
    f32 = torch.float32
    logw, u, s0, dy, ds_final = (t.to(dtype=f32)
                                 for t in (logw, u, s0, dy, ds_final))
    if dev.type == "cpu":
        dr, dk, dv, dlw, du, ds0 = wkv6_bwd_plain(r, k, v, logw, u, s0, dy,
                                                  ds_final)
        return dr.to(dtype), dk.to(dtype), dv.to(dtype), dlw, du, ds0
    if dev.type != "cuda":
        raise ValueError(f"wkv6_bwd runs on cpu or cuda, not {dev}")
    if dtype not in _BWD_ENTRY:
        raise TypeError(f"wkv6_bwd takes float32 or bfloat16 r/k/v, not "
                        f"{dtype}")
    if hd not in BWD_HEAD_DIMS:
        raise ValueError(f"head size {hd} not taken by the backward kernel "
                         f"(one of {BWD_HEAD_DIMS})")
    shapes = {"k": (k, dtype, (B, S, H, hd)), "v": (v, dtype, (B, S, H, hd)),
              "logw": (logw, f32, (B, S, H, hd)), "u": (u, f32, (H, hd)),
              "s0": (s0, f32, (B, H, hd, hd)),
              "dy": (dy, f32, (B, S, H, hd)),
              "ds_final": (ds_final, f32, (B, H, hd, hd))}
    for name, (t, want_dtype, shape) in shapes.items():
        if t.device != dev or t.dtype != want_dtype or \
                tuple(t.shape) != shape:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; expected {want_dtype} {shape} on "
                             f"{dev}")
    cost = wkv6_bwd_cost(B, S, H, hd, dtype)
    if is_fake(r):
        charge("wkv6_bwd", *cost)
        return tuple(torch.empty((B, S, H, hd), dtype=dt, device=dev)
                     for dt in (dtype, dtype, dtype, f32)) + (
            torch.empty((H, hd), dtype=f32, device=dev),
            torch.empty((B, H, hd, hd), dtype=f32, device=dev))
    if states is None:
        states = _launch(r, k, v, logw, u, s0)[2]
    want = (B * H, -(-S // TILE), hd, hd)
    if states.device != dev or states.dtype != f32 or \
            tuple(states.shape) != want:
        raise ValueError(f"states is {states.dtype} {tuple(states.shape)} on "
                         f"{states.device}; expected {f32} {want} on {dev} "
                         "(K3's pass-1 scratch)")
    r, k, v, logw, u, dy, ds_final = (
        aligned16(t) for t in (r, k, v, logw, u, dy, ds_final))
    states = aligned16(states)
    dr, dk, dv = (torch.empty((B, S, H, hd), dtype=dtype, device=dev)
                  for _ in range(3))
    dlw = torch.empty((B, S, H, hd), dtype=f32, device=dev)
    du = torch.empty((H, hd), dtype=f32, device=dev)
    ds0 = torch.empty((B, H, hd, hd), dtype=f32, device=dev)
    gscratch = torch.empty_like(states)
    du_part = torch.empty(states.shape[:2] + (hd,), dtype=f32, device=dev)
    fn = getattr(_bwd_library(), _BWD_ENTRY[dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in (
            r, k, v, logw, u, dy, ds_final, states, dr, dk, dv, dlw, du,
            ds0, gscratch, du_part)), B, S, H, hd, stream)
    if err != 0:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: CUDA error "
                           f"{err}")
    wkv6_bwd.launches += 1
    charge("wkv6_bwd", *cost)
    return dr, dk, dv, dlw, du, ds0


wkv6_bwd.launches = 0


class WKV6(torch.autograd.Function):
    """The scan with a hand-written backward: the forward (K3) keeps its
    pass-1 scratch, the state entering each 64-token tile, and the
    backward is :func:`wkv6_bwd` (K3') from it.  CUDA tensors with hd >= 4
    (``wkv6`` pads smaller heads before it applies this)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        y, s_out, states = _launch(r, k, v, logw, u, s0)
        ctx.save_for_backward(r, k, v, logw, u, s0, states)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, ds_final):
        r, k, v, logw, u, s0, states = ctx.saved_tensors
        grads = wkv6_bwd(r, k, v, logw, u, s0, dy, ds_final, states=states)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
