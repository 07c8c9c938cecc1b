"""Wrapper of the hand-written Hopper min-plus sweep kernel (K1).

``sweep_minplus`` is the port's counterpart of
``repro.kernels.minplus.kernel.sweep_minplus`` (the Pallas TPU kernel).
For tensors on the CPU it computes the plain version
(:func:`~repro_torch.kernels.minplus.ref.sweep_plain`); for CUDA tensors it
launches ``csrc/minplus.cu`` or raises — it never falls back.  The kernel
is built at first use (``kernels/_build.py``) and launched on PyTorch's
current stream without synchronising.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import load_library
from .ref import sweep_plain

LIB_NAME = "repro_torch_minplus"
SOURCES = (Path(__file__).resolve().parent / "csrc" / "minplus.cu",)
#: the most dynamic shared memory one H100 block can use (dist + A live there)
MAX_SHARED_BYTES = 232_448

_ENTRY = {torch.float64: "minplus_sweep_f64", torch.float32: "minplus_sweep_f32"}


def _library() -> ctypes.CDLL:
    lib = load_library(LIB_NAME, SOURCES)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def sweep_minplus(Ccom, Bcom, Sseg, Bseg, src_cost, src_beta, K, ts, *,
                  mode: str = "sum") -> torch.Tensor:
    """Best terminal DP value per threshold, as a tensor on the inputs'
    device in their dtype (float64 or float32).

    Layouts match the ``_LayeredDP`` buffers: ``Ccom/Bcom[n, i, m]``,
    ``Sseg/Bseg[i, m, j]``, ``src_cost/src_beta[i]``, structural masks
    pre-folded; ``ts`` is a 1-D batch of thresholds.  Every launch adds one
    to ``sweep_minplus.launches``.
    """
    if mode not in ("sum", "max"):
        raise ValueError(f"mode must be 'sum' or 'max', got {mode!r}")
    dev = Ccom.device
    if dev.type == "cpu":
        return sweep_plain(Ccom, Bcom, Sseg, Bseg, src_cost, src_beta, K, ts,
                           mode=mode)
    if dev.type != "cuda":
        raise ValueError(f"sweep_minplus runs on cpu or cuda, not {dev}")
    dtype = Ccom.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"sweep_minplus takes float64 or float32, not {dtype}")
    ts = torch.as_tensor(ts, dtype=dtype, device=dev).reshape(-1)
    N, I1 = Ccom.shape[0], Ccom.shape[1]
    shapes = {"Ccom": (N, I1, N), "Bcom": (N, I1, N), "Sseg": (I1, N, I1),
              "Bseg": (I1, N, I1), "src_cost": (I1,), "src_beta": (I1,)}
    args = dict(Ccom=Ccom, Bcom=Bcom, Sseg=Sseg, Bseg=Bseg,
                src_cost=src_cost, src_beta=src_beta)
    for name, t in args.items():
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                             f"{dtype} on {dev}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if int(K) < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    smem = 2 * N * I1 * Ccom.element_size()
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"graph too large for one block's shared memory: "
                         f"{smem} > {MAX_SHARED_BYTES} bytes (N={N}, I+1={I1})")
    out = torch.empty(ts.shape[0], dtype=dtype, device=dev)
    if ts.shape[0] == 0:
        return out
    fn = getattr(_library(), _ENTRY[dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ts.data_ptr(), Ccom.data_ptr(), Bcom.data_ptr(),
                 Sseg.data_ptr(), Bseg.data_ptr(), src_cost.data_ptr(),
                 src_beta.data_ptr(), out.data_ptr(), ts.shape[0], N, I1,
                 int(K), int(mode == "sum"), stream)
    if err != 0:
        raise RuntimeError(f"minplus kernel launch failed: CUDA error {err}")
    sweep_minplus.launches += 1
    return out


sweep_minplus.launches = 0
