"""Wrapper of the hand-written Hopper min-plus sweep kernel (K1).

``sweep_minplus`` is the port's counterpart of
``repro.kernels.minplus.kernel.sweep_minplus`` (the Pallas TPU kernel).
For tensors on the CPU it computes the plain version
(:func:`~repro_torch.kernels.minplus.ref.sweep_plain`); for CUDA tensors it
launches ``csrc/minplus.cu`` or raises — it never falls back.  The kernel
is built at first use (``kernels/_build.py``) and launched on PyTorch's
current stream without synchronising.

:func:`launch_plan` picks the kernel's route from the shape alone: a
cluster of C blocks per threshold holding the masked graph in shared
memory when few thresholds are swept, else tiles of T thresholds per block.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from .._build import load_library
from .ref import sweep_plain

LIB_NAME = "repro_torch_minplus"
SOURCES = (Path(__file__).resolve().parent / "csrc" / "minplus.cu",)
#: the most dynamic shared memory one H100 block can use
MAX_SHARED_BYTES = 232_448
#: the largest thread-block cluster (16 needs the non-portable attribute)
MAX_CLUSTER = 16
#: thresholds per block of the tiled route (template instantiations)
TILES = (1, 2, 4, 8)
#: lanes that share one output's reduction in the cluster route, and the
#: most threads a block has: every output of a block needs its lanes
PARTS = 4
MAX_THREADS = 1024
#: the cluster route's target for a block's masked graph slice: the cluster
#: grows until the slice is this small (``chip_smoke.py --time-k1`` times
#: the fleet's window, which stops after 2 layers, and its bottleneck call,
#: which runs 29, at every cluster size: on an H100 both are fastest at 13
#: blocks, 79 KB a block, and slower at 7 (139 KB) and at 14-16)
SLICE_BYTES = 80 * 1024
#: the H100 SXM's SMs, for ``launch_plan`` when no device is given
H100_SMS = 132

_ENTRY = {torch.float64: "minplus_sweep_f64", torch.float32: "minplus_sweep_f32"}


@dataclass(frozen=True)
class LaunchPlan:
    """How one K1 launch runs: ``route`` is "cluster" (``cluster`` blocks
    per threshold) or "tiled" (``tile`` thresholds per block)."""
    route: str
    cluster: int
    tile: int


def _pad_stride(x: int, esize: int) -> int:
    """``pad_stride`` of ``minplus.cu``: x rounded up to 8 modulo 128
    bytes' worth of elements."""
    p = 128 // esize
    return x + (8 - x) % p


def cluster_smem_bytes(N: int, I1: int, C: int, esize: int) -> int:
    """Shared memory of one block of the cluster route (``minplus.cu``'s
    ``cluster_smem_bytes``): both dist buffers, the reduction and vote
    slots, A and the block's masked slices of the graph."""
    M = -(-N // C)
    elems = (2 * N * I1 + MAX_CLUSTER + 32 + I1 * M
             + (N + I1) * _pad_stride(I1 * M, esize))
    return elems * esize + 32          # + three mbarriers


def slice_bytes(N: int, I1: int, C: int, esize: int) -> int:
    """A cluster-route block's masked slices Vc[:, :, M_r], Vs[:, M_r, :]
    for the largest M_r."""
    return -(-N // C) * (N * I1 + I1 * I1) * esize


def tiled_smem_bytes(N: int, I1: int, T: int, esize: int) -> int:
    """Shared memory of one block of the tiled route: dist and A for T
    thresholds."""
    return 2 * N * I1 * T * esize


def cluster_fits(N: int, I1: int, C: int, esize: int) -> bool:
    """Whether the cluster route runs a graph of ``N`` nodes and ``I1``
    cuts on C blocks a threshold (``minplus.cu``'s ``launch_cluster``
    refuses the rest): C <= min(N, 16), each block's shared memory fits,
    and every output of a block gets its ``PARTS`` lanes in one pass."""
    return (1 <= C <= min(N, MAX_CLUSTER)
            and cluster_smem_bytes(N, I1, C, esize) <= MAX_SHARED_BYTES
            and I1 * -(-N // C) * PARTS <= MAX_THREADS)


def tile_fits(N: int, I1: int, T: int, esize: int) -> bool:
    """Whether the tiled route runs T thresholds a block of this graph."""
    return T in TILES and tiled_smem_bytes(N, I1, T, esize) <= MAX_SHARED_BYTES


@functools.lru_cache(maxsize=256)
def launch_plan(S: int, N: int, I1: int, esize: int,
                sms: int = H100_SMS) -> LaunchPlan:
    """The route of a launch over ``S`` thresholds of a graph with ``N``
    nodes and ``I1`` cuts in ``esize``-byte floats, on a card of ``sms``
    SMs.

    The cluster route takes C blocks per threshold, for C from the smallest
    cluster whose blocks' slices fit in shared memory and whose blocks'
    outputs each get ``PARTS`` lanes of one pass (``I1 * ceil(N / C) *
    PARTS <= MAX_THREADS``; C <= min(N, 16)): the smallest whose slice is
    at most ``SLICE_BYTES``, else the largest, and at most ``sms // S`` so
    that the ``S`` clusters run at once.  When no such C exists the tiled
    route takes the fewest thresholds per block that still fill the card in
    one wave (at most 8, and as many as fit in shared memory): a larger T
    reads the graph fewer times but leaves SMs idle and lengthens each
    block's chain (``--time-k1`` times every T; the largest T that fits is
    up to 1.8x slower at the quickstart's and the 96-server graph's
    thresholds).  At T = 1 it takes every graph whose dist and A fit one
    block.  Raises ``ValueError`` for a graph too large for either.
    """
    top = min(N, MAX_CLUSTER, sms // max(S, 1))
    fits = [C for C in range(1, MAX_CLUSTER + 1)
            if cluster_fits(N, I1, C, esize)]
    if fits and fits[0] <= top:
        small = [C for C in fits if slice_bytes(N, I1, C, esize)
                 <= SLICE_BYTES]
        return LaunchPlan("cluster", min(small[0] if small else fits[-1],
                                         top), 0)
    fit = [T for T in TILES if tile_fits(N, I1, T, esize)]
    if not fit:
        raise ValueError(
            f"graph too large for one block's shared memory: "
            f"{tiled_smem_bytes(N, I1, 1, esize)} > {MAX_SHARED_BYTES} bytes "
            f"(N={N}, I+1={I1})")
    T = next((T for T in fit if -(-S // T) <= sms), fit[-1])
    return LaunchPlan("tiled", 0, T)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(LIB_NAME, SOURCES)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(args, dtype, dev):
    N, I1 = args["Ccom"].shape[0], args["Ccom"].shape[1]
    shapes = {"Ccom": (N, I1, N), "Bcom": (N, I1, N), "Sseg": (I1, N, I1),
              "Bseg": (I1, N, I1), "src_cost": (I1,), "src_beta": (I1,)}
    for name, t in args.items():
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                             f"{dtype} on {dev}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


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
    _check(dict(Ccom=Ccom, Bcom=Bcom, Sseg=Sseg, Bseg=Bseg,
                src_cost=src_cost, src_beta=src_beta), dtype, dev)
    if int(K) < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    out = torch.empty(ts.shape[0], dtype=dtype, device=dev)
    if ts.shape[0] == 0:
        return out
    plan = launch_plan(ts.shape[0], Ccom.shape[0], Ccom.shape[1],
                       Ccom.element_size(),
                       _sm_count(dev.index if dev.index is not None
                                 else torch.cuda.current_device()))
    launch(plan, Ccom, Bcom, Sseg, Bseg, src_cost, src_beta, K, ts, out,
           mode)
    return out


def launch(plan: LaunchPlan, Ccom, Bcom, Sseg, Bseg, src_cost, src_beta, K,
           ts, out, mode: str) -> None:
    """Launch K1 by ``plan`` on checked CUDA inputs, writing ``out``; adds
    one to ``sweep_minplus.launches``.  Raises if the launch is refused."""
    fn = getattr(_library(), _ENTRY[Ccom.dtype])
    N, I1 = Ccom.shape[0], Ccom.shape[1]
    with torch.cuda.device(Ccom.device):
        stream = torch.cuda.current_stream(Ccom.device).cuda_stream
        err = fn(ts.data_ptr(), Ccom.data_ptr(), Bcom.data_ptr(),
                 Sseg.data_ptr(), Bseg.data_ptr(), src_cost.data_ptr(),
                 src_beta.data_ptr(), out.data_ptr(), ts.shape[0], N, I1,
                 int(K), int(mode == "sum"), plan.cluster, plan.tile, stream)
    if err == -1:
        smem = cluster_smem_bytes(N, I1, plan.cluster, Ccom.element_size())
        raise RuntimeError(f"minplus kernel launch refused: no cluster of "
                           f"{plan.cluster} blocks with {smem} bytes of "
                           f"shared memory each can be resident")
    if err != 0:
        raise RuntimeError(f"minplus kernel launch failed ({plan}): CUDA "
                           f"error {err}")
    sweep_minplus.launches += 1


sweep_minplus.launches = 0
