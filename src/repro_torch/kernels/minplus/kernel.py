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

With ``graph=`` the inputs stack G graphs on a leading axis and one launch
sweeps every threshold on its own graph (``Planner.solve_many``'s b-sweep):
a cluster reads its threshold's graph in place; the tiled route's blocks
each take T thresholds of one graph, so :func:`tile_slots` pads every
graph's thresholds to whole tiles with -inf and the outputs of the padded
slots are dropped.
"""

from __future__ import annotations

import ctypes
import functools
import math
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
                sms: int = H100_SMS, groups: tuple | None = None
                ) -> LaunchPlan:
    """The route of a launch over ``S`` thresholds of a graph with ``N``
    nodes and ``I1`` cuts in ``esize``-byte floats, on a card of ``sms``
    SMs.  ``groups`` gives the thresholds per graph of a launch over
    stacked graphs: a tile then counts the padded slots of
    :func:`tile_slots`, ``sum(ceil(c / T))`` blocks.

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
    T = next((T for T in fit
              if sum(-(-c // T) for c in (groups or (S,))) <= sms), fit[-1])
    return LaunchPlan("tiled", 0, T)


def tile_slots(graph, T: int) -> tuple:
    """The tiled route's layout of thresholds on stacked graphs: the
    thresholds of each graph (in order of graph, then of position) fill
    whole tiles of ``T`` slots, the last one padded.  Returns ``(slots,
    slot_graph)``: ``slots[s]`` is threshold s's slot, and ``slot_graph``
    the graph of every slot (a multiple of ``T`` long; a padded slot takes
    its tile's graph and a -inf threshold)."""
    members: dict = {}
    for s, g in enumerate(graph):
        members.setdefault(int(g), []).append(s)
    slots = [0] * len(graph)
    slot_graph: list = []
    for g in sorted(members):
        for s in members[g]:
            slots[s] = len(slot_graph)
            slot_graph.append(g)
        slot_graph += [g] * (-len(members[g]) % T)
    return slots, slot_graph


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(LIB_NAME, SOURCES)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(args, dtype, dev, stacked: bool):
    """Device, dtype, shape and contiguity of the graph tensors (with a
    leading graph axis when ``stacked``); returns (G, N, I + 1)."""
    lead = tuple(args["Ccom"].shape[:1]) if stacked else ()
    if stacked and args["Ccom"].dim() != 4:
        raise ValueError(f"Ccom has shape {tuple(args['Ccom'].shape)}; with "
                         "graph= it must be (G, N, I+1, N)")
    N, I1 = args["Ccom"].shape[len(lead)], args["Ccom"].shape[len(lead) + 1]
    shapes = {"Ccom": (N, I1, N), "Bcom": (N, I1, N), "Sseg": (I1, N, I1),
              "Bseg": (I1, N, I1), "src_cost": (I1,), "src_beta": (I1,)}
    shapes = {name: lead + shape for name, shape in shapes.items()}
    for name, t in args.items():
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                             f"{dtype} on {dev}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return (lead[0] if stacked else 1), N, I1


def graph_index(graph, S: int, G: int) -> torch.Tensor:
    """``graph`` as a CPU int64 tensor of S graph indices in [0, G)
    (a CUDA tensor is copied to the host, which waits for it)."""
    idx = torch.as_tensor(graph).reshape(-1).to("cpu", torch.int64)
    if idx.numel() != S:
        raise ValueError(f"graph has {idx.numel()} entries for {S} "
                         "thresholds")
    if S and (int(idx.min()) < 0 or int(idx.max()) >= G):
        raise ValueError(f"graph indices must lie in [0, {G})")
    return idx


def sweep_minplus(Ccom, Bcom, Sseg, Bseg, src_cost, src_beta, K, ts, *,
                  mode: str = "sum", graph=None) -> torch.Tensor:
    """Best terminal DP value per threshold, as a tensor on the inputs'
    device in their dtype (float64 or float32).

    Layouts match the ``_LayeredDP`` buffers: ``Ccom/Bcom[n, i, m]``,
    ``Sseg/Bseg[i, m, j]``, ``src_cost/src_beta[i]``, structural masks
    pre-folded; ``ts`` is a 1-D batch of thresholds.  With ``graph`` (S
    integers) every tensor carries a leading axis of G graphs and threshold
    s runs on graph ``graph[s]``, exactly as a one-graph call on that graph
    would.  Every launch adds one to ``sweep_minplus.launches``.
    """
    if mode not in ("sum", "max"):
        raise ValueError(f"mode must be 'sum' or 'max', got {mode!r}")
    dev = Ccom.device
    if dev.type == "cpu":
        return sweep_plain(Ccom, Bcom, Sseg, Bseg, src_cost, src_beta, K, ts,
                           mode=mode, graph=graph)
    if dev.type != "cuda":
        raise ValueError(f"sweep_minplus runs on cpu or cuda, not {dev}")
    dtype = Ccom.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"sweep_minplus takes float64 or float32, not {dtype}")
    ts = torch.as_tensor(ts, dtype=dtype, device=dev).reshape(-1)
    G, N, I1 = _check(dict(Ccom=Ccom, Bcom=Bcom, Sseg=Sseg, Bseg=Bseg,
                           src_cost=src_cost, src_beta=src_beta), dtype, dev,
                      stacked=graph is not None)
    if int(K) < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    S = ts.shape[0]
    out = torch.empty(S, dtype=dtype, device=dev)
    if S == 0:
        return out
    sms = _sm_count(dev.index if dev.index is not None
                    else torch.cuda.current_device())
    if graph is None:
        plan = launch_plan(S, N, I1, Ccom.element_size(), sms)
        launch(plan, Ccom, Bcom, Sseg, Bseg, src_cost, src_beta, K, ts, out,
               mode)
        return out
    idx = graph_index(graph, S, G)
    groups = tuple(int(c) for c in torch.bincount(idx) if c)
    plan = launch_plan(S, N, I1, Ccom.element_size(), sms, groups)
    if plan.route == "cluster":
        launch(plan, Ccom, Bcom, Sseg, Bseg, src_cost, src_beta, K, ts, out,
               mode, graph=_to_device(idx.tolist(), torch.int32, dev))
        return out
    slots, slot_graph = tile_slots(idx.tolist(), plan.tile)
    slots = _to_device(slots, torch.int64, dev)
    ts_pad = torch.full((len(slot_graph),), -math.inf, dtype=dtype,
                        device=dev)
    ts_pad[slots] = ts
    out_pad = torch.empty_like(ts_pad)
    launch(plan, Ccom, Bcom, Sseg, Bseg, src_cost, src_beta, K, ts_pad,
           out_pad, mode, graph=_to_device(slot_graph, torch.int32, dev))
    return out_pad[slots]


def _to_device(values: list, dtype, dev) -> torch.Tensor:
    """A host list as a device tensor, copied from pinned memory without
    waiting: a copy from pageable memory would wait for every launch
    queued before it."""
    return torch.tensor(values, dtype=dtype).pin_memory().to(
        dev, non_blocking=True)


def launch(plan: LaunchPlan, Ccom, Bcom, Sseg, Bseg, src_cost, src_beta, K,
           ts, out, mode: str, graph=None) -> None:
    """Launch K1 by ``plan`` on checked CUDA inputs, writing ``out``; adds
    one to ``sweep_minplus.launches``.  Raises if the launch is refused.
    ``graph`` (int32 on the device) names each slot's graph of stacked
    inputs; on the tiled route each tile's slots share one graph."""
    fn = getattr(_library(), _ENTRY[Ccom.dtype])
    N, I1 = Ccom.shape[-3], Ccom.shape[-2]
    with torch.cuda.device(Ccom.device):
        stream = torch.cuda.current_stream(Ccom.device).cuda_stream
        err = fn(ts.data_ptr(), Ccom.data_ptr(), Bcom.data_ptr(),
                 Sseg.data_ptr(), Bseg.data_ptr(), src_cost.data_ptr(),
                 src_beta.data_ptr(),
                 None if graph is None else graph.data_ptr(),
                 out.data_ptr(), ts.shape[0], N, I1, int(K),
                 int(mode == "sum"), plan.cluster, plan.tile, stream)
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
