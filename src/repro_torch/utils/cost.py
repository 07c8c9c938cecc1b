"""A step's cost per device — the counterpart of ``repro/utils/hlo.py``.

The reference compiles a step with XLA and walks the per-partition HLO:
FLOPs of the dots, operand and output bytes of the materializing ops, and
the operand bytes of each collective, with every while loop's body scaled
by its trip count.  The port has no HLO.  It counts the ops one rank
actually runs, under a ``TorchDispatchMode`` (:class:`CostCounter`):

- **FLOPs** by ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, SDPA) at the shapes of the tensors this rank computes on.
  An op on DTensors is not counted itself: DTensor runs it as local ops
  (and collectives) on each rank's blocks, and those are counted, so a
  product sharded n ways counts 1/n of its FLOPs here and a replicated one
  counts whole on every rank.  A hand-written kernel adds its own work
  through :func:`charge` (its launch is invisible to the dispatcher).
- **Traffic**: operand plus output bytes of every op that is not a view,
  as the reference counts each materializing op.
- **Collective bytes by kind**, the operand bytes as
  ``collective_bytes`` (``hlo.py:67``) counts them: "all-gather",
  "all-reduce", "reduce-scatter", "all-to-all" from the c10d and
  functional collectives the dispatcher sees, and the pipeline's stage
  hops under the reference's name "collective-permute" from
  ``pipeline/spmd.py::Pipe.bytes`` (a p2p op reaches no dispatcher).
- **Memory** (``track_memory``): the bytes of the storages alive after
  each op (meta-device tensors, shapes without storage, are neither
  counted nor tracked), their peak, and which of them were there before
  the step;
  with ``breakdown`` also the storages alive at the peak above the
  arguments, each by the op that made it (:meth:`CostCounter.peak_by_op`).
- **FLOPs by product** (``breakdown``): each counted op's FLOPs summed by
  the op and its operands' shapes (:meth:`CostCounter.flops_by_op`), the
  counterpart of ``tests/dryrun_reference.py``'s ``"dots"``.

``while_trip_counts`` / ``unresolved_loops`` have no counterpart: torch
counts each op every time it runs, so a loop body is counted once per
pass.  ``cpu_f32_promotion_bytes`` (``hlo.py:318``) has none either: it
corrects an XLA:CPU artifact (bf16 dots promoted to f32) that eager torch
does not have.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: the collective kinds, under the reference's HLO names
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

#: dispatcher collectives -> (kind, index of the operand argument)
_COLLECTIVE_OPS = {
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
}

#: ``Pipe.bytes`` kinds -> collective kinds
PIPE_KINDS = {"hop": "collective-permute", "hop_back": "collective-permute"}


def tensor_bytes(x, dtype=None) -> int:
    """Bytes of a tensor, of a (nested) list / tuple of tensors, or of a
    shape given with its ``dtype`` — the counterpart of ``shape_bytes``
    (which reads them from an HLO shape string)."""
    if dtype is not None:
        n = 1
        for d in x:
            n *= int(d)
        return n * torch.empty((), dtype=dtype).element_size()
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(t) for t in x)
    return 0


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict
    total_bytes: int

    def summary(self) -> str:
        parts = [f"{k}:{v/1e6:.1f}MB(x{self.count_by_kind[k]})"
                 for k, v in sorted(self.bytes_by_kind.items())]
        return " ".join(parts) or "none"


@dataclasses.dataclass
class StepCost:
    """Per-device cost of a step (the reference's ``HloCost`` without its
    loop fields): FLOPs, HBM traffic bytes, collective bytes (total and by
    kind), the ops by count and the hand-written kernels' charges."""
    flops: float
    traffic_bytes: float
    collective_bytes: float
    collective_by_kind: dict
    ops: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    collectives: CollectiveStats | None = None


_ACTIVE: list = []
#: >0 while DTensor plans an op (its strategies, and its global output
#: shape by running it on fake global tensors): not this rank's work, so
#: not counted
_PROPAGATING = [0]
_SAVED = {}
#: the ShardingPropagator methods that plan an op
_PLANNING = ("_propagate_tensor_meta_non_cached",
             "propagate_op_sharding_non_cached")


def _install_propagation_guard() -> None:
    """Wrap DTensor's planning so that the counter skips its ops, which
    also run outside any fake mode of the caller's (they compute shard
    offsets with small real tensors, which a fake mode cannot read)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    for name in _PLANNING:
        original = getattr(ShardingPropagator, name)
        _SAVED[name] = original

        def guarded(self, op_schema, _original=original):
            _PROPAGATING[0] += 1
            try:
                with unset_fake_temporarily():
                    return _original(self, op_schema)
            finally:
                _PROPAGATING[0] -= 1

        setattr(ShardingPropagator, name, guarded)


def _remove_propagation_guard() -> None:
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    for name in _PLANNING:
        setattr(ShardingPropagator, name, _SAVED.pop(name))


def charge(name: str, flops: float, nbytes: float) -> None:
    """Add a hand-written kernel's work to every active counter (nothing
    when none is): its FLOPs, the bytes it moves and one call of
    ``name``."""
    for c in _ACTIVE:
        m = c._mult
        c.flops += m * flops
        c.traffic += m * nbytes
        k = c.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                        "bytes": 0.0})
        k["calls"] += m
        k["flops"] += m * flops
        k["bytes"] += m * nbytes


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _storage_key(t: torch.Tensor):
    from torch.multiprocessing.reductions import StorageWeakRef
    ref = StorageWeakRef(t.untyped_storage())
    return ref.cdata, ref


class CostCounter(TorchDispatchMode):
    """Counts the ops run under it (see the module docstring).  ``pipe``:
    a ``Pipe`` whose hop bytes during the run are the stage hops;
    ``track_memory``: keep the live storages' bytes after every op (their
    peak in ``peak_bytes``; :meth:`mark_arguments` first names the
    storages that existed before the step)."""

    def __init__(self, *, pipe=None, track_memory: bool = False,
                 breakdown: bool = False):
        super().__init__()
        self.flops = 0.0
        self.traffic = 0.0
        self.coll_bytes = defaultdict(float)
        self.coll_count = defaultdict(int)
        self.ops = defaultdict(int)
        self.kernels = {}
        self.pipe = pipe
        self._pipe0 = None
        self.track_memory = track_memory
        self._live = {}
        self._args = set()
        self.peak_bytes = 0
        self.peak_temp_bytes = 0
        # the bytes of every storage in _live (the dead ones too until a
        # sweep drops them), of the arguments among them, and the size
        # _live may reach before a sweep
        self._bound = 0
        self._arg_bytes = 0
        self._sweep_at = 1024
        self._mult = 1
        self.breakdown = breakdown
        self._made_by = {}          # storage -> (op, shape, dtype)
        self._op = None
        self._at_peak = {}          # storage -> (bytes, (op, shape, dtype))
        self._flops_by = defaultdict(lambda: [0.0, 0])

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs inside ``n`` times: one pass traced for ``n``
        passes of the same shapes (the reference's trip count).  Memory is
        not scaled: each pass peaks alike."""
        self._mult *= n
        try:
            yield self
        finally:
            self._mult //= n

    # -- memory ---------------------------------------------------------
    def mark_arguments(self, *trees) -> int:
        """Register the storages of every tensor in ``trees`` (DTensors
        by their local blocks) as the step's arguments; returns their
        bytes, each storage once."""
        total = 0
        for t in tree_flatten(trees)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            if _is_dtensor(t):
                t = t._local_tensor
            key, ref = _storage_key(t)
            if key not in self._args:
                self._args.add(key)
                n = t.untyped_storage().nbytes()
                if key not in self._live:
                    self._bound += n
                self._live[key] = (ref, n)
                self._arg_bytes += n
                total += n
        return total

    def live_bytes(self, *, temp: bool = False) -> int:
        self._sweep()
        return self._bound - (self._arg_bytes if temp else 0)

    def _sweep(self) -> None:
        """Drop the storages that died since the last sweep."""
        for k in [k for k, (ref, _) in self._live.items() if ref.expired()]:
            n = self._live.pop(k)[1]
            self._bound -= n
            if k in self._args:
                self._args.discard(k)
                self._arg_bytes -= n
            self._made_by.pop(k, None)
        self._sweep_at = 2 * len(self._live) + 1024

    def _track(self, outs) -> None:
        """Register new storages among ``outs``; when there is one that
        may raise a peak, drop the dead and update the peaks (a peak can
        only rise where something is allocated, and only above what is
        live, dead storages not yet dropped included: below that bound
        nothing is swept but every so often, to keep the table small)."""
        new = False
        for t in outs:
            if isinstance(t, torch.Tensor) and not _is_dtensor(t):
                key, ref = _storage_key(t)
                if key not in self._live:
                    n = t.untyped_storage().nbytes()
                    self._live[key] = (ref, n)
                    self._bound += n
                    new = True
                    if self.breakdown:
                        self._made_by[key] = (self._op, tuple(t.shape),
                                              str(t.dtype))
        if not new or (self._bound <= self.peak_bytes
                       and self._bound - self._arg_bytes
                       <= self.peak_temp_bytes
                       and len(self._live) < self._sweep_at):
            return
        self._sweep()
        live = self._bound
        temp = live - self._arg_bytes
        self.peak_bytes = max(self.peak_bytes, live)
        if temp > self.peak_temp_bytes and self.breakdown:
            self._at_peak = {k: (n, self._made_by.get(k))
                             for k, (_, n) in self._live.items()
                             if k not in self._args}
        self.peak_temp_bytes = max(self.peak_temp_bytes, temp)

    def peak_by_op(self, top: int = 12) -> list:
        """The storages alive at the peak above the arguments (needs
        ``breakdown``), grouped by the op, shape and type that made them:
        [{"op", "shape", "dtype", "count", "bytes"}], the largest first."""
        groups = defaultdict(lambda: [0, 0])
        for n, made in self._at_peak.values():
            g = groups[made or ("?", (), "?")]
            g[0] += 1
            g[1] += n
        rows = [{"op": op, "shape": list(shape), "dtype": dtype,
                 "count": c, "bytes": b}
                for (op, shape, dtype), (c, b) in groups.items()]
        return sorted(rows, key=lambda r: -r["bytes"])[:top]

    def flops_by_op(self, top: int = 40) -> list:
        """The counted FLOPs (needs ``breakdown``) grouped by op and
        operand shapes: [{"op", "shapes", "count", "flops"}], the largest
        first."""
        rows = [{"op": op, "shapes": [list(s) for s in shapes],
                 "count": c, "flops": f}
                for (op, shapes), (f, c) in self._flops_by.items()]
        return sorted(rows, key=lambda r: -r["flops"])[:top]

    # -- dispatch -------------------------------------------------------
    def __enter__(self):
        if not _ACTIVE:
            _install_propagation_guard()
        _ACTIVE.append(self)
        if self.pipe is not None:
            self._pipe0 = dict(self.pipe.bytes)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        if not _ACTIVE:
            _remove_propagation_guard()
        if self.pipe is not None:
            for what, kind in PIPE_KINDS.items():
                n = self.pipe.bytes[what] - self._pipe0[what]
                if n:
                    self.coll_bytes[kind] += n
                    self.coll_count[kind] += 1
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor turn this op into local ops and collectives on
            # this rank's blocks, which come back here to be counted
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._op = str(func.overloadpacket)
        if _PROPAGATING[0] or getattr(func, "namespace", "") == "prim":
            return out          # planning, or a metadata query (.device)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if outs and all(t.device.type == "meta" for t in outs):
            return out          # shapes only (a spec on the meta device)
        flat = tree_flatten((args, kwargs))[0]
        packet = func.overloadpacket
        space, _, name = str(packet).rpartition(".")
        m = self._mult
        self.ops[name] += m
        coll = _COLLECTIVE_OPS.get(str(packet))
        if coll is not None:
            kind, i = coll
            self.coll_bytes[kind] += m * tensor_bytes(args[i])
            self.coll_count[kind] += m
        elif not func.is_view and space not in ("c10d", "_c10d_functional"):
            from torch.utils.flop_counter import flop_registry
            f = flop_registry.get(packet)
            if f is not None:
                n = m * f(*args, **kwargs, out_val=out)
                self.flops += n
                if self.breakdown and n:
                    row = self._flops_by[(name, tuple(
                        tuple(t.shape) for t in flat
                        if isinstance(t, torch.Tensor)))]
                    row[0] += n
                    row[1] += m
            self.traffic += m * (sum(tensor_bytes(t) for t in flat
                                     if isinstance(t, torch.Tensor))
                                 + tensor_bytes(tree_flatten(out)[0]))
        if self.track_memory:
            self._track(tree_flatten(out)[0])
        return out

    def cost(self) -> StepCost:
        stats = CollectiveStats(dict(self.coll_bytes), dict(self.coll_count),
                                int(sum(self.coll_bytes.values())))
        return StepCost(flops=self.flops, traffic_bytes=self.traffic,
                        collective_bytes=float(stats.total_bytes),
                        collective_by_kind=dict(self.coll_bytes),
                        ops=dict(self.ops), kernels=dict(self.kernels),
                        collectives=stats)


def step_cost(fn, *args, pipe=None, **kwargs) -> StepCost:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter` and return
    its cost (the counterpart of ``hlo_cost``)."""
    with CostCounter(pipe=pipe) as c:
        fn(*args, **kwargs)
    return c.cost()


def op_histogram(cost, top: int = 15) -> list:
    """(op, count), the most frequent first, of a :class:`StepCost` (or a
    {op: count} dict)."""
    counts = cost.ops if isinstance(cost, StepCost) else cost
    return sorted(counts.items(), key=lambda kv: -kv[1])[:top]


__all__ = ["CollectiveStats", "CostCounter", "KINDS", "StepCost", "charge",
           "op_histogram", "step_cost", "tensor_bytes"]
