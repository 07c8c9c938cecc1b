"""Event, task-table, and trace records for the pipeline simulator — the
port of ``repro/sim/events.py``.

A simulation run executes one unit of work per (micro-batch, resource) pair
connected by precedence edges.  Two representations exist:

* ``Task`` — one explicit unit for the heap-based event loop; a run is a
  list of tasks plus chain edges (``dep``) and any policy edges.
* ``VisitTable`` — the structure-of-arrays task table for the vectorized
  engine: because micro-batches are identical jobs, one row per *visit*
  (position in the per-micro-batch chain) describes all ``Q`` micro-batches
  at once and the micro-batch axis stays implicit until execution.

Executing either produces a timeline — eager ``TraceRecord`` lists from the
heap engine, a dense ``Timeline`` (start/end float64 tensors on the run's
device) from the vectorized engine.  The table itself is host data: it is
structure, read once per run.  :func:`write_chrome_trace` exports a
timeline's records as a Chrome/Perfetto trace.

Resource keys mirror the aggregation of Eq. (13) / C9-C16:

  ("fp",  node)        the node's forward engine
  ("bp",  node)        the node's backward engine (separate resource, C13)
  ("fwd", n, n')       the directed n->n' transfer resource (activations)
  ("bwd", n', n)       the directed n'->n transfer resource (act-gradients)

Co-located submodels map to the *same* key, so their per-micro-batch work
serializes — exactly the per-node sums of the analytical bottleneck.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch


#: task kinds, in the order they appear along one micro-batch's chain
KINDS = ("fp", "fwd", "bp", "bwd")


@dataclasses.dataclass(frozen=True)
class Task:
    """One unit of simulated work.

    ``work`` is in capacity units (kappa-scaled workload for compute, bytes
    for transfers) and is served at the resource's — possibly time-varying —
    capacity; ``fixed`` is a rate-independent latency constant (the paper's
    t0/t1 terms) paid up front.
    """
    tid: int
    microbatch: int
    stage: int                   # submodel index k (link tasks: upstream k)
    kind: str                    # "fp" | "bp" | "fwd" | "bwd"
    resource: tuple              # see module docstring
    work: float
    fixed: float = 0.0
    dep: int | None = None       # tid that must finish first (chain edge)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown task kind {self.kind!r}")
        if self.work < 0 or self.fixed < 0:
            raise ValueError("work/fixed must be non-negative")


@dataclasses.dataclass(frozen=True)
class VisitTable:
    """Structure-of-arrays task table for one micro-batch's visit chain.

    Micro-batches are identical jobs, so the per-visit arrays describe every
    micro-batch; the engine broadcasts over the micro-batch axis instead of
    materializing ``Q * len(self)`` Task objects.  Visit order is chain
    order: FP/fwd sweep up the stages, then BP/bwd back down — the same
    order ``engine.build_tasks`` emits explicit tasks in.
    """
    kinds: tuple        # per visit: "fp" | "fwd" | "bp" | "bwd"
    stages: tuple       # per visit: submodel index k (links: upstream k)
    resources: tuple    # per visit: resource key (see module docstring)
    work: np.ndarray    # per visit: capacity-units of work
    fixed: np.ndarray   # per visit: rate-independent seconds
    fp_visit: np.ndarray  # stage position j -> visit index of its FP
    bp_visit: np.ndarray  # stage position j -> visit index of its BP

    def __len__(self) -> int:
        return len(self.kinds)

    @property
    def num_stages(self) -> int:
        return len(self.fp_visit)

    def is_reentrant(self) -> bool:
        """True when some resource appears at two visits (co-located
        submodels, e.g. client FP+BP split across revisits) — FIFO service
        then interleaves the visit streams and the vectorized engine runs
        its merged-scan fixpoint instead of the independent column scans."""
        return len(set(self.resources)) != len(self.resources)

    def resource_visits(self) -> dict:
        """Per-resource visit ordering: ``{resource: (visit, ...)}`` with
        visits in chain order.  The grouping the vectorized engine's
        reentrant path advances — each resource serves the *merge* of its
        visit streams (each stream internally in micro-batch order), so the
        tuple is exactly the set of streams to merge.  Cached on first use
        (the table is frozen)."""
        got = getattr(self, "_resource_visits", None)
        if got is None:
            groups: dict = {}
            for v, res in enumerate(self.resources):
                groups.setdefault(res, []).append(v)
            got = {res: tuple(vs) for res, vs in groups.items()}
            object.__setattr__(self, "_resource_visits", got)
        return got


@dataclasses.dataclass(frozen=True)
class Timeline:
    """Dense (Q, R) start/end times from the vectorized engine — the SoA
    counterpart of a ``TraceRecord`` list.  ``starts`` / ``ends`` are
    float64 tensors on the run's device."""
    table: VisitTable
    starts: torch.Tensor   # (num_microbatches, len(table))
    ends: torch.Tensor

    @property
    def num_microbatches(self) -> int:
        return self.starts.shape[0]

    def to_records(self) -> list:
        """Materialize explicit ``TraceRecord``s (completion order), with
        one host copy of each matrix."""
        t = self.table
        starts = self.starts.tolist()
        ends = self.ends.tolist()
        recs = [
            TraceRecord(m, t.stages[v], t.kinds[v], t.resources[v],
                        starts[m][v], ends[m][v])
            for m in range(len(starts))
            for v in range(len(t))
        ]
        recs.sort(key=lambda r: (r.end, r.start, r.microbatch))
        return recs


@dataclasses.dataclass(frozen=True)
class TraceRecord:
    """One executed task: [start, end) occupancy of ``resource``."""
    microbatch: int
    stage: int
    kind: str
    resource: tuple
    start: float
    end: float

    @property
    def duration(self) -> float:
        return self.end - self.start


def resource_label(resource: tuple) -> str:
    if resource[0] in ("fp", "bp"):
        return f"node{resource[1]}:{resource[0]}"
    return f"link{resource[1]}->{resource[2]}:{resource[0]}"


def write_chrome_trace(records, path: str, *, time_scale: float = 1e6,
                       counter_tracks: bool = False,
                       flow_events: bool = False,
                       wall_spans=None) -> str:
    """Write the timeline as a Chrome-trace JSON (ts/dur in microseconds).

    One "thread" per resource; each record becomes a complete ("X") event.
    Load the file at chrome://tracing or https://ui.perfetto.dev.

    Optional extras (all on pid ``obs.SIM_PID`` except the last):

    * ``counter_tracks`` — per-resource "C" counter tracks showing
      instantaneous occupancy (pipeline bubbles render as dips), plus a
      pipeline-wide active-task counter.
    * ``flow_events`` — "s"/"f" flow arrows linking each micro-batch's
      forward transfer on a hop to its backward transfer on the reverse
      hop, making the round trip visible.
    * ``wall_spans`` — finished ``obs.span()`` records (e.g.
      ``obs.wall_spans()``); rendered as wall-clock solver tracks on their
      own process (pid ``obs.SOLVER_PID``) next to the simulated-time
      pipeline tracks.
    """
    from ..obs import trace as obs_trace

    resources = sorted({r.resource for r in records},
                       key=lambda res: (KINDS.index(res[0]), res[1:]))
    tid_of = {res: i for i, res in enumerate(resources)}
    pid = obs_trace.SIM_PID
    events: list = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                     "args": {"name": "pipeline (simulated time)"}}]
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": resource_label(res)}}
               for res, tid in tid_of.items()]
    for r in records:
        events.append({
            "name": f"mb{r.microbatch} k{r.stage} {r.kind}",
            "ph": "X", "pid": pid, "tid": tid_of[r.resource],
            "ts": r.start * time_scale,
            "dur": max(r.end - r.start, 0.0) * time_scale,
            "args": {"microbatch": r.microbatch, "stage": r.stage,
                     "kind": r.kind},
        })
    if counter_tracks:
        events += obs_trace.utilization_counter_events(
            records, pid=pid, time_scale=time_scale,
            label_of=resource_label)
    if flow_events:
        events += obs_trace.microbatch_flow_events(
            records, tid_of, pid=pid, time_scale=time_scale)
    if wall_spans:
        events += obs_trace.solver_span_events(
            wall_spans, pid=obs_trace.SOLVER_PID, time_scale=time_scale)
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, default=str)
    return path
