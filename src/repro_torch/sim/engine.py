"""Event-driven executor for a pipelined-SL plan — the port of
``repro/sim/engine.py``.

Each micro-batch is a chain of tasks — client FP, per-hop activation
transfers, per-stage server FP, then BP and act-gradient transfers back —
and each task occupies one FIFO resource (node FP engine, node BP engine, or
a directed link; see ``events``).  An admission policy (``policies``:
"fifo" = GPipe-like, "1f1b", "memory") adds window edges that gate when a
micro-batch may enter each stage.  Two engines execute the task set:

* **event** (default) — a priority queue of (time, seq) events over Python
  floats, as in the reference; a resource serves one task at a time and
  tasks queue in arrival order, so co-located submodels *contend* exactly
  as the per-node sums of Eq. (13)/C9-C16 assume.  Exact for every
  scenario, and equal (``==``) to the reference's timelines.
* **vectorized** — heap-free batched event advancement over the
  structure-of-arrays ``VisitTable`` on the run's device: service
  start/end times obey the max-plus recurrence

      end[m, v] = serve_v(max(end[m, v-1], end[m-1, v], end[m-w_j, bp_j]))

  which collapses into ``torch.cummax`` prefix scans over float64 tensors
  (per *visit* for FIFO, per *micro-batch* for windowed policies, with the
  window index sets built on the host so the scans make no host sync per
  micro-batch).  Constant capacities keep the closed-form time-space scans;
  piecewise-constant traces run them in cumulative-work coordinates;
  reentrant placements iterate per-resource merged scans to the unique
  self-consistent FIFO schedule — see :mod:`repro_torch.sim.advance`.
  ``engine="auto"`` picks the vectorized engine for every instance it
  covers; only an instance that can stall forever (zero trailing capacity
  on a used resource), or a reentrant fixpoint that does not converge, runs
  the event engine, and ``SimReport.engine_reason`` says which ran and why.
  An explicit ``engine="vectorized"`` then raises naming the violated
  precondition.

Every entry point takes ``device`` (``"cuda"`` by default; it raises
without a GPU unless given ``"cpu"``).  ``SimReport.mb_complete`` and the
vectorized ``Timeline`` live on that device; records, utilization and the
heap engine's bookkeeping are host data.

Consistency guarantee (the standing ``sim.validate`` cross-check): on a
deterministic network whose plan places every submodel on a distinct node,
the simulated makespan equals the analytical

    L_t = T_f + ceil((B - b)/b) * T_i                            (Eq. 14)

to float precision, with the simulated fill time equal to Eq. (12)'s T_f and
the steady-state completion interval equal to Eq. (13)'s bottleneck T_i.

With a ``NetworkScenario``, task durations integrate the piecewise-constant
capacity traces from their start time, and ``simulate_with_replanning``
drives an ``ft.Coordinator`` from *simulated* time: at each trigger the
completed micro-batches are banked, the coordinator replans on the mutated
network (through the planner, which launches the min-plus kernel on the
card), and the remainder of the mini-batch resumes under the new plan.

A two-stage pipeline on a hand-built deterministic network (FP = BP = 2 s
per stage, transfers 0.1 s each way => T_f = 8.2 s, bottleneck T_i = 2 s):

>>> import numpy as np
>>> from repro_torch.core import (uniform_profile, EdgeNetwork, Node,
...                               SplitSolution)
>>> prof = uniform_profile(4, fp=1.0, bp=1.0, act=1.0)
>>> nodes = [Node("c", f=1.0, t0=0.0, t1=0.0, b_th=0, is_client=True),
...          Node("s", f=1.0, t0=0.0, t1=0.0, b_th=0)]
>>> net = EdgeNetwork(nodes=nodes, rate=np.array([[0., 10.], [10., 0.]]),
...                   num_clients=1)
>>> sol = SplitSolution(cuts=(2, 4), placement=(0, 1))
>>> rep = simulate_plan(prof, net, sol, b=1, num_microbatches=3,
...                     device="cpu")
>>> round(rep.T_f, 6), round(rep.T_i, 6), round(rep.L_t, 6)
(8.2, 2.0, 12.2)
>>> fast = simulate_plan(prof, net, sol, b=1, num_microbatches=3,
...                      engine="vectorized", policy="1f1b", device="cpu")
>>> round(fast.T_i, 6), round(fast.L_t, 6)
(4.2, 16.4)
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque

import numpy as np
import torch

from .._device import resolve_device
from ..core.latency import (SplitSolution, bp_work, bwd_bytes, fp_work,
                            fwd_bytes, num_fills)
from ..core.network import EdgeNetwork
from ..core.profiles import ModelProfile
from ..obs import (accumulate_service, busy_fractions, resource_traces,
                   service_from_records, utilization_from_records,
                   utilization_from_timeline)
from ..obs import inc as obs_inc
from ..obs import span as obs_span
from .advance import (ActiveEdges, VisitServe, fifo_pass, fixpoint_advance,
                      stack_eligible, stacked_fifo, stacked_fixpoint,
                      stacked_windowed, windowed_pass)
from .events import Task, Timeline, TraceRecord, VisitTable
from .policies import AdmissionPolicy, resolve_policy
from .scenario import NetworkScenario, PiecewiseTrace, constant

F64 = torch.float64


# ---------------------------------------------------------------------------
# Task construction: one chain per micro-batch
# ---------------------------------------------------------------------------

def build_tasks(profile: ModelProfile, net: EdgeNetwork, sol: SplitSolution,
                b: int, num_microbatches: int) -> list:
    """The task DAG (here: disjoint chains) for ``num_microbatches``
    micro-batches of size ``b`` through ``sol``'s stage/placement chain.

    Work terms mirror Eqs. (2)/(5)/(7)/(9) exactly: compute work is
    ``eff_b * kappa_n * delta`` served at f_n, transfer work is the
    activation/act-gradient byte volume served at the link rate; the t0/t1
    constants ride along as rate-independent ``fixed`` seconds.

    Derived from :func:`build_visit_table` — micro-batches are identical
    jobs, so the explicit task list is the visit chain repeated
    ``num_microbatches`` times with chain edges; keeping one source of
    truth for chain order, resources, and work terms is what lets the heap
    and vectorized engines be held bit-compatible.
    """
    table = build_visit_table(profile, net, sol, b)
    R = len(table)
    tasks: list = []
    for m in range(num_microbatches):
        base = m * R
        for v in range(R):
            tasks.append(Task(base + v, m, table.stages[v], table.kinds[v],
                              table.resources[v], work=float(table.work[v]),
                              fixed=float(table.fixed[v]),
                              dep=(base + v - 1) if v else None))
    return tasks


def build_visit_table(profile: ModelProfile, net: EdgeNetwork,
                      sol: SplitSolution, b: int) -> VisitTable:
    """Batched task construction: the structure-of-arrays task table.

    One row per *visit* in the per-micro-batch chain — client FP, per-hop
    activation transfer, ... , then BP and act-gradient transfers back —
    with the micro-batch axis implicit because every micro-batch is an
    identical job (the trailing remainder is padded to a full ``b``, the
    paper's Eq. (14) accounting).  ``build_tasks`` materializes explicit
    per-micro-batch chains from this table for the heap engine.
    """
    segs = list(sol.segments())
    if not segs:
        raise ValueError("solution has no non-empty submodels")
    kinds, stages, resources, work, fixed = [], [], [], [], []
    fp_visit, bp_visit = [0] * len(segs), [0] * len(segs)
    for j, (k, lo, hi, node) in enumerate(segs):
        fp_visit[j] = len(kinds)
        kinds.append("fp"); stages.append(k); resources.append(("fp", node))
        work.append(fp_work(profile, net, lo, hi, node, b))
        fixed.append(net.nodes[node].t0)
        if j + 1 < len(segs):
            nxt = segs[j + 1][3]
            kinds.append("fwd"); stages.append(k)
            resources.append(("fwd", node, nxt))
            work.append(fwd_bytes(profile, net, hi, b,
                                  from_client=(node == 0)))
            fixed.append(0.0)
    for j in range(len(segs) - 1, -1, -1):
        k, lo, hi, node = segs[j]
        bp_visit[j] = len(kinds)
        kinds.append("bp"); stages.append(k); resources.append(("bp", node))
        work.append(bp_work(profile, net, lo, hi, node, b))
        fixed.append(net.nodes[node].t1)
        if j > 0:
            _, _, hi_prev, below = segs[j - 1]
            kinds.append("bwd"); stages.append(k)
            resources.append(("bwd", node, below))
            work.append(bwd_bytes(profile, net, hi_prev, b,
                                  to_client=(below == 0)))
            fixed.append(0.0)
    return VisitTable(kinds=tuple(kinds), stages=tuple(stages),
                      resources=tuple(resources),
                      work=np.asarray(work, dtype=float),
                      fixed=np.asarray(fixed, dtype=float),
                      fp_visit=np.asarray(fp_visit, dtype=np.intp),
                      bp_visit=np.asarray(bp_visit, dtype=np.intp))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class _Resource:
    __slots__ = ("busy", "queue")

    def __init__(self):
        self.busy = False
        self.queue = deque()


def resource_trace(net: EdgeNetwork, scenario: NetworkScenario | None,
                   resource: tuple) -> PiecewiseTrace:
    """Capacity trace serving ``resource`` — node compute rate for fp/bp
    engines, directed link rate for transfers, scaled by the scenario's
    multiplier traces when one is given.  The single dispatch shared by the
    heap engine's duration integration and the vectorized engine's
    constant-capacity gate."""
    if resource[0] in ("fp", "bp"):
        if scenario is not None:
            return scenario.node_trace(net, resource[1])
        return constant(net.nodes[resource[1]].f)
    a, c = resource[1], resource[2]
    if scenario is not None:
        return scenario.link_trace(net, a, c)
    return constant(net.rate[a, c])


@dataclasses.dataclass
class SimReport:
    """Outcome of one simulation run.

    ``records`` (the explicit timeline) is materialized lazily: the
    vectorized engine keeps the dense ``timeline`` tensors and only builds
    ``TraceRecord`` objects when asked — a 10k-micro-batch run would
    otherwise pay for millions of dataclasses nobody reads.
    ``mb_complete`` is a float64 tensor on the run's device.
    """
    mb_complete: torch.Tensor    # absolute completion time per micro-batch
    t_start: float
    b: int
    num_microbatches: int
    resource_busy: dict          # resource -> busy fraction of the run
    policy: str = "fifo"         # admission policy that produced the run
    engine: str = "event"        # which engine ran ("event" | "vectorized")
    engine_reason: str = ""      # why that engine / which kernel path ran
    timeline: Timeline | None = None   # dense SoA timeline (vectorized runs)
    _records: list | None = None       # eager records (event runs)

    @property
    def records(self) -> list:
        """TraceRecords in completion order (materialized on first use)."""
        if self._records is None:
            if self.timeline is None:
                return []
            self._records = self.timeline.to_records()
        return self._records

    @property
    def makespan(self) -> float:
        """Absolute time the last micro-batch drains."""
        return float(self.mb_complete[-1]) if len(self.mb_complete) else self.t_start

    @property
    def T_f(self) -> float:
        """Simulated fill latency — first micro-batch end-to-end (Eq. 12)."""
        return float(self.mb_complete[0] - self.t_start)

    @property
    def T_i(self) -> float:
        """Simulated steady-state interval — trailing completion gap
        (Eq. 13's bottleneck on deterministic networks)."""
        if len(self.mb_complete) < 2:
            return 0.0
        return float(self.mb_complete[-1] - self.mb_complete[-2])

    @property
    def L_t(self) -> float:
        """Simulated total latency (Eq. 14's counterpart)."""
        return self.makespan - self.t_start

    def intervals(self) -> torch.Tensor:
        return torch.diff(self.mb_complete)

    def utilization(self, *, net: EdgeNetwork | None = None,
                    scenario: NetworkScenario | None = None,
                    traces: dict | None = None):
        """Per-resource busy/idle/blocked decomposition of this run — an
        ``obs.UtilizationReport`` (fill/bubble/drain split, per-node and
        per-link idle fractions; the paper's Sec. I "resource idleness"
        measured from the executed schedule).

        Built straight from the dense SoA ``timeline`` on vectorized runs
        and from the eager ``TraceRecord``s on event runs — the two paths
        are parity-checked in ``sim.validate``.  Pass ``traces`` (resource
        -> capacity trace), or ``net`` together with ``scenario`` to derive
        them, to split occupancy into busy vs blocked (zero-capacity
        outage) time.  Stacked plan-axis scoring reports carry completion
        times only and cannot be decomposed.
        """
        if self.timeline is not None:
            if traces is None and scenario is not None:
                if net is None:
                    raise ValueError("pass net together with scenario")
                traces = resource_traces(net, scenario,
                                         set(self.timeline.table.resources))
            return utilization_from_timeline(self.timeline, self.t_start,
                                             self.makespan, traces=traces)
        if self._records is not None:
            if traces is None and scenario is not None:
                if net is None:
                    raise ValueError("pass net together with scenario")
                traces = resource_traces(net, scenario,
                                         {r.resource for r in self._records})
            return utilization_from_records(self._records, self.t_start,
                                            self.makespan, traces=traces)
        raise ValueError(
            "this report carries completion times only (stacked plan-axis "
            "scoring path); re-simulate with simulate_plan for a timeline")


class PipelineSimulator:
    """FIFO-resource discrete-event simulator over a task set.

    Events are ordered by (time, insertion seq); ties therefore resolve
    causally and deterministically.  Task durations are computed at service
    start by integrating the resource's capacity trace — exact for the
    piecewise-constant scenarios (no preemption is needed because traces are
    exogenous).  The admission ``policy`` contributes extra precedence edges
    (none for FIFO).  The loop runs on host floats; the report's
    ``mb_complete`` goes to ``device`` (``"cuda"`` by default, as every
    entry point).
    """

    def __init__(self, net: EdgeNetwork, tasks, *, b: int = 0,
                 scenario: NetworkScenario | None = None, t_start: float = 0.0,
                 policy: AdmissionPolicy | str = "fifo", extra_deps=(),
                 device="cuda"):
        self.device = resolve_device(device)
        self.net = net
        self.tasks = {t.tid: t for t in tasks}
        self.b = b                   # micro-batch size, echoed in the report
        self.scenario = scenario
        self.t_start = t_start
        self.policy = resolve_policy(policy)
        self.extra_deps = (tuple(extra_deps) +
                           tuple(self.policy.extra_dependencies(tasks)))
        self._traces: dict = {}

    # -- capacity ------------------------------------------------------------
    def _trace(self, resource: tuple) -> PiecewiseTrace:
        tr = self._traces.get(resource)
        if tr is None:
            tr = resource_trace(self.net, self.scenario, resource)
            self._traces[resource] = tr
        return tr

    def _duration(self, task: Task, t: float) -> float:
        if task.work <= 0.0:
            return task.fixed
        tr = self._trace(task.resource)
        if len(tr.times) == 1:                 # constant capacity fast path
            v = tr.values[0]
            return task.fixed + (task.work / v if v > 0 else math.inf)
        return task.fixed + tr.time_to_complete(t + task.fixed, task.work)

    # -- event loop ----------------------------------------------------------
    def run(self) -> SimReport:
        succs: dict = {}
        indeg = {tid: 0 for tid in self.tasks}
        for t in self.tasks.values():
            if t.dep is not None:
                succs.setdefault(t.dep, []).append(t.tid)
                indeg[t.tid] += 1
        for src, dst in self.extra_deps:       # admission-policy window edges
            succs.setdefault(src, []).append(dst)
            indeg[dst] += 1
        resources: dict = {}
        for t in self.tasks.values():
            resources.setdefault(t.resource, _Resource())

        heap: list = []
        seq = 0

        def push(time, kind, tid):
            nonlocal seq
            heapq.heappush(heap, (time, seq, kind, tid))
            seq += 1

        # roots become ready at t_start, in tid (= micro-batch) order
        for tid in sorted(t.tid for t in self.tasks.values() if indeg[t.tid] == 0):
            push(self.t_start, "ready", tid)

        records: list = []
        mb_done: dict = {}
        started: dict = {}

        def start(task: Task, now: float):
            res = resources[task.resource]
            res.busy = True
            started[task.tid] = now
            dur = self._duration(task, now)
            push(now + dur, "end", task.tid)

        while heap:
            now, _, kind, tid = heapq.heappop(heap)
            task = self.tasks[tid]
            res = resources[task.resource]
            if kind == "ready":
                if res.busy:
                    res.queue.append(task)
                else:
                    start(task, now)
            else:  # "end"
                t0 = started.pop(tid)
                records.append(TraceRecord(task.microbatch, task.stage,
                                           task.kind, task.resource, t0, now))
                res.busy = False
                if res.queue:
                    start(res.queue.popleft(), now)
                for s in succs.get(tid, ()):
                    indeg[s] -= 1
                    if indeg[s] == 0:
                        push(now, "ready", s)
                prev = mb_done.get(task.microbatch, -math.inf)
                mb_done[task.microbatch] = max(prev, now)

        n_mb = 1 + max(mb_done) if mb_done else 0
        done = [mb_done[m] for m in range(n_mb)]
        mb_complete = torch.tensor(done, dtype=F64, device=self.device)
        span = (float(done[-1]) - self.t_start) if n_mb else 0.0
        # per-visit-stream sums folded by the shared obs helpers, so both
        # engines accumulate resource occupancy identically
        busy = busy_fractions(service_from_records(records), span)
        return SimReport(mb_complete=mb_complete,
                         t_start=self.t_start, b=self.b,
                         num_microbatches=n_mb, resource_busy=busy,
                         policy=self.policy.name, engine="event",
                         _records=records)


# ---------------------------------------------------------------------------
# Vectorized engine: heap-free batched event advancement
# ---------------------------------------------------------------------------

def _serve_models(table: VisitTable, net: EdgeNetwork,
                  scenario: NetworkScenario | None):
    """``(serves, why)``: the per-visit serving models, plus the violated
    vectorized-engine precondition as a string (``None`` when eligible).

    Since the trace and reentrant generalizations, the only remaining
    precondition is *finite service*: a visit whose resource has zero
    constant capacity, or whose trace ends at zero capacity, can stall
    forever — the unbounded-``inf`` bookkeeping is heap territory.  The
    single gate shared by :func:`vectorizable`, :func:`simulate_plan` and
    :func:`simulate_plans` so they can never drift.
    """
    serves = []
    why = None
    for v, res in enumerate(table.resources):
        s = VisitServe(resource_trace(net, scenario, res), table.work[v],
                       table.fixed[v])
        if why is None and not s.finite():
            why = (f"resource {res!r} cannot finish its work (zero trailing "
                   "capacity stalls forever)")
        serves.append(s)
    return serves, why


def vectorizable(profile: ModelProfile, net: EdgeNetwork, sol: SplitSolution,
                 b: int, scenario: NetworkScenario | None = None) -> bool:
    """True when the vectorized engine covers this instance — piecewise-
    constant (including constant) capacities with finite service.
    Reentrant/co-located placements are handled by the merged-scan fixpoint
    (see :mod:`repro_torch.sim.advance`); only an instance where some visit
    can stall forever on zero trailing capacity is event-engine-only."""
    table = build_visit_table(profile, net, sol, b)
    return _serve_models(table, net, scenario)[1] is None


def _empty_report(table: VisitTable, policy: AdmissionPolicy,
                  t_start: float, b: int, reason: str, device) -> SimReport:
    """Zero-micro-batch run, matching the event engine's empty report."""
    empty = torch.empty((0, len(table)), dtype=F64, device=device)
    return SimReport(mb_complete=torch.empty(0, dtype=F64, device=device),
                     t_start=t_start, b=b,
                     num_microbatches=0, resource_busy={},
                     policy=policy.name, engine="vectorized",
                     engine_reason=reason,
                     timeline=Timeline(table=table, starts=empty,
                                       ends=empty))


def _vectorized_run(table: VisitTable, durations: np.ndarray, Q: int,
                    policy: AdmissionPolicy, t_start: float, b: int,
                    device) -> SimReport:
    """Batched event advancement over the SoA task table — the constant-
    capacity, distinct-placement scans (:mod:`repro_torch.sim.advance`
    holds the trace and reentrant generalizations).

    Identical jobs through a chain of dedicated FIFO resources obey

        end[m, v] = d_v + max(end[m, v-1], end[m-1, v], feedback)

    where ``feedback = end[m - w_j, bp_j]`` for FP visits gated by a policy
    window ``w_j``.  Fixing one index collapses the other into a prefix-max
    scan: with no windows (FIFO) we sweep the R visits, each a
    ``torch.cummax`` over all Q micro-batches; with windows (1F1B) we sweep
    the Q micro-batches, each a cummax over the R visits with the window
    feedback gathered from earlier rows.  The durations, their prefix sums
    and the feedback index sets are host data, moved to ``device`` once.
    """
    d = durations
    R = len(d)
    S = table.num_stages
    windows = [policy.window(S, j) for j in range(S)]
    ends = torch.empty((Q, R), dtype=F64, device=device)
    rmat = torch.empty((Q, R), dtype=F64, device=device)  # non-chain ready

    if all(w is None for w in windows):
        # FIFO: visit-major sweep; e_v[m] = (m+1) d_v + cummax(a[m] - m d_v)
        idx = torch.arange(Q, dtype=F64, device=device)
        prev = torch.full((Q,), float(t_start), dtype=F64, device=device)
        for v in range(R):
            dv = float(d[v])
            prev = (idx + 1.0) * dv + torch.cummax(prev - idx * dv, 0).values
            ends[:, v] = prev
        rmat[0, :] = t_start
        rmat[1:, :] = ends[:-1, :]
    else:
        # windowed (e.g. 1F1B): micro-batch-major sweep with feedback edges
        D_host = np.cumsum(d)
        D = torch.as_tensor(D_host, dtype=F64, device=device)
        Dsh = torch.as_tensor(np.concatenate(([0.0], D_host[:-1])),
                              dtype=F64, device=device)
        gated = [j for j, w in enumerate(windows) if w is not None]
        edges = ActiveEdges([windows[j] for j in gated],
                            (table.fp_visit[gated], table.bp_visit[gated]),
                            device)
        for m in range(Q):
            r = rmat[m]
            if m == 0:
                r.fill_(t_start)
            else:
                r.copy_(ends[m - 1])
                got = edges.at(m)
                if got is not None:
                    ws, fp, bp = got
                    r[fp] = torch.maximum(r[fp], ends[m - ws, bp])
            ends[m] = D + torch.cummax(r - Dsh, 0).values

    chain_prev = torch.cat(
        (torch.full((Q, 1), float(t_start), dtype=F64, device=device),
         ends[:, :-1]), dim=1)
    starts = torch.maximum(chain_prev, rmat)
    mb_complete = ends[:, -1].clone()
    span = float(mb_complete[-1]) - t_start if Q else 0.0
    # constant capacities: per-visit service is exactly Q * d_v — O(R),
    # no (Q, R) reduction — folded through the shared obs accumulation
    busy = busy_fractions(accumulate_service(table.resources, Q * d), span)
    windowed = any(w is not None for w in windows)
    reason = ("vectorized: constant-capacity windowed scan" if windowed
              else "vectorized: constant-capacity column scans")
    return SimReport(mb_complete=mb_complete, t_start=t_start, b=b,
                     num_microbatches=Q, resource_busy=busy,
                     policy=policy.name, engine="vectorized",
                     engine_reason=reason,
                     timeline=Timeline(table=table, starts=starts, ends=ends))


def _report_from_matrices(table: VisitTable, starts: torch.Tensor,
                          ends: torch.Tensor, Q: int, policy: AdmissionPolicy,
                          t_start: float, b: int, reason: str) -> SimReport:
    """Assemble a report from dense (Q, R) start/end matrices.  Busy
    fractions are summed per resource (reentrant tables visit a resource
    several times per micro-batch)."""
    mb_complete = ends[:, -1].clone()
    span = float(mb_complete[-1]) - t_start if Q else 0.0
    service = (ends - starts).sum(dim=0).tolist()
    busy = busy_fractions(accumulate_service(table.resources, service), span)
    return SimReport(mb_complete=mb_complete, t_start=t_start, b=b,
                     num_microbatches=Q, resource_busy=busy,
                     policy=policy.name, engine="vectorized",
                     engine_reason=reason,
                     timeline=Timeline(table=table, starts=starts, ends=ends))


def _run_vectorized(table: VisitTable, serves, Q: int,
                    policy: AdmissionPolicy, t_start: float,
                    b: int, device) -> SimReport | None:
    """Dispatch one eligible instance to the right kernel.  Returns ``None``
    only when the reentrant fixpoint failed to converge (the caller decides
    between event-engine fallback and raising)."""
    S = table.num_stages
    windows = [policy.window(S, j) for j in range(S)]
    windowed = any(w is not None for w in windows)
    if not table.is_reentrant():
        if all(s.const_d is not None for s in serves):
            d = np.array([s.const_d for s in serves])
            return _vectorized_run(table, d, Q, policy, t_start, b, device)
        if not windowed:
            starts, ends = fifo_pass(serves, Q, t_start, device=device)
            reason = "vectorized: segmented trace column scans"
        else:
            starts, ends = windowed_pass(serves, table, windows, Q, t_start,
                                         device=device)
            reason = "vectorized: trace micro-batch-major scan"
        return _report_from_matrices(table, starts, ends, Q, policy, t_start,
                                     b, reason)
    got = fixpoint_advance(table, serves, windows, Q, t_start, device=device)
    if got is None:
        return None
    starts, ends, sweeps = got
    obs_inc("sim.fixpoint_runs")
    obs_inc("sim.fixpoint_sweeps", sweeps)
    return _report_from_matrices(
        table, starts, ends, Q, policy, t_start, b,
        f"vectorized: reentrant merged-scan fixpoint ({sweeps} sweeps)")


def simulate_plan(profile: ModelProfile, net: EdgeNetwork,
                  sol: SplitSolution, b: int, *, B: int | None = None,
                  num_microbatches: int | None = None,
                  scenario: NetworkScenario | None = None,
                  t_start: float = 0.0,
                  policy: AdmissionPolicy | str = "fifo",
                  engine: str = "event", device="cuda") -> SimReport:
    """Simulate ``sol`` end to end and report the timeline.

    Give either ``B`` (mini-batch size: ``1 + ceil((B-b)/b)`` full-size
    micro-batches, the paper's Eq. (14) accounting) or an explicit
    ``num_microbatches``.  ``policy`` selects micro-batch admission ("fifo"
    is the GPipe-like behavior, "1f1b" the fixed-depth schedule,
    "memory" the ``Node.mem``-derived windows); plan-dependent policies are
    bound to ``(profile, net, sol, b)`` here, and a plan whose budget cannot
    hold even one live micro-batch is refused with ``ValueError``.
    ``engine`` picks the executor: "event" (default; exact everywhere,
    bit-identical FIFO timelines), "vectorized" (heap-free batched
    advancement — constant *and* piecewise-constant traces, distinct *and*
    reentrant placements; raises naming the violated precondition when it
    cannot run the instance — see :func:`vectorizable`), or "auto"
    (vectorized whenever it covers the instance, event otherwise).  The
    report's ``engine_reason`` records which kernel ran, or why the event
    engine was selected.  ``device`` (``"cuda"`` by default; raises without
    a GPU unless ``"cpu"``) holds the vectorized scans and the report's
    tensors.
    """
    dev = resolve_device(device)
    with obs_span("sim.simulate_plan", engine=engine):
        rep = _simulate_plan(profile, net, sol, b, B=B,
                             num_microbatches=num_microbatches,
                             scenario=scenario, t_start=t_start,
                             policy=policy, engine=engine, device=dev)
    obs_inc("sim.dispatch." + rep.engine)
    obs_inc("sim.engine_reason[" + rep.engine_reason.split(" (")[0] + "]")
    return rep


def _simulate_plan(profile: ModelProfile, net: EdgeNetwork,
                   sol: SplitSolution, b: int, *, B: int | None = None,
                   num_microbatches: int | None = None,
                   scenario: NetworkScenario | None = None,
                   t_start: float = 0.0,
                   policy: AdmissionPolicy | str = "fifo",
                   engine: str = "event", device=None) -> SimReport:
    if num_microbatches is None:
        if B is None:
            raise ValueError("pass B or num_microbatches")
        num_microbatches = 1 + num_fills(B, b)
    if engine not in ("event", "vectorized", "auto"):
        raise ValueError(f"unknown engine {engine!r}: "
                         "expected 'event', 'vectorized' or 'auto'")
    pol = resolve_policy(policy).bind(profile, net, sol, b)
    if not pol.schedulable():
        raise ValueError(
            f"plan is memory-infeasible under the {pol.name!r} admission "
            f"policy at b={b}: some stage cannot hold even one live "
            "micro-batch within its node's memory budget")
    event_reason = "event: requested"
    if engine in ("vectorized", "auto"):
        table = build_visit_table(profile, net, sol, b)
        serves, why = _serve_models(table, net, scenario)
        if why is None:
            if num_microbatches == 0:
                return _empty_report(table, pol, t_start, b,
                                     "vectorized: empty run", device)
            rep = _run_vectorized(table, serves, num_microbatches, pol,
                                  t_start, b, device)
            if rep is not None:
                return rep
            why = ("reentrant merged-scan fixpoint did not converge "
                   "on this instance")
        if engine == "vectorized":
            raise ValueError(
                f"vectorized engine cannot run this instance: {why}; "
                "use engine='auto' or 'event'")
        event_reason = f"event: {why}"
    tasks = build_tasks(profile, net, sol, b, num_microbatches)
    rep = PipelineSimulator(net, tasks, b=b, scenario=scenario,
                            t_start=t_start, policy=pol,
                            device=device).run()
    rep.engine_reason = event_reason
    return rep


def simulate_plans(profile: ModelProfile, net: EdgeNetwork, plans, *,
                   B: int | None = None,
                   num_microbatches: list | None = None,
                   scenario: NetworkScenario | None = None,
                   t_start: float = 0.0,
                   policy: AdmissionPolicy | str = "fifo",
                   engine: str = "auto", device="cuda") -> list:
    """Batched :func:`simulate_plan` over many candidate plans.

    ``plans`` is a sequence of ``(sol, b)`` pairs sharing one mini-batch
    ``B`` (or explicit per-plan ``num_microbatches``); the return is the
    list of :class:`SimReport`, one per plan, identical to looping
    ``simulate_plan`` — that identity is asserted in tests.  Plans whose
    instance is constant-capacity and non-reentrant are *stacked along a
    leading plan axis* through :func:`~repro_torch.sim.advance.stacked_fifo`
    / :func:`~repro_torch.sim.advance.stacked_windowed` (one set of scans on
    ``device`` for the whole group); reentrant or traced plans sharing one
    visit structure go through the stacked merged-scan fixpoint; everything
    else — event-engine fallbacks, single plans — runs per plan.  Stacked
    reports carry ``timeline=None`` (completion times only): they exist to
    score candidates, not to be inspected.
    """
    plans = list(plans)
    dev = resolve_device(device)
    with obs_span("sim.simulate_plans", n=len(plans)):
        reports = _simulate_plans(profile, net, plans, B=B,
                                  num_microbatches=num_microbatches,
                                  scenario=scenario, t_start=t_start,
                                  policy=policy, engine=engine, device=dev)
    for rep in reports:
        obs_inc("sim.dispatch." + rep.engine)
        obs_inc("sim.engine_reason[" + rep.engine_reason.split(" (")[0] + "]")
    return reports


def _simulate_plans(profile: ModelProfile, net: EdgeNetwork, plans, *,
                    B: int | None = None,
                    num_microbatches: list | None = None,
                    scenario: NetworkScenario | None = None,
                    t_start: float = 0.0,
                    policy: AdmissionPolicy | str = "fifo",
                    engine: str = "auto", device=None) -> list:
    plans = list(plans)
    if num_microbatches is None:
        if B is None:
            raise ValueError("pass B or num_microbatches")
        qs = [1 + num_fills(B, b) for _, b in plans]
    else:
        qs = list(num_microbatches)
        if len(qs) != len(plans):
            raise ValueError("num_microbatches must align with plans")
    base_pol = resolve_policy(policy)
    bound = base_pol.bind_many(profile, net, plans)
    preps = []
    for (sol, b), Q, pol in zip(plans, qs, bound):
        if not pol.schedulable():
            raise ValueError(
                f"plan is memory-infeasible under the {pol.name!r} "
                f"admission policy at b={b}")
        table = build_visit_table(profile, net, sol, b)
        serves, why = _serve_models(table, net, scenario)
        windows = [pol.window(table.num_stages, j)
                   for j in range(table.num_stages)]
        stackable = (engine in ("auto", "vectorized") and why is None
                     and Q > 0 and not table.is_reentrant()
                     and all(s.const_d is not None for s in serves))
        preps.append((sol, b, Q, pol, table, serves, windows, stackable,
                      why))

    reports: list = [None] * len(plans)
    # reentrant / traced plans sharing one visit structure: the stacked
    # merged-scan fixpoint advances the whole group at once
    fix_grps: dict = {}
    for i, p in enumerate(preps):
        sol, b, Q, pol, table, serves, windows, stackable, why = p
        if (engine in ("auto", "vectorized") and not stackable and Q > 0
                and why is None and stack_eligible(serves)):
            fix_grps.setdefault(table.resources, []).append(i)
    for grp in fix_grps.values():
        if len(grp) < 2:
            continue
        i0 = grp[0]
        got = stacked_fixpoint(preps[i0][4],
                               [preps[i][5] for i in grp],
                               [preps[i][6] for i in grp],
                               [preps[i][2] for i in grp], t_start,
                               device=device)
        if got is None:
            continue                 # per-plan fallback below
        for g, i in enumerate(grp):
            sol, b, Q, pol = preps[i][:4]
            reports[i] = SimReport(
                mb_complete=got[g], t_start=t_start, b=b,
                num_microbatches=Q, resource_busy={}, policy=pol.name,
                engine="vectorized",
                engine_reason=(f"vectorized: stacked merged-scan fixpoint "
                               f"({len(grp)} plans)"))
    fifo_grp = [i for i, p in enumerate(preps)
                if p[7] and all(w is None for w in p[6])]
    win_grp = [i for i, p in enumerate(preps)
               if p[7] and not all(w is None for w in p[6])]
    for grp, kind in ((fifo_grp, "fifo"), (win_grp, "windowed")):
        if len(grp) < 2:
            continue                     # single plans keep the full report
        Qm = max(preps[i][2] for i in grp)
        Rm = max(len(preps[i][4]) for i in grp)
        ds = np.zeros((len(grp), Rm))
        for g, i in enumerate(grp):
            serves = preps[i][5]
            ds[g, :len(serves)] = [s.const_d for s in serves]
        if kind == "fifo":
            last = stacked_fifo(ds, Qm, t_start, device=device)
        else:
            p_idx, fp_v, bp_v, w_v = [], [], [], []
            for g, i in enumerate(grp):
                table, windows = preps[i][4], preps[i][6]
                for j, w in enumerate(windows):
                    if w is not None:
                        p_idx.append(g)
                        fp_v.append(int(table.fp_visit[j]))
                        bp_v.append(int(table.bp_visit[j]))
                        w_v.append(int(w))
            fb = tuple(np.asarray(a, dtype=np.intp)
                       for a in (p_idx, fp_v, bp_v, w_v))
            last = stacked_windowed(ds, fb, Qm, t_start, device=device)
        for g, i in enumerate(grp):
            sol, b, Q, pol = preps[i][:4]
            reports[i] = SimReport(
                mb_complete=last[g, :Q].clone(), t_start=t_start, b=b,
                num_microbatches=Q, resource_busy={}, policy=pol.name,
                engine="vectorized",
                engine_reason=(f"vectorized: stacked plan axis "
                               f"({len(grp)} plans, {kind})"))
    # everything left runs per plan, reusing the prepped table / serve
    # models / bound policy (mirroring simulate_plan's dispatch without
    # paying the construction again)
    for i, p in enumerate(preps):
        if reports[i] is not None:
            continue
        sol, b, Q, pol, table, serves, windows, stackable, why = p
        event_reason = "event: requested"
        if engine in ("vectorized", "auto") and why is None:
            if Q == 0:
                reports[i] = _empty_report(table, pol, t_start, b,
                                           "vectorized: empty run", device)
                continue
            rep = _run_vectorized(table, serves, Q, pol, t_start, b, device)
            if rep is not None:
                reports[i] = rep
                continue
            why = ("reentrant merged-scan fixpoint did not converge "
                   "on this instance")
        if engine == "vectorized":
            raise ValueError(
                f"vectorized engine cannot run this instance: {why}; "
                "use engine='auto' or 'event'")
        if engine != "event":
            event_reason = f"event: {why}"
        tasks = build_tasks(profile, net, sol, b, Q)
        rep = PipelineSimulator(net, tasks, b=b, scenario=scenario,
                                t_start=t_start, policy=pol,
                                device=device).run()
        rep.engine_reason = event_reason
        reports[i] = rep
    return reports


# ---------------------------------------------------------------------------
# Replanning: ft.Coordinator on simulated time
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SegmentReport:
    """One inter-trigger stretch of the replanned run."""
    plan: object                 # the core.Plan in force during the segment
    report: SimReport            # full hypothetical run of the segment
    completed: int               # micro-batches banked before the cutoff
    cutoff: float                # absolute time the segment ended
    trigger: object | None       # ReplanTrigger that ended it (None = drain)
    outcome: object | None       # ft.ReplanOutcome for that trigger


@dataclasses.dataclass
class ReplanSimReport:
    makespan: float              # absolute time the mini-batch drains
    segments: list               # SegmentReport
    coordinator: object          # the driven ft.Coordinator (holds outcomes)
    suppressed: list = dataclasses.field(default_factory=list)
    #                            # (trigger, outcome) pairs the policy
    #                            # absorbed without cutting the segment
    downtime: float = 0.0        # total remap + solve + restore charged

    @property
    def outcomes(self) -> list:
        """Every ``ReplanOutcome`` delivered during the run, in order."""
        out = [s.outcome for s in self.segments if s.outcome is not None]
        out += [o for _, o in self.suppressed]
        out.sort(key=lambda o: (o.sim_time is None,
                                0.0 if o.sim_time is None else o.sim_time))
        return out

    @property
    def num_replans(self) -> int:
        """Replans actually *issued* (full or micro-batch re-solve) —
        absorbed/suppressed events don't count."""
        return sum(1 for o in self.outcomes
                   if o.action in ("replan", "microbatch"))

    @property
    def num_suppressed(self) -> int:
        """Events the policy absorbed (no solve, no pipeline restart)."""
        return sum(1 for o in self.outcomes if o.action == "absorb")


def simulate_with_replanning(profile: ModelProfile, net: EdgeNetwork, B: int,
                             triggers=(), *, coordinator=None,
                             scenario: NetworkScenario | None = None,
                             remap_penalty: float = 0.0,
                             solve_downtime: float | str = 0.0,
                             policy: AdmissionPolicy | str = "fifo",
                             engine: str = "event", device="cuda",
                             **coordinator_kwargs) -> ReplanSimReport:
    """Execute a mini-batch of ``B`` samples while ``ReplanTrigger``s fire
    at simulated times.  Triggers come from the ``triggers`` argument and/or
    ``scenario.replan_triggers`` (composed via ``with_replan``); both are
    merged and fired in time order.

    Each trigger's event is **delivered** to the coordinator
    (``Coordinator.deliver``), whose replan policy (``ft.policy``; eager
    when none) either replans or *absorbs* it.  For an adopted replan:
    micro-batches fully drained by then are banked, in-flight ones are discarded (they re-run after the remap), and the
    remaining samples resume at ``trigger.time + remap_penalty +
    solve_downtime + outcome.restore_seconds`` under the new plan — a
    ``NodeFailure`` additionally pays the checkpoint-restore charge the
    coordinator's ``restore_cost`` prices, since resuming after a lost
    server means reloading params from the latest checkpoint.
    ``solve_downtime`` is the per-replan solver stall: a float (seconds),
    or ``"wall"`` to charge the measured ``outcome.solve_seconds``.  An
    *absorbed* event that still mutated the network (a rate change ridden
    out) cuts the segment at the trigger time with **zero** downtime — the
    capacity change takes hold, the incumbent plan keeps running — while an
    absorbed no-op (a suppressed ``Resync``: any delivery that changed
    neither the coordinator's network nor its plan) does not cut at all:
    the event lands in ``ReplanSimReport.suppressed`` and the in-flight
    segment keeps streaming.  The physical effect of each event (slower
    node, changed rate, lost server) takes hold from its trigger time via
    the coordinator's mutated network.

    ``policy``/``engine``/``device`` are forwarded to each segment's
    ``simulate_plan`` (``policy`` here is the *admission* policy —
    FIFO/1F1B/memory — not the replan policy); ``device`` also builds the
    coordinator (``"cuda"``: its replans launch the min-plus kernel).  A
    replan policy reaches the run through a pre-built ``coordinator``.

    ``scenario`` capacity traces are keyed by node/link index; a
    ``NodeFailure`` renumbers the network's indices, so combining the two
    would silently apply traces to the wrong nodes — that combination is
    rejected.
    """
    from ..ft.coordinator import Coordinator, NodeFailure  # ft imports core

    dev = resolve_device(device)
    coord = coordinator or Coordinator(profile, net, B, device=dev,
                                       **coordinator_kwargs)
    all_triggers = tuple(triggers)
    if scenario is not None:
        all_triggers += tuple(scenario.replan_triggers)
        if any(isinstance(tr.event, NodeFailure) for tr in all_triggers):
            raise ValueError(
                "NodeFailure triggers cannot be combined with a capacity "
                "scenario: degraded() renumbers node indices, so the "
                "scenario's index-keyed traces would land on the wrong "
                "nodes/links")
    segments: list = []
    suppressed: list = []
    t = 0.0
    total_downtime = 0.0
    samples_left = B
    cur = None          # in-flight segment's SimReport, memoized across
    #                     suppressed triggers so no-ops don't re-simulate
    for trig in sorted(all_triggers, key=lambda tr: tr.time):
        if samples_left <= 0:
            break
        plan = coord.plan
        if not plan.feasible or plan.b <= 0:
            break
        m = max(1, math.ceil(samples_left / plan.b))
        if cur is None:
            cur = simulate_plan(profile, coord.net, plan.solution, plan.b,
                                num_microbatches=m, scenario=scenario,
                                t_start=t, policy=policy, engine=engine,
                                device=dev)
        rep = cur
        if rep.makespan <= trig.time:
            # drained before the event fired — the run is simply over
            segments.append(SegmentReport(plan, rep, m, rep.makespan,
                                          None, None))
            return ReplanSimReport(rep.makespan, segments, coord,
                                   suppressed, total_downtime)
        prev_net, prev_plan = coord.net, coord.plan
        outcome = coord.deliver(trig.event, sim_time=trig.time)
        if coord.net is prev_net and coord.plan is prev_plan:
            # pure suppression: nothing the simulation sees changed — the
            # in-flight segment keeps streaming, no cut, no downtime
            suppressed.append((trig, outcome))
            continue
        cur = None
        done = int(torch.searchsorted(
            rep.mb_complete,
            torch.tensor([trig.time], dtype=F64, device=dev), right=True))
        samples_left = max(0, samples_left - done * plan.b)
        segments.append(SegmentReport(plan, rep, done, trig.time, trig,
                                      outcome))
        if outcome.action in ("replan", "microbatch"):
            solve_dt = (outcome.solve_seconds if solve_downtime == "wall"
                        else float(solve_downtime))
            dt = remap_penalty + solve_dt + outcome.restore_seconds
        else:
            dt = 0.0    # absorbed: no restart, no solve stall
        total_downtime += dt
        t = trig.time + dt
    if samples_left > 0:
        plan = coord.plan
        if plan.feasible and plan.b > 0:
            m = max(1, math.ceil(samples_left / plan.b))
            if cur is None:
                cur = simulate_plan(profile, coord.net, plan.solution,
                                    plan.b, num_microbatches=m,
                                    scenario=scenario, t_start=t,
                                    policy=policy, engine=engine,
                                    device=dev)
            segments.append(SegmentReport(plan, cur, m, cur.makespan,
                                          None, None))
            t = cur.makespan
        else:
            t = math.inf
    return ReplanSimReport(t, segments, coord, suppressed, total_downtime)
