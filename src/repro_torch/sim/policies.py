"""Pluggable micro-batch admission policies for the pipeline simulator —
the port of ``repro/sim/policies.py``.

An :class:`AdmissionPolicy` assigns each pipeline stage an *admission
window* — the number of micro-batches allowed past that stage's forward
pass before the stage's own backward pass reclaims an activation.  Windows
become precedence edges

    BP_j(m - window(j))  -->  FP_j(m)

added on top of the per-micro-batch chains, so both the heap engine and the
vectorized engine execute any policy without special cases.

Three concrete policies ship:

* :class:`FIFO` — unbounded windows (GPipe-like; no extra edges, the event
  loop is untouched).  Activation high-water claim: ``Q`` per stage.
* :class:`OneFOneB` — window ``S - j`` at stage ``j`` of an ``S``-stage
  pipeline (1F1B).  Claim: ``min(Q, S - j)``.
* :class:`MemoryBudgeted` — windows derived from each node's memory budget
  (``Node.mem`` vs the Eq. (11) activation profile); must be *bound* to a
  concrete plan first (``simulate_plan`` binds automatically via
  :meth:`AdmissionPolicy.bind`).  Claim: ``min(Q, floor((mem_n -
  static_n) / act_n))`` per stage on node n
  (``core.cost_model.node_budget_windows``).

The closed-form claims (:meth:`AdmissionPolicy.stage_capacity`) are the
source ``pipeline.schedule.memory_highwater`` reads, and they bound the
engine's measured occupancy (:func:`activation_occupancy`) event by event.

>>> OneFOneB().stage_capacity(4, 8)
{0: 4, 1: 3, 2: 2, 3: 1}
>>> FIFO().stage_capacity(3, 8)
{0: 8, 1: 8, 2: 8}
"""

from __future__ import annotations


class AdmissionPolicy:
    """Strategy deciding when a micro-batch may enter each pipeline stage.

    Subclasses implement :meth:`window`.  A window of ``w`` at stage ``j``
    means micro-batch ``m``'s forward pass at ``j`` must wait for micro-batch
    ``m - w``'s backward pass at ``j`` — which bounds stage ``j``'s live
    activations by ``w``.  ``None`` means unbounded (no edge).  Stages are
    numbered by *position* ``j`` in the chain of non-empty submodels
    (``0 .. S-1``), not by raw submodel index.
    """

    name = "abstract"

    def window(self, num_stages: int, stage: int) -> int | None:
        raise NotImplementedError

    # -- plan binding -------------------------------------------------------
    def bind(self, profile, net, sol, b) -> "AdmissionPolicy":
        """Specialize the policy to a concrete plan.

        Stateless policies (FIFO, 1F1B) return ``self``; plan-dependent ones
        (:class:`MemoryBudgeted`) return a bound copy whose windows are
        derived from the instance.  ``simulate_plan`` calls this before
        execution, so callers can pass unbound policies everywhere.
        """
        return self

    def bind_many(self, profile, net, plans) -> list:
        """:meth:`bind` for many ``(sol, b)`` plans at once.  Plan-dependent
        policies override this with a batched derivation (one claims pass
        per distinct split instead of one per candidate) —
        ``simulate_plans``' binding hot path."""
        return [self.bind(profile, net, sol, b) for sol, b in plans]

    def schedulable(self) -> bool:
        """False when some window is 0 — admitting even one micro-batch
        would exceed a budget, so execution must be refused (a 0-window
        edge set would deadlock the pipeline)."""
        return True

    # -- closed-form memory claim -------------------------------------------
    def stage_capacity(self, num_stages: int, num_microbatches: int) -> dict:
        """Claimed activation high-water mark per stage position.

        ``Q`` micro-batches can never exceed ``Q`` live activations, so every
        claim is clipped by ``num_microbatches``.
        """
        out = {}
        for j in range(num_stages):
            w = self.window(num_stages, j)
            out[j] = (num_microbatches if w is None
                      else min(num_microbatches, w))
        return out

    # -- edge generation for the heap engine --------------------------------
    def extra_dependencies(self, tasks) -> list:
        """``(src_tid, dst_tid)`` precedence edges encoding the windows.

        ``tasks`` is the chain task list from ``engine.build_tasks`` (any
        iterable of ``events.Task``); tid order within one micro-batch is
        chain order, so the j-th "fp" task of a micro-batch is stage position
        j and the "bp" tasks appear in reverse position order.
        """
        fp_by_mb: dict = {}
        bp_by_mb: dict = {}
        for t in sorted(tasks, key=lambda t: t.tid):
            if t.kind == "fp":
                fp_by_mb.setdefault(t.microbatch, []).append(t.tid)
            elif t.kind == "bp":
                bp_by_mb.setdefault(t.microbatch, []).append(t.tid)
        if not fp_by_mb:
            return []
        S = len(fp_by_mb[min(fp_by_mb)])
        windows = [self.window(S, j) for j in range(S)]
        edges = []
        for m, fps in fp_by_mb.items():
            for j, w in enumerate(windows):
                if w is None or m - w < 0:
                    continue
                # bp tasks run positions S-1 .. 0, so position j is entry
                # S-1-j of the earlier micro-batch's bp list
                src = bp_by_mb[m - w][S - 1 - j]
                edges.append((src, fps[j]))
        return edges


class FIFO(AdmissionPolicy):
    """GPipe-like admission: every micro-batch is admitted immediately;
    stages buffer up to ``Q`` activations."""

    name = "fifo"

    def window(self, num_stages: int, stage: int) -> int | None:
        return None


class OneFOneB(AdmissionPolicy):
    """1F1B admission: stage ``j`` of ``S`` holds at most ``S - j``
    activations — the memory-aware schedule of PipeDream/1F1B, matching the
    claim reported by ``pipeline.schedule``."""

    name = "1f1b"

    def window(self, num_stages: int, stage: int) -> int | None:
        return num_stages - stage


class MemoryBudgeted(AdmissionPolicy):
    """Admission windows derived from node memory budgets.

    Instead of 1F1B's fixed ``S - j`` depths, stage ``j`` on node ``n`` gets
    the largest window ``w`` whose live activations actually fit:
    ``static_n + w * act_n <= mem_n`` with the static/activation split of
    Eq. (11) (``core.cost_model.node_budget_windows`` — the claims
    source shared with ``pipeline.schedule.memory_highwater`` and the
    planner's feasible-b box).  Co-located stages share their node's budget
    and therefore its window.

    The windows depend on ``(profile, net, sol, b)``, so the policy must be
    *bound* before use; ``simulate_plan`` binds automatically:

    >>> import numpy as np
    >>> from repro_torch.core import (EdgeNetwork, Node, SplitSolution,
    ...                               uniform_profile)
    >>> prof = uniform_profile(4, fp=1.0, bp=1.0, act=1.0, param=1.0)
    >>> nodes = [Node("c", f=1.0, is_client=True, mem=100.0),
    ...          Node("s", f=1.0, mem=14.0)]
    >>> net = EdgeNetwork(nodes=nodes, rate=np.full((2, 2), 10.0),
    ...                   num_clients=1)
    >>> sol = SplitSolution(cuts=(2, 4), placement=(0, 1))
    >>> pol = MemoryBudgeted().bind(prof, net, sol, b=1)
    >>> pol.window(2, 1)        # server: (14 - 4 static) // (2*2 act) = 2
    2
    >>> pol.stage_capacity(2, 8)[1]
    2
    """

    name = "memory"

    def __init__(self, memory_model: str = "refined", tail=None):
        self.memory_model = memory_model
        self.tail = tail             # core.cost_model.DegradedTail or None:
        #                              windows sized for the degraded tail
        self._windows: tuple | None = None

    @property
    def bound(self) -> bool:
        return self._windows is not None

    def bind(self, profile, net, sol, b) -> "MemoryBudgeted":
        from ..core.cost_model import node_budget_windows
        pol = MemoryBudgeted(self.memory_model, self.tail)
        pol._windows = tuple(node_budget_windows(profile, net, sol, b,
                                                 self.memory_model,
                                                 self.tail))
        return pol

    def bind_many(self, profile, net, plans) -> list:
        """Batched :meth:`bind`: one Eq. (11) claims pass per distinct
        split serves every micro-batch size
        (``cost_model.node_budget_windows_many``) — identical windows to
        one-at-a-time binding."""
        from ..core.cost_model import node_budget_windows_many
        by_sol: dict = {}
        for i, (sol, b) in enumerate(plans):
            by_sol.setdefault((sol.cuts, sol.placement), []).append(i)
        out: list = [None] * len(plans)
        for idxs in by_sol.values():
            sol = plans[idxs[0]][0]
            wss = node_budget_windows_many(profile, net, sol,
                                           [plans[i][1] for i in idxs],
                                           self.memory_model, self.tail)
            for i, ws in zip(idxs, wss):
                pol = MemoryBudgeted(self.memory_model, self.tail)
                pol._windows = tuple(ws)
                out[i] = pol
        return out

    def schedulable(self) -> bool:
        if self._windows is None:
            return True
        return all(w is None or w >= 1 for w in self._windows)

    def window(self, num_stages: int, stage: int) -> int | None:
        if self._windows is None:
            raise RuntimeError(
                "MemoryBudgeted is plan-dependent: call "
                ".bind(profile, net, sol, b) first (simulate_plan binds "
                "automatically)")
        if num_stages != len(self._windows):
            raise ValueError(
                f"policy bound for {len(self._windows)} stages, asked about "
                f"a {num_stages}-stage pipeline")
        return self._windows[stage]


_POLICIES = {"fifo": FIFO, "gpipe": FIFO, "1f1b": OneFOneB,
             "memory": MemoryBudgeted, "memory_budgeted": MemoryBudgeted}


def resolve_policy(policy) -> AdmissionPolicy:
    """Accept a policy instance or one of the registered names
    (``"fifo"``/``"gpipe"``/``"1f1b"``)."""
    if isinstance(policy, AdmissionPolicy):
        return policy
    try:
        return _POLICIES[str(policy).lower()]()
    except KeyError:
        raise ValueError(
            f"unknown admission policy {policy!r}; expected one of "
            f"{sorted(_POLICIES)} or an AdmissionPolicy instance") from None


# ---------------------------------------------------------------------------
# Measured activation occupancy (the engine side of the cross-validation)
# ---------------------------------------------------------------------------

def activation_occupancy(records) -> dict:
    """Per-stage time series of live activations, from a simulated timeline.

    A micro-batch's activation at stage position ``j`` is *live* from the
    start of its forward pass at ``j`` to the end of its backward pass at
    ``j``.  Returns ``{position: [(time, occupancy_after_event), ...]}`` with
    events in time order; releases are processed before acquisitions at equal
    times (the window edges allow a forward to start the instant the paired
    backward frees its slot).
    """
    fp_start: dict = {}
    bp_end: dict = {}
    stages = set()
    for r in records:
        if r.kind == "fp":
            fp_start[(r.stage, r.microbatch)] = r.start
            stages.add(r.stage)
        elif r.kind == "bp":
            bp_end[(r.stage, r.microbatch)] = r.end
    out = {}
    for j, stage in enumerate(sorted(stages)):
        events = []
        for (s, m), t in fp_start.items():
            if s == stage:
                events.append((t, 1, +1))
                events.append((bp_end[(s, m)], 0, -1))
        events.sort()
        series, occ = [], 0
        for t, _, delta in events:
            occ += delta
            series.append((t, occ))
        out[j] = series
    return out


def stage_activation_highwater(records) -> dict:
    """Measured activation high-water mark per stage position — the quantity
    the closed-form :meth:`AdmissionPolicy.stage_capacity` claims bound.

    >>> from repro_torch.sim.events import TraceRecord
    >>> recs = [TraceRecord(m, 0, "fp", ("fp", 0), m, m + 1) for m in (0, 1)]
    >>> recs += [TraceRecord(m, 0, "bp", ("bp", 0), 3 + m, 4 + m) for m in (0, 1)]
    >>> stage_activation_highwater(recs)
    {0: 2}
    """
    return {j: max((occ for _, occ in series), default=0)
            for j, series in activation_occupancy(records).items()}
