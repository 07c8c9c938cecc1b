"""Per-resource busy/idle/blocked interval decomposition.

The port of ``repro/obs/utilization.py``.  Every resource's occupancy
intervals decompose, over the horizon ``[t_start, makespan]``, as

    span    = makespan - t_start
    service = total occupancy            = busy + blocked
    idle    = span - service             = fill + bubble + drain
    fill    = first_start - t_start      (pipeline fill, the Eq. (12) ramp)
    drain   = makespan - last_end        (pipeline drain)
    bubble  = inter-occupancy gaps       (steady-state holes, Eq. (13))
    blocked = zero-capacity time inside occupancy (trace outages)

Reports are made from both engines' output —
:func:`utilization_from_records` (the heap engine's ``TraceRecord`` lists)
and :func:`utilization_from_timeline` (the vectorized engine's dense
``Timeline``, whose tensors may live on the GPU: they come to the host
once, here) — and share one decomposition, which runs in host numpy in the
reference's operation order, so a report equals the reference's for equal
intervals.  Duck-typed against ``sim``; imports
nothing from it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: canonical resource ordering (mirrors ``sim.events.KINDS``)
_KIND_ORDER = {"fp": 0, "fwd": 1, "bp": 2, "bwd": 3}


def resource_sort_key(resource: tuple):
    """Canonical per-resource sort key — node engines first, then links,
    in the fixed kind order both report constructors use."""
    return (_KIND_ORDER[resource[0]], resource[1:])


# ---------------------------------------------------------------------------
# shared busy accumulation (one fold for both engines)
# ---------------------------------------------------------------------------

def accumulate_service(resources, per_visit) -> dict:
    """Fold per-visit service totals into per-resource totals, in visit
    (chain) order.  This is the one summation every ``SimReport.resource_busy``
    site goes through, so the engines can no longer drift apart in how the
    occupancy of a co-located (reentrant) resource is accumulated."""
    out: dict = {}
    for v, res in enumerate(resources):
        out[res] = out.get(res, 0.0) + float(per_visit[v])
    return out


def busy_fractions(service_by_resource: dict, span: float) -> dict:
    """``service / span`` per resource (all zeros on an empty horizon)."""
    if span > 0:
        return {res: t / span for res, t in service_by_resource.items()}
    return {res: 0.0 for res in service_by_resource}


def service_from_records(records) -> dict:
    """Per-resource occupancy seconds from eager ``TraceRecord``s.

    Durations are grouped per (resource, kind, stage) visit stream and
    summed with ``np.sum`` in micro-batch order, then folded across
    streams — matching the vectorized engine's per-visit column sums so
    identical schedules produce identical ``resource_busy`` values.
    """
    streams: dict = {}
    order: list = []
    for r in records:
        key = (r.resource, r.kind, r.stage)
        got = streams.get(key)
        if got is None:
            streams[key] = got = []
            order.append(key)
        got.append(r.end - r.start)
    out: dict = {}
    for key in order:
        res = key[0]
        out[res] = out.get(res, 0.0) + float(np.sum(np.asarray(streams[key])))
    return out


# ---------------------------------------------------------------------------
# interval decomposition
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResourceUtilization:
    """One resource's interval decomposition over ``[t_start, makespan]``."""
    resource: tuple
    busy: float          # serving with capacity > 0
    blocked: float       # occupied but at zero capacity (trace outage)
    fill: float          # t_start .. first occupancy start
    bubble: float        # inter-occupancy gaps (steady-state idleness)
    drain: float         # last occupancy end .. makespan
    num_tasks: int
    first_start: float
    last_end: float

    @property
    def service(self) -> float:
        """Total occupancy (``busy + blocked``)."""
        return self.busy + self.blocked

    @property
    def idle(self) -> float:
        """Unoccupied time (``fill + bubble + drain``)."""
        return self.fill + self.bubble + self.drain


@dataclasses.dataclass(frozen=True)
class UtilizationReport:
    """Per-resource decomposition plus whole-pipeline rollups.

    ``resources`` maps resource keys (see ``sim.events``) to
    :class:`ResourceUtilization`, in canonical order.  Fractions are of
    the run horizon ``span = makespan - t_start``; pipeline-level
    fractions average over all resources, i.e. they are shares of the
    total resource-time ``len(resources) * span``.
    """
    t_start: float
    makespan: float
    resources: dict

    @property
    def span(self) -> float:
        return self.makespan - self.t_start

    # -- per-resource fractions ---------------------------------------------
    def busy_fraction(self, resource) -> float:
        ru = self.resources[resource]
        return ru.busy / self.span if self.span > 0 else 0.0

    def idle_fraction(self, resource) -> float:
        ru = self.resources[resource]
        return ru.idle / self.span if self.span > 0 else 0.0

    def service_fractions(self) -> dict:
        """``resource -> occupancy/span`` — reconciles with
        ``SimReport.resource_busy`` (same intervals, same horizon)."""
        return busy_fractions(
            {res: ru.service for res, ru in self.resources.items()},
            self.span)

    # -- pipeline-level rollups ---------------------------------------------
    def _total(self, attr: str) -> float:
        return sum(getattr(ru, attr) for ru in self.resources.values())

    def _fraction(self, total: float) -> float:
        denom = self.span * len(self.resources)
        return total / denom if denom > 0 else 0.0

    @property
    def idle_fraction_total(self) -> float:
        """Share of total resource-time spent unoccupied."""
        return self._fraction(self._total("idle"))

    @property
    def bubble_fraction(self) -> float:
        """Share of total resource-time lost to steady-state bubbles."""
        return self._fraction(self._total("bubble"))

    @property
    def fill_drain_fraction(self) -> float:
        """Share of total resource-time spent in pipeline fill/drain —
        the ramp phases Eq. (12)/(14) charge once per fill ``xi``."""
        return self._fraction(self._total("fill") + self._total("drain"))

    @property
    def blocked_fraction_total(self) -> float:
        """Share of total resource-time spent *blocked* — tasks occupying a
        resource through a zero-capacity scenario window (an outage holding
        work hostage, as opposed to the schedule-shaped idle of
        ``bubble``/``fill``/``drain``).  Nonzero only when the report was
        built with scenario ``traces``."""
        return self._fraction(self._total("blocked"))

    def blocked_by_resource(self) -> dict:
        """Per-resource blocked seconds, worst first — the attribution a
        robustness report uses to say *where* a failure distribution bites
        (``sim.robustness.RobustnessReport.top_blocked``)."""
        items = [(res, ru.blocked) for res, ru in self.resources.items()
                 if ru.blocked > 0.0]
        return dict(sorted(items, key=lambda kv: -kv[1]))

    def node_idle_fraction(self) -> dict:
        """Idle fraction per node (its fp + bp engines pooled)."""
        return self._group_idle(
            lambda res: res[1] if res[0] in ("fp", "bp") else None)

    def link_idle_fraction(self) -> dict:
        """Idle fraction per directed link (fwd/bwd transfer resources
        pooled by their ``(from, to)`` node pair)."""
        return self._group_idle(
            lambda res: (res[1], res[2]) if res[0] in ("fwd", "bwd")
            else None)

    def _group_idle(self, keyfn) -> dict:
        groups: dict = {}
        for res, ru in self.resources.items():
            k = keyfn(res)
            if k is None:
                continue
            tot, n = groups.get(k, (0.0, 0))
            groups[k] = (tot + ru.idle, n + 1)
        if self.span <= 0:
            return {k: 0.0 for k in sorted(groups)}
        return {k: tot / (n * self.span)
                for k, (tot, n) in sorted(groups.items())}


def _blocked_time(trace, starts: np.ndarray, ends: np.ndarray) -> float:
    """Measure of zero-capacity time inside the ``[start, end)`` intervals
    under a piecewise-constant capacity ``trace`` (outage overlap)."""
    t = np.asarray(trace.times_arr, dtype=float)
    zero = (np.asarray(trace.values_arr, dtype=float) == 0.0).astype(float)
    # zcum[i] = zero-capacity measure of [t[0], t[i]); last segment -> inf
    zcum = np.zeros(len(t))
    if len(t) > 1:
        np.cumsum(np.diff(t) * zero[:-1], out=zcum[1:])

    def z(x):
        i = np.clip(np.searchsorted(t, x, side="right") - 1, 0, len(t) - 1)
        return zcum[i] + np.maximum(x - t[i], 0.0) * zero[i]

    return float(np.sum(z(ends) - z(starts)))


def _decompose(resource, starts, ends, t_start, makespan, trace=None):
    """Decompose one resource's occupancy intervals (FIFO — no overlap)."""
    order = np.argsort(starts, kind="stable")
    s = starts[order]
    e = ends[order]
    service = float(np.sum(e - s))
    first = float(s[0])
    last = float(e[-1])
    bubble = float(np.sum(np.maximum(s[1:] - e[:-1], 0.0))) if len(s) > 1 \
        else 0.0
    blocked = 0.0
    if trace is not None and not trace.is_constant():
        blocked = min(_blocked_time(trace, s, e), service)
    return ResourceUtilization(
        resource=resource, busy=service - blocked, blocked=blocked,
        fill=max(first - t_start, 0.0), bubble=bubble,
        drain=max(makespan - last, 0.0), num_tasks=len(s),
        first_start=first, last_end=last)


def utilization_from_records(records, t_start: float = 0.0,
                             makespan: float | None = None, *,
                             traces: dict | None = None) -> UtilizationReport:
    """Build a :class:`UtilizationReport` from eager ``TraceRecord``s
    (the heap event engine's native output)."""
    groups: dict = {}
    for r in records:
        groups.setdefault(r.resource, []).append((r.start, r.end))
    if makespan is None:
        makespan = max((r.end for r in records), default=t_start)
    out: dict = {}
    for res in sorted(groups, key=resource_sort_key):
        arr = np.asarray(groups[res], dtype=float).reshape(-1, 2)
        out[res] = _decompose(
            res, arr[:, 0], arr[:, 1], t_start, makespan,
            trace=None if traces is None else traces.get(res))
    return UtilizationReport(float(t_start), float(makespan), out)


def _host(x) -> np.ndarray:
    """A float64 numpy copy of a tensor (any device) or array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy().astype(float, copy=False)
    return np.asarray(x, dtype=float)


def utilization_from_timeline(timeline, t_start: float = 0.0,
                              makespan: float | None = None, *,
                              traces: dict | None = None) -> UtilizationReport:
    """Build a :class:`UtilizationReport` directly from the vectorized
    engine's dense SoA ``Timeline`` — no ``TraceRecord`` materialization;
    a reentrant resource's occupancy is the union of its visit columns."""
    starts = _host(timeline.starts)
    ends = _host(timeline.ends)
    if makespan is None:
        makespan = float(ends.max()) if ends.size else float(t_start)
    if starts.size == 0:                      # zero-micro-batch run
        return UtilizationReport(float(t_start), float(makespan), {})
    visits = timeline.table.resource_visits()
    out: dict = {}
    for res in sorted(visits, key=resource_sort_key):
        vs = list(visits[res])
        out[res] = _decompose(
            res, starts[:, vs].reshape(-1), ends[:, vs].reshape(-1),
            t_start, makespan,
            trace=None if traces is None else traces.get(res))
    return UtilizationReport(float(t_start), float(makespan), out)


def resource_traces(net, scenario, resources) -> dict:
    """Per-resource capacity traces from a ``NetworkScenario`` — feed as
    ``traces=`` to the report constructors to split occupancy into busy vs blocked
    (only zero-capacity periods matter, so any positive scaling of the
    trace gives the same split)."""
    out: dict = {}
    for res in resources:
        if res[0] in ("fp", "bp"):
            out[res] = scenario.node_trace(net, res[1])
        else:
            out[res] = scenario.link_trace(net, res[1], res[2])
    return out
