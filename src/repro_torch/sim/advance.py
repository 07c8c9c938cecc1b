"""Heap-free advancement kernels for the vectorized engine — the port of
``repro/sim/advance.py``, with the scans on the run's device.

The vectorized engine executes a :class:`~repro_torch.sim.events.VisitTable`
— Q identical micro-batch chains over R visits — without a priority queue.
Start/end times obey max-plus recurrences that collapse into prefix-max
scans, which here are ``torch.cummax`` / ``torch.cumsum`` /
``torch.searchsorted`` over float64 tensors (the reference's
``np.maximum.accumulate`` / ``np.cumsum`` / ``np.searchsorted``):

**Piecewise-constant traces (segmented scans).**  On a FIFO resource a task
of ``work`` units started at ``t`` finishes at ``finish(W(t) + work)``,
where ``W`` is the trace's cumulative-work function and ``finish`` its
inverse.  Back-to-back service therefore chains in work space: with
arrivals ``a[m]`` at a visit of per-micro-batch work ``w``,

    target[m] = max(W(a[m]), target[m-1]) + w
              = (m+1) w + cummax(W(a[m]) - m w)

— the same prefix-max scan as the constant case, run on cumulative work,
with ``ends = finish(target)`` mapping back through the breakpoints.  A
rate-independent ``fixed`` latency breaks the chaining on a varying trace;
those rare columns run the reference's exact scalar sweep on the host.

**Reentrant plans (merged-scan fixpoint).**  When a resource hosts several
visits (co-located submodels), FIFO service interleaves the visit streams
by arrival time.  Per sweep, each resource re-merges its streams by current
arrival estimates (a stable sort), serves the merged sequence with one scan,
and the sweep repeats until the end-time matrix reproduces itself exactly
(one host sync per sweep for that test).

**Stacked plan axis.**  ``stacked_fifo`` / ``stacked_windowed`` /
``stacked_fixpoint`` run many candidate plans at once along a leading plan
axis; visit axes are padded with zero-duration visits, micro-batch axes to
the largest plan.

Only times live on the device.  Everything that depends on the policy and
the table alone — per-visit durations and their prefix sums (``np.cumsum``
on the host, as the reference), window feedback index sets — is computed on
the host and moved once, so a micro-batch-major scan makes no host sync per
micro-batch.  The max-plus arithmetic (``cummax``, ``maximum``, ``+``,
``*``) is exact on any device; the merged scans' ``cumsum`` over
data-dependent orders is the one device scan whose float64 sums can differ
from the CPU's in the last bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["VisitServe", "column_advance", "fifo_pass", "windowed_pass",
           "fixpoint_advance", "stack_eligible", "stacked_fixpoint",
           "stacked_fifo", "stacked_windowed"]

F64 = torch.float64


def _cummax(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cummax(x, dim).values


class VisitServe:
    """Per-visit serving model: when does work started at ``t`` finish.

    ``const_d`` is the total service duration when it does not depend on
    the start time — constant-capacity trace, or zero work (the duration
    is then the rate-independent ``fixed`` seconds alone).  Otherwise the
    piecewise trace is served through its cumulative-work arrays.
    """

    __slots__ = ("trace", "work", "fixed", "const_d")

    def __init__(self, trace, work: float, fixed: float):
        self.work = float(work)
        self.fixed = float(fixed)
        if self.work <= 0.0:
            self.const_d = self.fixed
            self.trace = None
        elif trace.is_constant():
            v = trace.values[0]
            self.const_d = self.fixed + (self.work / v if v > 0.0
                                         else math.inf)
            self.trace = None
        else:
            self.const_d = None
            self.trace = trace

    def finite(self) -> bool:
        """Every service completes in finite time from any start."""
        if self.const_d is not None:
            return math.isfinite(self.const_d)
        return self.trace.drains()

    def end_at(self, t: float) -> float:
        """Scalar service end for a task starting (exactly) at ``t``."""
        if self.const_d is not None:
            return t + self.const_d
        tr = self.trace
        return tr.finish_time(tr.work_done(t + self.fixed) + self.work)

    def ends_at(self, t: torch.Tensor) -> torch.Tensor:
        """Vectorized :meth:`end_at` (no queueing — starts are given)."""
        if self.const_d is not None:
            return t + self.const_d
        tr = self.trace
        return tr.finish_many(tr.work_done_many(t + self.fixed) + self.work)


def _shift_starts(a: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Service starts for FIFO back-to-back service: max(arrival, previous
    completion on the resource)."""
    s = a.clone()
    if s.shape[0] > 1:
        s[1:] = torch.maximum(s[1:], ends[:-1])
    return s


#: small cache of float index vectors for the prefix scans, per device
_IDX: dict = {}


def _idx(Q: int, device) -> torch.Tensor:
    key = (Q, str(device))
    got = _IDX.get(key)
    if got is None:
        if len(_IDX) > 64:
            _IDX.clear()
        got = _IDX[key] = torch.arange(Q, dtype=F64, device=device)
    return got


def _scalar_sweep(serves, a: torch.Tensor) -> torch.Tensor:
    """The reference's exact scalar FIFO sweep on host floats: task ``t``
    starts at max(arrival, previous end) on ``serves[t]``."""
    out = []
    prev = -math.inf
    for sv, x in zip(serves, a.tolist()):
        prev = sv.end_at(x if x > prev else prev)
        out.append(prev)
    return torch.tensor(out, dtype=F64, device=a.device)


def column_advance(serve: VisitServe, a: torch.Tensor):
    """FIFO service of one dedicated visit: arrivals ``a`` (one per
    micro-batch, in micro-batch order) -> ``(starts, ends)``.

    Constant durations use the closed-form time-space scan; varying traces
    with no fixed latency the work-space segmented scan (module docstring);
    the remaining corner (varying trace AND fixed > 0) is an exact scalar
    sweep on the host.
    """
    Q = a.shape[0]
    if serve.const_d is not None:
        dv = serve.const_d
        idx = _idx(Q, a.device)
        ends = (idx + 1.0) * dv + _cummax(a - idx * dv)
    elif serve.fixed == 0.0:
        w = serve.work
        idx = _idx(Q, a.device)
        A = serve.trace.work_done_many(a)
        target = (idx + 1.0) * w + _cummax(A - idx * w)
        ends = serve.trace.finish_many(target)
    else:
        ends = _scalar_sweep([serve] * Q, a)
    return _shift_starts(a, ends), ends


def fifo_pass(serves, Q: int, t_start: float, *, device):
    """Single exact pass for non-reentrant FIFO admission (any traces):
    chain-ordered column scans — visit ``v``'s arrivals are visit
    ``v-1``'s completions."""
    R = len(serves)
    starts = torch.empty((Q, R), dtype=F64, device=device)
    ends = torch.empty((Q, R), dtype=F64, device=device)
    a = torch.full((Q,), float(t_start), dtype=F64, device=device)
    for v in range(R):
        s, e = column_advance(serves[v], a)
        starts[:, v] = s
        ends[:, v] = e
        a = e
    return starts, ends


def _feedback_map(table, windows, Q: int) -> dict:
    """``{fp_visit: (bp_visit, window)}`` for the admission windows that can
    actually bind (``window < Q``)."""
    out = {}
    for j, w in enumerate(windows):
        if w is not None and w < Q:
            out[int(table.fp_visit[j])] = (int(table.bp_visit[j]), int(w))
    return out


def windowed_pass(serves, table, windows, Q: int, t_start: float, *,
                  device):
    """Single exact pass for non-reentrant *windowed* admission with
    time-varying traces: micro-batch-major, so the window feedback
    ``BP_j(m - w)  ->  FP_j(m)`` only ever reads earlier rows.  The chain
    scan along a row mixes per-visit traces, so it is the reference's
    scalar sweep — exact, heap-free, O(Q R) trace lookups — run on host
    floats; the (Q, R) matrices go to ``device`` once at the end."""
    R = len(serves)
    fb_at = _feedback_map(table, windows, Q)
    starts: list = []
    ends: list = []
    for m in range(Q):
        chain = t_start
        prev_row = ends[m - 1] if m else None
        srow = [0.0] * R
        erow = [0.0] * R
        for v in range(R):
            r = prev_row[v] if m else t_start
            fb = fb_at.get(v)
            if fb is not None and m - fb[1] >= 0:
                e_fb = ends[m - fb[1]][fb[0]]
                if e_fb > r:
                    r = e_fb
            s = chain if chain > r else r
            e = serves[v].end_at(s)
            srow[v] = s
            erow[v] = e
            chain = e
        starts.append(srow)
        ends.append(erow)
    if not Q:
        empty = torch.empty((0, R), dtype=F64, device=device)
        return empty, empty.clone()
    return (torch.tensor(starts, dtype=F64, device=device),
            torch.tensor(ends, dtype=F64, device=device))


class ActiveEdges:
    """The window feedback edges that bind at micro-batch ``m`` (those with
    window ``w <= m``), as device index tensors.

    The active set grows with ``m`` and depends only on the policy and the
    table, so it is found on the host (edges sorted by window: the active
    ones are a prefix) and each distinct prefix is moved to the device
    once — the micro-batch-major scans then make no host sync per
    micro-batch.  :meth:`at` returns ``(w, *cols)`` restricted to the
    active edges, or ``None`` when none binds.
    """

    def __init__(self, w, cols, device):
        w = np.asarray(w, dtype=np.intp)
        order = np.argsort(w, kind="stable")
        self.w = w[order]
        self.cols = [np.asarray(c, dtype=np.intp)[order] for c in cols]
        self.device = device
        self._prefix: dict = {}

    def at(self, m: int):
        n = int(np.searchsorted(self.w, m, side="right"))
        if n == 0:
            return None
        got = self._prefix.get(n)
        if got is None:
            got = self._prefix[n] = tuple(
                torch.as_tensor(a[:n], dtype=torch.long, device=self.device)
                for a in (self.w, *self.cols))
        return got


# ---------------------------------------------------------------------------
# Reentrant plans: merged-scan fixpoint
# ---------------------------------------------------------------------------

def _ready_col(v: int, ends: torch.Tensor, Q: int, t_start: float,
               fb_at: dict) -> torch.Tensor:
    """Ready times of visit ``v``'s tasks from the current end estimates:
    chain predecessor completions, max'd with any window feedback."""
    if v == 0:
        a = torch.full((Q,), float(t_start), dtype=F64, device=ends.device)
    else:
        a = ends[:, v - 1].clone()
    fb = fb_at.get(v)
    if fb is not None:
        bv, w = fb
        a[w:] = torch.maximum(a[w:], ends[:Q - w, bv])
    return a


class _MergedGroup:
    """Precomputed state for one reentrant resource's merged scan.

    ``arr[i]`` (stream ``i`` = visit ``vs[i]``) holds ready times; tasks are
    ordered by (effective arrival, micro-batch, stream position) — the
    within-stream cummax keeps each stream in micro-batch order even while
    the surrounding fixpoint is still settling — then served back-to-back
    with one scan (time-space for constant capacity, work-space for a
    shared trace, the scalar host sweep for the fixed-latency-on-trace
    corner).  The order is ``np.lexsort``'s: a stable sort on arrival of
    the tasks listed in (micro-batch, stream) rank order.
    """

    __slots__ = ("vs", "streams", "pos", "rank", "kind", "d", "w", "trace",
                 "sv", "last")

    def __init__(self, vs, serves, Q, device):
        self.vs = vs
        k = len(vs)
        self.streams = torch.arange(k, device=device).repeat_interleave(Q)
        mbs = torch.arange(Q, device=device).repeat(k)
        self.pos = mbs * k + self.streams        # unique (m, stream) rank
        self.rank = torch.argsort(self.pos)      # flat indices by rank
        sv = [serves[v] for v in vs]
        self.sv = sv
        self.trace = None
        self.d = self.w = None
        if all(s.const_d is not None for s in sv):
            self.kind = "const"
            self.d = torch.tensor([s.const_d for s in sv], dtype=F64,
                                  device=device)[self.streams]
        elif all(s.fixed == 0.0 and s.work > 0.0 for s in sv):
            self.kind = "work"
            self.trace = next(s.trace for s in sv if s.trace is not None)
            self.w = torch.tensor([s.work for s in sv], dtype=F64,
                                  device=device)[self.streams]
        else:
            self.kind = "scalar"
        self.last = None

    def advance(self, arr: torch.Tensor, starts, ends, Q):
        """One merged scan from ready times ``arr``; writes the member
        columns of ``starts``/``ends``.  Skips the sort + scan when the
        ready times match the previous sweep exactly (outputs would too),
        and reuses the previous sweep's service order while it is still
        consistent with the new arrivals."""
        if self.last is not None and torch.equal(arr, self.last[0]):
            return
        cached = None if self.last is None else self.last[1]
        eff = _cummax(arr, 1)                    # within-stream FIFO order
        flat = eff.reshape(-1)                   # index = i * Q + m
        order = None
        if cached is not None:
            a_s = flat[cached]
            d = torch.diff(a_s)
            tie = torch.diff(self.pos[cached])
            if bool(torch.all((d > 0) | ((d == 0) & (tie > 0)))):
                order = cached
        if order is None:
            order = self.rank[torch.sort(flat[self.rank], stable=True)
                              .indices]
            a_s = flat[order]
        self.last = (arr, order)
        if self.kind == "const":
            d = self.d[order]
            C = torch.cumsum(d, 0)
            ends_s = C + _cummax(a_s - (C - d))
        elif self.kind == "work":
            w = self.w[order]
            C = torch.cumsum(w, 0)
            tr = self.trace
            target = C + _cummax(tr.work_done_many(a_s) - (C - w))
            ends_s = tr.finish_many(target)
        else:
            ends_s = _scalar_sweep(
                [self.sv[i] for i in self.streams[order].tolist()], a_s)
        starts_s = _shift_starts(a_s, ends_s)
        st_flat = torch.empty_like(flat)
        en_flat = torch.empty_like(flat)
        st_flat[order] = starts_s
        en_flat[order] = ends_s
        for i, v in enumerate(self.vs):
            starts[:, v] = st_flat[i * Q:(i + 1) * Q]
            ends[:, v] = en_flat[i * Q:(i + 1) * Q]


def fixpoint_advance(table, serves, windows, Q: int, t_start: float,
                     max_sweeps: int | None = None, *, device):
    """Exact schedule for reentrant tables: iterate merged-scan sweeps to
    the self-consistent FIFO schedule.

    Sweeps are chaotic Gauss-Seidel over the per-resource groups (sorted by
    last visit, so a non-reentrant table degenerates to the exact
    chain-ordered single pass).  Returns ``(starts, ends, sweeps)`` on
    convergence (every column reproduced itself exactly), or ``None`` if
    the cap is hit — the caller falls back to the event engine
    (``engine="auto"``) or raises (``engine="vectorized"``).
    """
    R = len(serves)
    fb_at = _feedback_map(table, windows, Q)
    raw = sorted(table.resource_visits().values(), key=lambda vs: vs[-1])
    groups = [(vs, _MergedGroup(vs, serves, Q, device) if len(vs) > 1
               else None) for vs in raw]
    starts = torch.empty((Q, R), dtype=F64, device=device)
    ends = torch.full((Q, R), -math.inf, dtype=F64, device=device)
    # init: relaxed lower bound — every visit its own resource, window
    # feedback reads -inf (absent) on this first chain-ordered pass
    for v in range(R):
        a = _ready_col(v, ends, Q, t_start, fb_at)
        starts[:, v], ends[:, v] = column_advance(serves[v], a)
    if max_sweeps is None:
        max_sweeps = 2 * Q + 2 * R + 8
    prev = torch.empty_like(ends)
    for sweep in range(1, max_sweeps + 1):
        prev.copy_(ends)
        for vs, grp in groups:
            if grp is None:
                v = vs[0]
                a = _ready_col(v, ends, Q, t_start, fb_at)
                starts[:, v], ends[:, v] = column_advance(serves[v], a)
            else:
                arr = torch.stack([_ready_col(v, ends, Q, t_start, fb_at)
                                   for v in vs])
                grp.advance(arr, starts, ends, Q)
        if torch.equal(ends, prev):
            return starts, ends, sweep
    return None


# ---------------------------------------------------------------------------
# Stacked plan axis: many same-structure plans per fixpoint
# ---------------------------------------------------------------------------

def stack_eligible(serves) -> bool:
    """True when every visit's serving model fits a stacked scan: constant
    duration, or a trace with no fixed latency (the work-space scan).  The
    per-plan scalar corner (fixed > 0 on a varying trace) stays unstacked."""
    return all(s.const_d is not None
               or (s.fixed == 0.0 and s.work > 0.0) for s in serves)


def stacked_fixpoint(table, serves_list, windows_list, Qs, t_start: float,
                     max_sweeps: int | None = None, *, device):
    """Merged-scan fixpoint with a leading plan axis.

    ``serves_list[p]`` are plan ``p``'s per-visit :class:`VisitServe` models
    over ONE shared visit structure (identical ``table.resources``), and
    ``windows_list[p]`` its admission windows.  All plans advance through
    one set of (P, Q, R) sweeps.  Shorter plans are padded to the largest
    micro-batch count: padded tasks keep their real durations in the
    column scans (trailing rows never influence earlier ones) but are
    zeroed out in the merged scans, where a zero-duration task is inert.
    Returns per-plan ``(Q_p,)`` completion-time tensors of the last visit,
    or ``None`` if some plan's fixpoint failed to converge or a reentrant
    resource mixes serving kinds (the per-plan scalar merged scan covers
    those).
    """
    P = len(serves_list)
    R = len(table.resources)
    for vs in table.resource_visits().values():
        if len(vs) > 1:
            kinds = {serves_list[0][v].const_d is None for v in vs}
            if len(kinds) != 1:
                return None
    Qs = list(Qs)
    Q = max(Qs)
    d_host = np.zeros((P, R))        # const total durations per (plan, visit)
    w_host = np.zeros((P, R))        # work units for work-space visits
    use_work = [False] * R
    traces = [None] * R
    for v in range(R):
        if serves_list[0][v].const_d is None:
            use_work[v] = True
            traces[v] = serves_list[0][v].trace
            for p in range(P):
                w_host[p, v] = serves_list[p][v].work
        else:
            for p in range(P):
                d_host[p, v] = serves_list[p][v].const_d
    d_vis = torch.as_tensor(d_host, dtype=F64, device=device)
    w_vis = torch.as_tensor(w_host, dtype=F64, device=device)
    mcol = torch.arange(Q, device=device)
    live = mcol[None, :] < torch.as_tensor(Qs, device=device)[:, None]
    # window feedback: same (fp, bp) visit pairs, per-plan windows; the
    # gather indices depend only on the windows, so they are built once
    never = Q + 1
    fb_at = {}
    for j in range(table.num_stages):
        ws = [windows_list[p][j] if windows_list[p][j] is not None
              else never for p in range(P)]
        if min(ws) <= Q:
            src = mcol[None, :] - torch.as_tensor(ws, device=device)[:, None]
            ok = src >= 0
            fb_at[int(table.fp_visit[j])] = (
                int(table.bp_visit[j]), ok, torch.where(ok, src, 0))

    def ready(v, ends):
        if v == 0:
            a = torch.full((P, Q), float(t_start), dtype=F64, device=device)
        else:
            a = ends[:, :, v - 1].clone()
        got = fb_at.get(v)
        if got is not None:
            bv, ok, src = got
            vals = torch.gather(ends[:, :, bv], 1, src)
            a = torch.maximum(a, torch.where(ok, vals, -math.inf))
        return a

    idx = torch.arange(Q, dtype=F64, device=device)[None, :]

    def column(v, a, ends):
        # same per-plan arithmetic as column_advance, broadcast over plans
        if use_work[v]:
            w = w_vis[:, v:v + 1]
            tr = traces[v]
            A = tr.work_done_many(a)
            target = (idx + 1.0) * w + _cummax(A - idx * w, 1)
            ends[:, :, v] = tr.finish_many(target)
        else:
            d = d_vis[:, v:v + 1]
            ends[:, :, v] = (idx + 1.0) * d + _cummax(a - idx * d, 1)

    groups = sorted(table.resource_visits().values(), key=lambda vs: vs[-1])
    merged = {}
    for vs in groups:
        if len(vs) < 2:
            continue
        k = len(vs)
        # per-task durations/works, micro-batch-major (the tie-break rank
        # is the position in a row), padded tasks zeroed (inert)
        src = w_vis if use_work[vs[0]] else d_vis
        per = torch.stack([src[:, v:v + 1] * live for v in vs],
                          dim=2).reshape(P, Q * k)
        merged[vs[-1]] = [vs, per, None]

    def advance_group(grp, ends):
        vs, per, last = grp
        k = len(vs)
        arr = torch.stack([ready(v, ends) for v in vs], dim=1)  # (P, k, Q)
        if last is not None and torch.equal(arr, last[0]):
            return                   # inputs unchanged -> outputs unchanged
        cached = None if last is None else last[1]
        eff = _cummax(arr, 2)
        # stream-major (k, Q) -> task-flat with micro-batch-major tie-break
        flat = eff.transpose(1, 2).reshape(P, k * Q)
        order = None
        if cached is not None:       # reuse the settled service order
            a_s = torch.gather(flat, 1, cached)
            d = torch.diff(a_s, dim=1)
            tie = torch.diff(cached, dim=1)
            if bool(torch.all((d > 0) | ((d == 0) & (tie > 0)))):
                order = cached
        if order is None:
            order = torch.sort(flat, dim=1, stable=True).indices
            a_s = torch.gather(flat, 1, order)
        grp[2] = (arr, order)
        per_s = torch.gather(per, 1, order)
        C = torch.cumsum(per_s, 1)
        if use_work[vs[0]]:
            tr = traces[vs[0]]
            target = C + _cummax(tr.work_done_many(a_s) - (C - per_s), 1)
            e_s = torch.where(per_s > 0.0, tr.finish_many(target), a_s)
        else:
            e_s = C + _cummax(a_s - (C - per_s), 1)
        e = torch.empty_like(e_s).scatter_(1, order, e_s).reshape(P, Q, k)
        for i, v in enumerate(vs):
            ends[:, :, v] = e[:, :, i]

    ends = torch.full((P, Q, R), -math.inf, dtype=F64, device=device)
    for v in range(R):                       # relaxed chain-ordered init
        column(v, ready(v, ends), ends)
    if max_sweeps is None:
        max_sweeps = 2 * Q + 2 * R + 8
    prev = torch.empty_like(ends)
    for _ in range(max_sweeps):
        prev.copy_(ends)
        for vs in groups:
            m = merged.get(vs[-1]) if len(vs) > 1 else None
            if m is None:
                column(vs[0], ready(vs[0], ends), ends)
            else:
                advance_group(m, ends)
        if torch.equal(ends, prev):
            return [ends[p, :Qs[p], -1].clone() for p in range(P)]
    return None


# ---------------------------------------------------------------------------
# Stacked plan axis: many constant-capacity plans per scan
# ---------------------------------------------------------------------------

def stacked_fifo(ds: np.ndarray, Q: int, t_start: float, *,
                 device) -> torch.Tensor:
    """FIFO completion times for ``P`` constant-capacity plans at once.

    ``ds``: (P, R_max) host per-visit durations, right-padded with 0.0
    (zero-duration visits pass arrivals through unchanged).  Returns the
    (P, Q) completion times of each plan's last visit on ``device`` —
    bit-identical per plan to the single-plan scan (the recurrence is
    elementwise along the plan axis).
    """
    P, Rm = ds.shape
    dt = torch.as_tensor(ds, dtype=F64, device=device)
    idx = torch.arange(Q, dtype=F64, device=device)[None, :]
    prev = torch.full((P, Q), float(t_start), dtype=F64, device=device)
    for v in range(Rm):
        dv = dt[:, v:v + 1]
        prev = (idx + 1.0) * dv + _cummax(prev - idx * dv, 1)
    return prev


def stacked_windowed(ds: np.ndarray, fb: tuple, Q: int, t_start: float, *,
                     device) -> torch.Tensor:
    """Windowed-admission completion times for ``P`` constant-capacity
    plans at once (micro-batch-major, with a leading plan axis).

    ``fb`` carries the flattened feedback edges across all plans:
    ``(plan_idx, fp_visit, bp_visit, window)`` host integer arrays; the
    edges that bind at each micro-batch come from :class:`ActiveEdges`.
    Returns the (P, Q) last-visit completion times on ``device``; visit
    padding as in :func:`stacked_fifo`.
    """
    P, Rm = ds.shape
    p_idx, fp_v, bp_v, w_v = fb
    D_host = np.cumsum(ds, axis=1)
    D = torch.as_tensor(D_host, dtype=F64, device=device)
    Dsh = torch.as_tensor(np.concatenate((np.zeros((P, 1)), D_host[:, :-1]),
                                         axis=1), dtype=F64, device=device)
    edges = ActiveEdges(w_v, (p_idx, np.asarray(p_idx) * Rm
                              + np.asarray(fp_v), bp_v), device)
    ends = torch.empty((P, Q, Rm), dtype=F64, device=device)
    for m in range(Q):
        if m == 0:
            r = torch.full((P, Rm), float(t_start), dtype=F64, device=device)
        else:
            r = ends[:, m - 1, :].clone(
                memory_format=torch.contiguous_format)
            got = edges.at(m)
            if got is not None:
                ws, ps, tgt, bs = got
                r.view(-1).scatter_reduce_(0, tgt, ends[ps, m - ws, bs],
                                           "amax")
        ends[:, m, :] = D + _cummax(r - Dsh, 1)
    return ends[:, :, -1]
