"""Pipeline schedule timeline — discrete-event validation of Eqs. (13)/(14).

The port's copy of ``repro/pipeline/schedule.py`` (pure Python floats,
bit-equal to the reference).  A K-stage pipeline with Q identical
micro-batches finishes in

    L_t = T_f + (Q - 1) * T_i                                  (Eq. 14)

with T_i the bottleneck resource time (Eq. 13); for a permutation flow
shop with identical jobs this is exact, so the event simulation reproduces
it to float precision when FP and BP engines are separate per-node
resources, as the paper models them.  ``shared_engine=True`` makes FP and
BP of a node contend for one engine.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..core.latency import LatencyBreakdown
from ..sim.policies import resolve_policy


def memory_highwater(num_stages: int, num_microbatches: int,
                     policy="1f1b", *, bind=None) -> dict:
    """Closed-form activation high-water claim per 0-based stage position
    (``policy``: "fifo"/"gpipe"/"1f1b"/"memory" or an ``AdmissionPolicy``).
    The plan-dependent ``"memory"`` policy needs its plan: pass
    ``bind=(profile, net, sol, b)`` or a policy bound already.

    >>> memory_highwater(3, 12, "1f1b")
    {0: 3, 1: 2, 2: 1}
    >>> memory_highwater(3, 12, "gpipe")
    {0: 12, 1: 12, 2: 12}
    """
    pol = resolve_policy(policy)
    if bind is not None:
        pol = pol.bind(*bind)
    return pol.stage_capacity(num_stages, num_microbatches)


@dataclasses.dataclass
class SimResult:
    makespan: float
    analytic: float            # T_f + (Q-1) * T_i
    rel_gap: float
    resource_busy: dict        # resource -> busy fraction
    memory_factor: dict        # schedule -> in-flight micro-batches per stage


def simulate(stage_fp: Sequence[float], stage_bp: Sequence[float],
             link_fwd: Sequence[float], link_bwd: Sequence[float],
             num_microbatches: int, *, shared_engine: bool = False
             ) -> SimResult:
    """FIFO event simulation of the pipelined FP+BP flow.

    stage_fp/bp: per-stage seconds per micro-batch (len K);
    link_fwd/bwd: per-link seconds (len K-1).
    """
    K = len(stage_fp)
    Q = num_microbatches
    # visit order per micro-batch: fp1, fwd1, fp2, ... fpK, bpK, bwdK-1, ...
    visits = []
    for k in range(K):
        visits.append((("node", k) if shared_engine else ("fp", k),
                       stage_fp[k]))
        if k < K - 1:
            visits.append((("fwd", k), link_fwd[k]))
    for k in reversed(range(K)):
        visits.append((("node", k) if shared_engine else ("bp", k),
                       stage_bp[k]))
        if k > 0:
            visits.append((("bwd", k - 1), link_bwd[k - 1]))

    avail: dict = {}
    busy: dict = {}
    makespan = 0.0
    for q in range(Q):
        t = 0.0
        for res, dur in visits:
            start = max(t, avail.get(res, 0.0))
            t = start + dur
            avail[res] = t
            busy[res] = busy.get(res, 0.0) + dur
        makespan = max(makespan, t)

    T_f = sum(d for _, d in visits)
    per_res: dict = {}
    for res, dur in visits:
        per_res[res] = per_res.get(res, 0.0) + dur
    T_i = max(per_res.values())
    analytic = T_f + (Q - 1) * T_i
    mem = {
        "gpipe": memory_highwater(K, Q, "gpipe"),
        "1f1b": memory_highwater(K, Q, "1f1b"),
    }
    return SimResult(
        makespan=makespan, analytic=analytic,
        rel_gap=(makespan - analytic) / analytic if analytic else 0.0,
        resource_busy={r: b / makespan for r, b in busy.items()},
        memory_factor=mem)


def simulate_from_breakdown(bd: LatencyBreakdown, num_microbatches: int,
                            **kw) -> SimResult:
    """Adapter from core.latency.breakdown() (paper-model component times)."""
    ks = sorted(bd.stage_fp)
    fp = [bd.stage_fp[k] for k in ks]
    bp = [bd.stage_bp[k] for k in ks]
    fwd = [t for _, t in sorted(bd.link_fwd.items())]   # keyed (k, n, n')
    bwd = [t for _, t in sorted(bd.link_bwd.items())]   # keyed (k, n', n)
    return simulate(fp, bp, fwd, bwd, num_microbatches, **kw)
