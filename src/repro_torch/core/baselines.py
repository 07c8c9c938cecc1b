"""The paper's benchmark schemes (Sec. VI-A) — the port's ``ours`` and
``no_pipeline``:

  No-Pipeline optimal MSP but a single micro-batch b = B (Eq. 14 collapses
              to T_f(B)); the upper bound for non-pipelined multi-hop SL/SI
  Ours        BCD (Algorithm 2) with a multi-start over b0

The random-cut / random-placement baselines and ``optimal`` are not ported
yet.
"""

from __future__ import annotations

import math

from . import latency as L
from .bcd import Plan, bcd_solve
from .cost_model import resolve_cost_model
from .latency import SplitSolution
from .network import EdgeNetwork
from .profiles import ModelProfile
from .shortest_path import Planner


def no_pipeline(profile: ModelProfile, net: EdgeNetwork, B: int,
                K: int | None = None, memory_model: str = "paper",
                solver: str | None = None, cost_model=None,
                device="cuda") -> Plan:
    """Optimal MSP with b = B (xi = 0 -> pure min-sum shortest path).
    ``cost_model`` only names the plan's ``cost_model``: there is no
    pipeline to re-score, so ``objective`` is the sequential latency."""
    cm = resolve_cost_model(cost_model, memory_model)
    planner = Planner(profile, net, memory_model, device)
    msp = planner.solve(B, B, K=K, solver=solver)
    if not msp.feasible:
        # memory may force b < B even without pipelining benefits: fall back
        # to the largest feasible single micro-batch
        for b in (B // 2, B // 4, B // 8, B // 16, 1):
            msp = planner.solve(max(b, 1), B, K=K, solver=solver)
            if msp.feasible:
                sol = msp.solution
                ticks = math.ceil(B / max(b, 1))
                T_f = L.fill_latency(profile, net, sol, max(b, 1))
                return Plan(solution=sol, b=max(b, 1), B=B, T_f=T_f,
                            T_i=T_f, L_t=ticks * T_f, iterations=1,
                            history=[], solve_seconds=0.0,
                            objective=ticks * T_f, cost_model=cm.name)
        return _infeasible(profile, B)
    sol = msp.solution
    T_f = L.fill_latency(profile, net, sol, B)
    return Plan(solution=sol, b=B, B=B, T_f=T_f, T_i=T_f, L_t=T_f,
                iterations=1, history=[], solve_seconds=0.0,
                objective=T_f, cost_model=cm.name)


def ours(profile: ModelProfile, net: EdgeNetwork, B: int, *, b0: int = 20,
         theta: float = 0.01, K: int | None = None,
         memory_model: str = "paper", restarts: bool = True,
         solver: str | None = None, cost_model=None, device="cuda") -> Plan:
    """Algorithm 2, with multi-start over b0 (BCD is a coordinate descent
    and can sit in a poor basin for one seed).  One ``Planner`` (graph
    factory + DP buffers) on ``device`` is shared by every restart."""
    cm = resolve_cost_model(cost_model, memory_model)
    planner = Planner(profile, net, memory_model, device)
    plan = bcd_solve(profile, net, B, b0=b0, theta=theta, K=K,
                     memory_model=memory_model, solver=solver,
                     planner=planner, cost_model=cm, device=device)
    if not restarts:
        return plan
    # the restart order is the reference's set iteration order
    for alt in {max(1, B // 16), max(1, B // 4), max(1, B // 2)} - {b0}:
        cand = bcd_solve(profile, net, B, b0=alt, theta=theta, K=K,
                         memory_model=memory_model, solver=solver,
                         planner=planner, cost_model=cm, device=device)
        if cand.feasible and (not plan.feasible
                              or cand.objective < plan.objective):
            plan = cand
    return plan


def _infeasible(profile: ModelProfile, B: int) -> Plan:
    return Plan(solution=SplitSolution((profile.num_layers,), (0,)), b=0, B=B,
                T_f=math.inf, T_i=math.inf, L_t=math.inf, iterations=0,
                history=[], solve_seconds=0.0, feasible=False,
                objective=math.inf)
