"""The paper's benchmark schemes (Sec. VI-A):

  RC+OP       random cut, optimal placement (our placement + micro-batching)
  RP+OC       random placement, optimal cut (our splitting + micro-batching)
  No-Pipeline optimal MSP but a single micro-batch b = B (Eq. 14 collapses
              to T_f(B)); the upper bound for non-pipelined multi-hop SL/SI
  Optimal     exhaustive-over-b joint optimum (Fig. 7's reference)
  Ours        BCD (Algorithm 2) with a multi-start over b0

The random draws are the reference's: a ``numpy.random.Generator`` seeded
alike, called in the same order.  ``sim_refined`` is the simulator-scored
BCD (``SimMakespan``, memory-budgeted admission).
"""

from __future__ import annotations

import math

import numpy as np

from . import latency as L
from .bcd import Plan, bcd_solve, exhaustive_joint
from .cost_model import SimMakespan, resolve_cost_model
from .latency import SplitSolution
from .microbatch import optimal_microbatch
from .network import EdgeNetwork
from .profiles import ModelProfile
from .shortest_path import Planner


def _finish_plan(profile, net, sol, b, B, cm=None) -> Plan:
    T_f = L.fill_latency(profile, net, sol, b)
    T_i = L.pipeline_interval(profile, net, sol, b)
    cm = resolve_cost_model(cm)
    return Plan(solution=sol, b=b, B=B, T_f=T_f, T_i=T_i,
                L_t=T_f + L.num_fills(B, b) * T_i, iterations=1, history=[],
                solve_seconds=0.0,
                feasible=math.isfinite(T_f) and
                L.memory_feasible(profile, net, sol, b),
                objective=cm.evaluate(profile, net, sol, b, B),
                cost_model=cm.name)


def random_cuts(rng: np.random.Generator, I: int, K: int) -> tuple:
    """K-segment random non-decreasing cut vector ending at I (C4/C5)."""
    s = int(rng.integers(2, K + 1)) if K >= 2 else 1
    if s == 1:
        return (I,)
    inner = np.sort(rng.choice(np.arange(1, I), size=s - 1, replace=False))
    return tuple(int(c) for c in inner) + (I,)


def _redraw(profile, net, B, planner, cm, b0, solver, memory_model, *,
            cuts=None, placement=None) -> Plan | None:
    """One draw of a random baseline: Algorithm 1 with the drawn cuts or
    placement fixed, at b0, then Theorem 1's micro-batch; None if the draw
    is infeasible."""
    msp = planner.solve(b0, B, K=len(cuts or placement), restrict_cuts=cuts,
                        restrict_placement=placement, solver=solver)
    if not msp.feasible:
        return None
    mb = optimal_microbatch(profile, net, msp.solution, B, msp.T_1,
                            memory_model=memory_model, cost_model=cm)
    b = mb.b if mb.b > 0 else b0
    return _finish_plan(profile, net, msp.solution, b, B, cm)


def rc_op(profile: ModelProfile, net: EdgeNetwork, B: int, *, seed: int = 0,
          b0: int = 20, K: int | None = None, tries: int = 4,
          memory_model: str = "paper", solver: str | None = None,
          cost_model=None, device="cuda") -> Plan:
    """Random Cut + Optimal Placement (+ optimal micro-batch, so that the
    pipeline comparison is like for like, as in Figs. 4/5).  Each of
    ``tries`` draws is solved on one shared planner on ``device``;
    ``cost_model`` scores them (default: closed-form Eq. 14)."""
    rng = np.random.default_rng(seed)
    cm = resolve_cost_model(cost_model, memory_model)
    K = K or min(1 + net.num_servers, profile.num_layers)
    planner = Planner(profile, net, memory_model, device)
    best = None
    for _ in range(tries):  # a random cut can be infeasible; re-draw
        cuts = random_cuts(rng, profile.num_layers, K)
        plan = _redraw(profile, net, B, planner, cm, b0, solver,
                       memory_model, cuts=cuts)
        if plan is not None and (best is None
                                 or plan.objective < best.objective):
            best = plan
    return best if best is not None else _infeasible(profile, B)


def rp_oc(profile: ModelProfile, net: EdgeNetwork, B: int, *, seed: int = 0,
          b0: int = 20, K: int | None = None, tries: int = 4,
          memory_model: str = "paper", solver: str | None = None,
          cost_model=None, device="cuda") -> Plan:
    """Random Placement + Optimal Cut (+ optimal micro-batch)."""
    rng = np.random.default_rng(seed)
    cm = resolve_cost_model(cost_model, memory_model)
    K = K or min(1 + net.num_servers, profile.num_layers)
    servers = list(net.server_indices())
    planner = Planner(profile, net, memory_model, device)
    best = None
    for _ in range(tries):
        s = min(int(rng.integers(2, K + 1)), 1 + len(servers))
        order = list(rng.permutation(servers)[:s - 1])
        placement = (0,) + tuple(int(n) for n in order)
        plan = _redraw(profile, net, B, planner, cm, b0, solver,
                       memory_model, placement=placement)
        if plan is not None and (best is None
                                 or plan.objective < best.objective):
            best = plan
    return best if best is not None else _infeasible(profile, B)


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


def sim_refined(profile: ModelProfile, net: EdgeNetwork, B: int, *,
                b0: int = 20, theta: float = 0.01, K: int | None = None,
                memory_model: str = "paper", restarts: bool = False,
                solver: str | None = None, cost_model=None,
                policy="memory", engine: str = "auto",
                device="cuda") -> Plan:
    """Sim-in-the-loop BCD: Algorithm 2 whose iterate selection and final
    micro-batch refinement minimize the *measured* makespan of
    ``sim.simulate_plan`` (``SimMakespan(policy=policy)``, memory-budgeted
    by default) instead of the closed form.  Algorithm 1 and the simulator
    both run on ``device``.  Restarts default off — each one pays an
    O(B)-simulation refinement scan."""
    cm = cost_model or SimMakespan(policy=policy, engine=engine,
                                   device=device)
    return ours(profile, net, B, b0=b0, theta=theta, K=K,
                memory_model=memory_model, restarts=restarts, solver=solver,
                cost_model=cm, device=device)


def optimal(profile: ModelProfile, net: EdgeNetwork, B: int,
            K: int | None = None, b_step: int = 1,
            memory_model: str = "paper", solver: str | None = None,
            cost_model=None, device="cuda") -> Plan:
    """Fig. 7's optimum: ``exhaustive_joint`` over b = 1, 1 + b_step, ..."""
    return exhaustive_joint(profile, net, B, K=K, b_step=b_step,
                            memory_model=memory_model, solver=solver,
                            cost_model=cost_model, device=device)


SCHEMES = {
    "ours": ours,
    "sim_refined": sim_refined,
    "rc_op": rc_op,
    "rp_oc": rp_oc,
    "no_pipeline": no_pipeline,
}


def _infeasible(profile: ModelProfile, B: int) -> Plan:
    return Plan(solution=SplitSolution((profile.num_layers,), (0,)), b=0, B=B,
                T_f=math.inf, T_i=math.inf, L_t=math.inf, iterations=0,
                history=[], solve_seconds=0.0, feasible=False,
                objective=math.inf)
