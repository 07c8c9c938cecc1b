"""Algorithm 2 — BCD over (MSP) and (micro-batch size).

The port of ``repro/core/bcd.py``:

    b^0 = init;  repeat:
        (x, y, T_1) <- Algorithm 1 with b fixed          (core.shortest_path)
        b           <- Theorem 1  with (x, y, T_1) fixed (core.microbatch)
    until |L_t^tau - L_t^(tau-1)| < theta  or  max_iters

then the exact 1-D refinement of b (``refine_b``).  Algorithm 1 runs on the
planner's device; Theorem 1 is a host-side closed form.  The objective is
pluggable (``cost_model=``): the default ``ClosedForm`` is Eq. (14), while
``SimMakespan`` / ``sim.RobustMakespan`` score the iterates and the final
micro-batch refinement with the simulator on their own device.
``exhaustive_joint`` is Fig. 7's optimum: Algorithm 1 at every b, as one
``Planner.solve_many`` on the device (exact, or the batched device
backend).
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from .. import obs
from . import latency as L
from .cost_model import ClosedForm, memoized_cost_model, resolve_cost_model
from .latency import SplitSolution
from .microbatch import exhaustive_microbatch, optimal_microbatch
from .network import EdgeNetwork
from .profiles import ModelProfile
from .shortest_path import DEFAULT_SOLVER, Planner, solve_msp


@dataclasses.dataclass
class Plan:
    """A fully-specified pipelined-SL execution plan.

    ``L_t``/``T_f``/``T_i`` are the closed-form Eqs. (12)-(14) numbers;
    ``objective`` is the solving cost model's own metric at the final plan
    (equal to ``L_t`` under ``ClosedForm``), and ``cost_model`` names it.
    """
    solution: SplitSolution
    b: int
    B: int
    T_f: float
    T_i: float
    L_t: float
    iterations: int
    history: list            # [(objective, b, cuts, placement)] per iteration
    solve_seconds: float
    feasible: bool = True
    objective: float = math.nan
    cost_model: str = "closed_form"

    @property
    def num_microbatches(self) -> int:
        return math.ceil(self.B / self.b) if self.b else 0


def bcd_solve(profile: ModelProfile, net: EdgeNetwork, B: int,
              b0: int = 20, theta: float = 0.01, max_iters: int = 12,
              K: int | None = None, memory_model: str = "paper",
              refine_b: bool = True, solver: str | None = None,
              planner: Planner | None = None, cost_model=None,
              device="cuda") -> Plan:
    """Algorithm 2.  ``theta`` is the convergence tolerance (Table II: 0.01).

    ``refine_b`` (beyond-paper, default on) replaces the final
    micro-batching step with an exact 1-D scan of the true objective over b,
    then re-runs Algorithm 1 once at the refined b.  ``planner`` (graph
    factory + DP buffers) is shared across every BCD iteration; pass one in
    to amortize it across restarts — it must live on ``device``.

    ``cost_model`` selects the objective (``core.cost_model``): the default
    ``ClosedForm`` is the paper's Eq. (14); any other model (``SimMakespan``,
    ``sim.RobustMakespan``) keeps the closed-form alternation for candidate
    generation, warm-starts from the closed-form plan re-scored under it,
    and decides which iterate is kept and how b is refined.
    """
    with obs.span("bcd.solve", B=B, b0=b0,
                  cost_model=getattr(cost_model, "name", cost_model)):
        return _bcd_solve(profile, net, B, b0=b0, theta=theta,
                          max_iters=max_iters, K=K,
                          memory_model=memory_model, refine_b=refine_b,
                          solver=solver, planner=planner,
                          cost_model=cost_model, device=device)


def _bcd_solve(profile, net, B, *, b0, theta, max_iters, K, memory_model,
               refine_b, solver, planner, cost_model, device) -> Plan:
    t_start = time.perf_counter()
    # per-solve memo: iterate scores repeat once the alternation stabilizes,
    # and the warm start and refinement sweeps revisit the same candidates
    # (ClosedForm passes through unwrapped)
    cm = memoized_cost_model(resolve_cost_model(cost_model, memory_model))
    if planner is None:
        planner = Planner(profile, net, memory_model, device)
    elif planner.memory_model != memory_model:
        raise ValueError(
            f"planner was built with memory_model={planner.memory_model!r} "
            f"but bcd_solve was called with {memory_model!r}")
    elif planner.device.type != torch.device(device).type:
        raise ValueError(f"planner runs on {planner.device}, but bcd_solve "
                         f"was called with device={device!r}")
    b = max(1, min(b0, B))
    history = []
    prev_obj = math.inf
    best: tuple | None = None           # (solution, b, objective) incumbent

    def infeasible_plan(tau):
        return Plan(solution=SplitSolution((profile.num_layers,), (0,)),
                    b=0, B=B, T_f=math.inf, T_i=math.inf, L_t=math.inf,
                    iterations=tau, history=history,
                    solve_seconds=time.perf_counter() - t_start,
                    feasible=False, objective=math.inf, cost_model=cm.name)

    if isinstance(cm, ClosedForm):
        iters = 0
        for tau in range(1, max_iters + 1):
            iters = tau
            obs.inc("bcd.iterations")
            with obs.span("bcd.iterate", tau=tau, b=b):
                msp = planner.solve(b, B, K=K, solver=solver)
                if not msp.feasible:
                    # shrink b: memory may be the blocker at this size
                    if b > 1:
                        b = max(1, b // 2)
                        continue
                    return infeasible_plan(tau)
                mb = optimal_microbatch(profile, net, msp.solution, B,
                                        msp.T_1, memory_model=memory_model,
                                        cost_model=cm)
                if mb.b > 0:
                    b = mb.b
                obj = cm.evaluate(profile, net, msp.solution, b, B)
            # ties move forward, tracking the paper's always-move alternation
            if best is None or obj <= best[2]:
                best = (msp.solution, b, obj)
            history.append((best[2], best[1], best[0].cuts,
                            best[0].placement))
            # theta acts RELATIVE to the current latency scale; the equality
            # leg catches obj == prev_obj == inf, where the subtraction
            # gives NaN
            if prev_obj == obj or \
                    abs(prev_obj - obj) < theta * max(obj, 1e-12):
                break
            prev_obj = obj
    else:
        # warm start: the closed-form plan on the same planner, re-scored
        # under this model — the result is never worse than it on the
        # model's own metric
        seed = bcd_solve(profile, net, B, b0=b0, theta=theta,
                         max_iters=max_iters, K=K, memory_model=memory_model,
                         refine_b=refine_b, solver=solver, planner=planner,
                         device=device)
        if not (seed.feasible and seed.b > 0):
            seed = None
        # the iterates are closed-form work, generated objective-free up to
        # the first repeated (solution, b) (the alternation's fixed point);
        # one evaluate_many then scores the seed and every iterate, and the
        # stopping rule is replayed over those scores — the interleaved
        # loop's plan, history and iteration count exactly
        iters = 0
        iterates: list = []             # (tau, solution, b) per scored tau
        infeasible_at = None            # tau of a b == 1 infeasible solve
        for tau in range(1, max_iters + 1):
            iters = tau
            obs.inc("bcd.iterations")
            with obs.span("bcd.iterate", tau=tau, b=b):
                msp = planner.solve(b, B, K=K, solver=solver)
                if not msp.feasible:
                    if b > 1:
                        b = max(1, b // 2)
                        continue
                    infeasible_at = tau
                    break
                mb = optimal_microbatch(profile, net, msp.solution, B,
                                        msp.T_1, memory_model=memory_model,
                                        cost_model=cm)
                if mb.b > 0:
                    b = mb.b
            iterates.append((tau, msp.solution, b))
            if len(iterates) >= 2 and iterates[-1][1:] == iterates[-2][1:]:
                break
        cands = ([(seed.solution, seed.b)] if seed is not None else []) \
            + [(s, bb) for _, s, bb in iterates]
        objs = cm.evaluate_many(profile, net, cands, B)
        if seed is not None:
            best = (seed.solution, seed.b, objs[0])
            history.append((best[2], best[1], best[0].cuts,
                            best[0].placement))
            objs = objs[1:]
        stopped = False
        for (tau, i_sol, i_b), obj in zip(iterates, objs):
            # under a measured metric a closed-form step may regress: the
            # incumbent survives it (ties move forward)
            if best is None or obj <= best[2]:
                best = (i_sol, i_b, obj)
            history.append((best[2], best[1], best[0].cuts,
                            best[0].placement))
            if prev_obj == obj or \
                    abs(prev_obj - obj) < theta * max(obj, 1e-12):
                iters = tau
                stopped = True
                break
            prev_obj = obj
        if infeasible_at is not None and not stopped:
            # the interleaved loop would have given up exactly here
            return infeasible_plan(infeasible_at)
    if best is None:
        return infeasible_plan(iters)
    sol, b, obj = best

    if refine_b:
        # candidate 1: exact 1-D scan of the objective, split fixed
        b_ref, val_ref = exhaustive_microbatch(profile, net, sol, B,
                                               T_1=None,
                                               memory_model=memory_model,
                                               cost_model=cm)
        if b_ref > 0 and b_ref != b:
            if val_ref < obj:
                sol, b, obj = sol, b_ref, val_ref
                history.append((obj, b, sol.cuts, sol.placement))
            # candidate 2: re-run Algorithm 1 once at the refined b, then
            # re-refine b on the (possibly new) split
            msp2 = planner.solve(b_ref, B, K=K, solver=solver)
            if msp2.feasible and msp2.solution != sol:
                cand_sol, cand_b = msp2.solution, b_ref
                b_ref2, val2 = exhaustive_microbatch(
                    profile, net, cand_sol, B, T_1=None,
                    memory_model=memory_model, cost_model=cm)
                if b_ref2 > 0:
                    cand_b, cand_obj = b_ref2, val2
                else:
                    cand_obj = cm.evaluate(profile, net, cand_sol, cand_b, B)
                if cand_obj < obj:
                    sol, b, obj = cand_sol, cand_b, cand_obj
                    history.append((obj, b, sol.cuts, sol.placement))

    if math.isinf(obj):
        return Plan(solution=SplitSolution((profile.num_layers,), (0,)),
                    b=0, B=B, T_f=math.inf, T_i=math.inf, L_t=math.inf,
                    iterations=iters, history=history,
                    solve_seconds=time.perf_counter() - t_start,
                    feasible=False, objective=math.inf, cost_model=cm.name)
    T_f = L.fill_latency(profile, net, sol, b)
    T_i = L.pipeline_interval(profile, net, sol, b)
    return Plan(solution=sol, b=b, B=B, T_f=T_f, T_i=T_i,
                L_t=T_f + L.num_fills(B, b) * T_i, iterations=iters,
                history=history, solve_seconds=time.perf_counter() - t_start,
                objective=obj, cost_model=cm.name)


def exhaustive_joint(profile: ModelProfile, net: EdgeNetwork, B: int,
                     K: int | None = None, memory_model: str = "paper",
                     b_step: int = 1, solver: str | None = None,
                     cost_model=None, device="cuda", backend: str = "exact",
                     dtype=torch.float32) -> Plan:
    """Fig. 7's 'optimal scheme': exhaustive over b, Algorithm 1 per b.

    With ``solver="batched"`` (default) the whole b-sweep runs through one
    ``Planner`` on ``device`` as ``Planner.solve_many`` (every b stacked,
    its parent-free phases one K1 launch each) on ``backend`` ("exact", or
    "device": the batched device planner in ``dtype``); with
    ``solver="scan"`` each b pays its own ``solve_msp``.  ``cost_model``
    scores the per-b plans (default ``ClosedForm``: Eq. 14)."""
    t_start = time.perf_counter()
    cm = memoized_cost_model(resolve_cost_model(cost_model, memory_model))
    solver = solver or DEFAULT_SOLVER
    bs = list(range(1, B + 1, b_step))
    if solver == "batched":
        planner = Planner(profile, net, memory_model, device)
        msps = planner.solve_many(bs, B, K=K, backend=backend, dtype=dtype)
    else:
        msps = [solve_msp(profile, net, b, B, K=K, memory_model=memory_model,
                          solver=solver, device=device) for b in bs]
    live = [(b, msp) for b, msp in zip(bs, msps) if msp.feasible]
    objs = cm.evaluate_many(profile, net,
                            [(msp.solution, b) for b, msp in live], B)
    best_plan = None
    for (b, msp), obj in zip(live, objs):
        if best_plan is None or obj < best_plan.objective:
            best_plan = Plan(
                solution=msp.solution, b=b, B=B,
                T_f=L.fill_latency(profile, net, msp.solution, b),
                T_i=L.pipeline_interval(profile, net, msp.solution, b),
                L_t=L.total_latency(profile, net, msp.solution, b, B),
                iterations=1, history=[],
                solve_seconds=0.0, objective=obj, cost_model=cm.name)
    if best_plan is None or math.isinf(best_plan.objective):
        return Plan(solution=SplitSolution((profile.num_layers,), (0,)),
                    b=0, B=B, T_f=math.inf, T_i=math.inf, L_t=math.inf,
                    iterations=0, history=[], feasible=False,
                    solve_seconds=time.perf_counter() - t_start,
                    objective=math.inf, cost_model=cm.name)
    return dataclasses.replace(best_plan,
                               solve_seconds=time.perf_counter() - t_start)
