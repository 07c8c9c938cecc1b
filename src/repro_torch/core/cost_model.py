"""Cost models — the pluggable objective/feasibility seam of the planner.

The port of ``repro/core/cost_model.py``'s protocol, its default
:class:`ClosedForm` (the paper's Eqs. (12)-(14) objective with the
Eq. (11)/C7-C8 memory predicate), bit-identical to the reference, and the
per-solve memo :func:`memoized_cost_model` that ``exhaustive_joint`` wraps
its model in.  The simulated-makespan models (``SimMakespan``,
``DegradedTail``) wait for the simulator's port.
"""

from __future__ import annotations

from .. import obs
from . import latency as L
from .latency import SplitSolution
from .network import EdgeNetwork
from .profiles import ModelProfile

__all__ = ["CostModel", "ClosedForm", "resolve_cost_model",
           "memoized_cost_model"]


class CostModel:
    """Objective + memory-feasibility pair consumed by the planner stack.

    ``evaluate`` is the quantity ``bcd_solve`` / ``exhaustive_microbatch``
    minimize (lower is better; ``math.inf`` for infeasible points);
    ``memory_feasible`` is the predicate behind the Eq. (24) feasible-b box
    (must be monotone non-increasing in ``b``).
    """

    name = "abstract"

    def evaluate(self, profile: ModelProfile, net: EdgeNetwork,
                 sol: SplitSolution, b: int, B: int) -> float:
        raise NotImplementedError

    def memory_feasible(self, profile: ModelProfile, net: EdgeNetwork,
                        sol: SplitSolution, b: int) -> bool:
        raise NotImplementedError

    def evaluate_many(self, profile: ModelProfile, net: EdgeNetwork,
                      cands, B: int) -> list:
        """Objectives for many candidate ``(sol, b)`` plans at once —
        identical to looping :meth:`evaluate`."""
        return [self.evaluate(profile, net, sol, b, B) for sol, b in cands]

    def memory_feasible_many(self, profile: ModelProfile, net: EdgeNetwork,
                             sol: SplitSolution, bs) -> list:
        """:meth:`memory_feasible` over a range of ``b``."""
        return [self.memory_feasible(profile, net, sol, b) for b in bs]


class ClosedForm(CostModel):
    """The paper's Eqs. (12)-(14) objective with the Eq. (11)/C7-C8 memory
    predicate — the default everywhere."""

    name = "closed_form"

    def __init__(self, memory_model: str = "paper"):
        self.memory_model = memory_model

    def evaluate(self, profile, net, sol, b, B) -> float:
        return L.total_latency(profile, net, sol, b, B)

    def memory_feasible(self, profile, net, sol, b) -> bool:
        return L.memory_feasible(profile, net, sol, b, self.memory_model)

    def __repr__(self):
        return f"ClosedForm(memory_model={self.memory_model!r})"


class _MemoCostModel(CostModel):
    """Per-solve memoization around another cost model.

    A solve's iterate scores and micro-batch refinements land on the same
    ``(cuts, placement, b)`` keys again and again, so an expensive
    objective is computed once per key.  The cache belongs to one
    ``(profile, net)``: a wrapper lives for one solve, never on the model
    itself (a re-solve on a changed network would read stale values).
    """

    def __init__(self, inner: CostModel):
        self.inner = inner
        self._eval: dict = {}
        self._mem: dict = {}

    @property
    def name(self):                      # type: ignore[override]
        return self.inner.name

    def evaluate(self, profile, net, sol, b, B) -> float:
        key = (sol.cuts, sol.placement, b, B)
        got = self._eval.get(key)
        if got is None:
            obs.inc("cost_model.memo_eval_miss")
            got = self._eval[key] = self.inner.evaluate(profile, net, sol,
                                                        b, B)
        else:
            obs.inc("cost_model.memo_eval_hit")
        return got

    def evaluate_many(self, profile, net, cands, B) -> list:
        out: list = [None] * len(cands)
        miss = []
        for i, (sol, b) in enumerate(cands):
            got = self._eval.get((sol.cuts, sol.placement, b, B))
            if got is None:
                miss.append(i)
            else:
                out[i] = got
        obs.inc("cost_model.memo_eval_hit", len(cands) - len(miss))
        obs.inc("cost_model.memo_eval_miss", len(miss))
        if miss:
            vals = self.inner.evaluate_many(profile, net,
                                            [cands[i] for i in miss], B)
            for i, val in zip(miss, vals):
                sol, b = cands[i]
                self._eval[(sol.cuts, sol.placement, b, B)] = val
                out[i] = val
        return out

    def memory_feasible(self, profile, net, sol, b) -> bool:
        key = (sol.cuts, sol.placement, b)
        got = self._mem.get(key)
        if got is None:
            obs.inc("cost_model.memo_mem_miss")
            got = self._mem[key] = self.inner.memory_feasible(profile, net,
                                                              sol, b)
        else:
            obs.inc("cost_model.memo_mem_hit")
        return got

    def memory_feasible_many(self, profile, net, sol, bs) -> list:
        out: list = [None] * len(bs)
        miss = []
        for i, b in enumerate(bs):
            got = self._mem.get((sol.cuts, sol.placement, b))
            if got is None:
                miss.append(i)
            else:
                out[i] = got
        obs.inc("cost_model.memo_mem_hit", len(bs) - len(miss))
        obs.inc("cost_model.memo_mem_miss", len(miss))
        if miss:
            vals = self.inner.memory_feasible_many(
                profile, net, sol, [bs[i] for i in miss])
            for i, val in zip(miss, vals):
                self._mem[(sol.cuts, sol.placement, bs[i])] = val
                out[i] = val
        return out

    def __repr__(self):
        return f"_MemoCostModel({self.inner!r})"


def memoized_cost_model(cm: CostModel) -> CostModel:
    """Wrap ``cm`` in a fresh per-solve memo (idempotent; ``ClosedForm`` is
    returned as it is: its evaluations are cheaper than the lookups)."""
    if isinstance(cm, (ClosedForm, _MemoCostModel)):
        return cm
    return _MemoCostModel(cm)


def resolve_cost_model(cost_model, memory_model: str = "paper") -> CostModel:
    """``None`` -> the default :class:`ClosedForm` (with the caller's
    ``memory_model``); a :class:`CostModel` instance passes through."""
    if cost_model is None:
        return ClosedForm(memory_model)
    if isinstance(cost_model, CostModel):
        return cost_model
    raise TypeError(f"expected a CostModel or None, got {cost_model!r}")
