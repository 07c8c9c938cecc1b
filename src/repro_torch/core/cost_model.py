"""Cost models — the pluggable objective/feasibility seam of the planner.

The port of ``repro/core/cost_model.py``'s protocol and its default,
:class:`ClosedForm` (the paper's Eqs. (12)-(14) objective with the
Eq. (11)/C7-C8 memory predicate), bit-identical to the reference.  The
simulated-makespan models (``SimMakespan``, ``DegradedTail``) and their
per-solve memo wait for the simulator's port.
"""

from __future__ import annotations

from . import latency as L
from .latency import SplitSolution
from .network import EdgeNetwork
from .profiles import ModelProfile

__all__ = ["CostModel", "ClosedForm", "resolve_cost_model"]


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


def resolve_cost_model(cost_model, memory_model: str = "paper") -> CostModel:
    """``None`` -> the default :class:`ClosedForm` (with the caller's
    ``memory_model``); a :class:`CostModel` instance passes through."""
    if cost_model is None:
        return ClosedForm(memory_model)
    if isinstance(cost_model, CostModel):
        return cost_model
    raise TypeError(f"expected a CostModel or None, got {cost_model!r}")
