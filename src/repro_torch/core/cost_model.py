"""Cost models — the pluggable objective/feasibility seam of the planner.

The port of ``repro/core/cost_model.py``: the protocol, its default
:class:`ClosedForm` (the paper's Eqs. (12)-(14) objective with the
Eq. (11)/C7-C8 memory predicate), bit-identical to the reference,
:class:`SimMakespan` (the measured makespan of ``sim.simulate_plan`` under
an admission policy, memory-budgeted by default, on the model's device),
and the per-solve memo :func:`memoized_cost_model` that ``bcd_solve`` and
``exhaustive_joint`` wrap their model in.

The Eq. (11) claims source is here too: ``latency.memory_split`` ->
:func:`stage_memory_claims` -> :func:`node_budget_windows`, which the
simulator's ``MemoryBudgeted`` admission binds through, with
:class:`DegradedTail` sizing the budgets for a degraded-memory tail.  Host
float64 arithmetic in the reference's operation order, so the windows are
equal (``==``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .. import obs
from .._device import resolve_device
from . import latency as L
from .latency import SplitSolution, memory_split, memory_split_per_sample
from .network import EdgeNetwork
from .profiles import ModelProfile

__all__ = ["CostModel", "ClosedForm", "SimMakespan", "StageClaim",
           "DegradedTail",
           "stage_memory_claims", "node_budget_windows",
           "node_budget_windows_many", "budget_feasible",
           "resolve_cost_model", "memoized_cost_model"]


# ---------------------------------------------------------------------------
# The shared Eq. (11) claims source
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageClaim:
    """Memory claim of one pipeline stage (chain position ``position``).

    Holding ``w`` micro-batches live at this stage costs
    ``static_bytes + w * act_bytes``.
    """
    position: int            # stage position j in the non-empty chain
    submodel: int            # paper submodel index k
    node: int                # hosting node index
    static_bytes: float
    act_bytes: float


def stage_memory_claims(profile: ModelProfile, net: EdgeNetwork,
                        sol: SplitSolution, b: int,
                        memory_model: str = "refined") -> list:
    """Per-stage :class:`StageClaim` list — Eq. (11) via
    ``latency.memory_split``."""
    claims = []
    for j, (k, lo, hi, node) in enumerate(sol.segments()):
        static, act = memory_split(profile, net, lo, hi, node, b,
                                   memory_model)
        claims.append(StageClaim(position=j, submodel=k, node=node,
                                 static_bytes=static, act_bytes=act))
    return claims


@dataclasses.dataclass(frozen=True)
class DegradedTail:
    """Tail-sized node memory budgets for admission windows.

    ``mem[n]`` replaces ``Node.mem`` for node ``n`` (``None`` or a node
    beyond ``len(mem)``: the nominal budget).  :meth:`from_scenarios` sizes
    it as the mean of the worst ``ceil((1 - alpha) * n_scen)``
    per-scenario memory minima (``NetworkScenario.mem_mult``).
    """

    mem: tuple                   # per-node effective budget (None: nominal)
    alpha: float = 0.95

    @classmethod
    def from_scenarios(cls, net: EdgeNetwork, scenarios,
                       alpha: float = 0.95) -> "DegradedTail":
        """Size budgets from a scenario distribution's ``mem_mult`` traces
        (worst instant per scenario, lower-tail CVaR across scenarios)."""
        if not 0.0 <= alpha < 1.0:
            raise ValueError("need 0 <= alpha < 1")
        scenarios = tuple(scenarios)
        if not scenarios:
            raise ValueError("need at least one scenario")
        k = int(math.ceil((1.0 - alpha) * len(scenarios)))
        mems = []
        for i, node in enumerate(net.nodes):
            worst_mult = sorted(
                min(s.mem_mult[i].values) if i in s.mem_mult else 1.0
                for s in scenarios)
            mems.append(node.mem * float(sum(worst_mult[:k]) / k))
        return cls(mem=tuple(mems), alpha=alpha)

    def node_mem(self, net: EdgeNetwork, n: int) -> float:
        if n < len(self.mem) and self.mem[n] is not None:
            return self.mem[n]
        return net.nodes[n].mem

    def __repr__(self):
        sized = [m for m in self.mem if m is not None]
        return (f"DegradedTail(alpha={self.alpha}, nodes={len(self.mem)}, "
                f"min_mem={min(sized):.4g})" if sized else
                f"DegradedTail(alpha={self.alpha}, nominal)")


def node_budget_windows(profile: ModelProfile, net: EdgeNetwork,
                        sol: SplitSolution, b: int,
                        memory_model: str = "refined",
                        tail: DegradedTail | None = None) -> list:
    """Per-stage admission windows derived from ``Node.mem``.

    Co-located stages share their node's budget: the window is the largest
    ``w`` with ``static_n + w * act_n <= mem_n``.  ``None`` means unbounded
    (zero activation bytes); ``0`` means not even one live micro-batch
    fits.  ``tail`` substitutes :class:`DegradedTail` budgets.
    """
    claims = stage_memory_claims(profile, net, sol, b, memory_model)
    static_n: dict = {}
    act_n: dict = {}
    for c in claims:
        static_n[c.node] = static_n.get(c.node, 0.0) + c.static_bytes
        act_n[c.node] = act_n.get(c.node, 0.0) + c.act_bytes
    windows = []
    for c in claims:
        mem = net.nodes[c.node].mem if tail is None \
            else tail.node_mem(net, c.node)
        free = mem - static_n[c.node]
        act = act_n[c.node]
        if act <= 0.0:
            windows.append(None if free >= 0.0 else 0)
        else:
            windows.append(max(0, int(math.floor(free / act))))
    return windows


def node_budget_windows_many(profile: ModelProfile, net: EdgeNetwork,
                             sol: SplitSolution, bs,
                             memory_model: str = "refined",
                             tail: DegradedTail | None = None) -> list:
    """:func:`node_budget_windows` for many micro-batch sizes: one claims
    pass (``latency.memory_split_per_sample``) serves every ``b``, with the
    same multiplies in the same accumulation order (equal windows)."""
    segs = list(sol.segments())
    per = [(node, *memory_split_per_sample(profile, lo, hi, memory_model))
           for _, lo, hi, node in segs]
    M = net.num_clients
    bs = list(bs)
    b_arr = np.asarray(bs, dtype=np.intp)
    share = b_arr - (M - 1) * (b_arr // M)        # client_max_share, batched
    static_n: dict = {}
    act_n: dict = {}
    for node, static, per_sample in per:
        eff = share if node == 0 else b_arr
        static_n[node] = static_n.get(node, 0.0) + static
        act_n[node] = act_n.get(node, 0.0) + eff * per_sample
    cols = []
    for node, _, _ in per:
        mem = net.nodes[node].mem if tail is None \
            else tail.node_mem(net, node)
        free = mem - static_n[node]
        act = act_n[node]
        ws: list = [None] * len(bs)
        for i in range(len(bs)):
            a = float(act[i])
            if a <= 0.0:
                ws[i] = None if free >= 0.0 else 0
            else:
                ws[i] = max(0, int(math.floor(free / a)))
        cols.append(ws)
    return [[col[i] for col in cols] for i in range(len(bs))]


def budget_feasible(profile: ModelProfile, net: EdgeNetwork,
                    sol: SplitSolution, b: int,
                    memory_model: str = "refined",
                    tail: DegradedTail | None = None) -> bool:
    """Window >= 1 everywhere: one live micro-batch per stage fits every
    node's memory (monotone non-increasing in ``b``)."""
    return all(w is None or w >= 1
               for w in node_budget_windows(profile, net, sol, b,
                                            memory_model, tail))


# ---------------------------------------------------------------------------
# The cost-model protocol
# ---------------------------------------------------------------------------

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


class SimMakespan(CostModel):
    """Measured makespan: ``sim.simulate_plan`` under an admission policy.

    The simulated timeline charges the reentrant/co-location idle time the
    closed form idealizes away, and the admission ``policy`` bounds live
    activations — ``"memory"`` (``sim.policies.MemoryBudgeted``, the
    default) derives the windows from ``Node.mem`` via
    :func:`node_budget_windows`, so the objective and the feasibility
    predicate consume the same claims.  ``engine="auto"`` uses the
    vectorized engine wherever it is exact and falls back to the heap event
    loop.  ``repro_torch.sim`` is imported at call time, so ``core`` imports
    without it.  ``device`` (``"cuda"`` unless the caller passes ``"cpu"``)
    is where the simulator runs.
    """

    name = "sim_makespan"

    def __init__(self, policy="memory", engine: str = "auto",
                 memory_model: str = "refined",
                 tail: DegradedTail | None = None, device="cuda"):
        # one memory model for the feasibility predicate and the executed
        # admission windows: a "memory" policy name is built with this
        # model's memory_model and tail, and a pre-built MemoryBudgeted
        # donates its own
        if isinstance(policy, str) and \
                policy.lower() in ("memory", "memory_budgeted"):
            from ..sim.policies import MemoryBudgeted  # deferred
            policy = MemoryBudgeted(memory_model, tail=tail)
        elif getattr(policy, "name", None) == "memory":
            memory_model = policy.memory_model
            tail = policy.tail
        self.policy = policy
        self.engine = engine
        self.memory_model = memory_model
        self.tail = tail
        self.device = resolve_device(device)

    def evaluate(self, profile, net, sol, b, B) -> float:
        if b < 1 or not self.memory_feasible(profile, net, sol, b):
            return math.inf
        from ..sim.engine import simulate_plan  # deferred: no hard dep
        with obs.span("cost_model.sim_evaluate", b=b, B=B):
            rep = simulate_plan(profile, net, sol, b, B=B, policy=self.policy,
                                engine=self.engine, device=self.device)
        return rep.L_t

    def evaluate_many(self, profile, net, cands, B) -> list:
        """One ``sim.simulate_plans`` call for every memory-feasible
        candidate (the engine's stacked plan axis); equal to looping
        :meth:`evaluate`."""
        from ..sim.engine import simulate_plans  # deferred: no hard dep
        out = [math.inf] * len(cands)
        by_sol: dict = {}
        for i, (sol, b) in enumerate(cands):
            if b >= 1:
                by_sol.setdefault((sol.cuts, sol.placement), []).append(i)
        live = []
        for idxs in by_sol.values():
            sol = cands[idxs[0]][0]
            oks = self.memory_feasible_many(profile, net, sol,
                                            [cands[i][1] for i in idxs])
            live.extend(i for i, ok in zip(idxs, oks) if ok)
        live.sort()
        if not live:
            return out
        with obs.span("cost_model.sim_evaluate_many", n=len(live), B=B):
            reps = simulate_plans(profile, net, [cands[i] for i in live],
                                  B=B, policy=self.policy,
                                  engine=self.engine, device=self.device)
        for i, rep in zip(live, reps):
            out[i] = rep.L_t
        return out

    def memory_feasible(self, profile, net, sol, b) -> bool:
        return budget_feasible(profile, net, sol, b, self.memory_model,
                               self.tail)

    def memory_feasible_many(self, profile, net, sol, bs) -> list:
        wss = node_budget_windows_many(profile, net, sol, bs,
                                       self.memory_model, self.tail)
        return [all(w is None or w >= 1 for w in ws) for ws in wss]

    def __repr__(self):
        extra = "" if self.tail is None else f", tail={self.tail!r}"
        return (f"SimMakespan(policy={getattr(self.policy, 'name', self.policy)!r}, "
                f"engine={self.engine!r}, "
                f"memory_model={self.memory_model!r}{extra})")


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
