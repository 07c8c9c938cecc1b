"""Plan robustness under failure distributions: tail-risk (CVaR) scoring and
the :class:`RobustMakespan` cost model.  The port of
``repro/sim/robustness.py``.

A plan runs across a *distribution* of fuzzed scenarios
(:func:`sim.fuzz.fuzz_scenario` families) through the simulator on
``device``, and the report gives

* **mean / p95 / CVaR_alpha of the makespan** — CVaR_alpha is the mean of
  the worst ``ceil((1-alpha) * n)`` makespans;
* **per-resource blocked-time attribution** — which node/link the tail
  scenarios starve, from ``obs.UtilizationReport``'s blocked decomposition.

:class:`RobustMakespan` threads the risk objective through the planner's
``CostModel`` seam: ``risk_aversion=1`` selects plans by pure CVaR, ``0`` by
the mean over the distribution.  The statistics are host numpy float64 in
the reference's order of operations, so an argmin over candidates picks the
reference's plan.

>>> import numpy as np
>>> cvar([1.0, 2.0, 3.0, 10.0], alpha=0.75)
10.0
>>> cvar([1.0, 2.0, 3.0, 10.0], alpha=0.5)
6.5
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .._device import resolve_device
from ..core.cost_model import CostModel, SimMakespan
from ..core.network import EdgeNetwork
from .engine import build_visit_table, simulate_plan, simulate_plans
from .fuzz import FuzzConfig, fuzz_scenario, fuzz_scenario_weighted
from .scenario import NetworkScenario

__all__ = ["cvar", "scenario_distribution", "importance_scenario_distribution",
           "RobustnessReport", "score_plan", "score_plans", "RobustMakespan",
           "memory_occupancy_overflow"]


def cvar(values, alpha: float = 0.95, weights=None) -> float:
    """Conditional value-at-risk: the mean of the worst
    ``ceil((1 - alpha) * n)`` values.  ``alpha=0`` is the plain mean,
    ``alpha -> 1`` the maximum.

    With ``weights`` (e.g. importance-sampling ratios from
    :func:`importance_scenario_distribution`) this is the *weighted*
    expected shortfall: the worst values forming exactly ``(1 - alpha)`` of
    the total weight, the boundary sample counted fractionally.  Note the
    unweighted path keeps the historical ceil-based tail (a whole number of
    samples), so ``cvar(v, a)`` and ``cvar(v, a, np.ones(n))`` differ
    whenever ``(1 - alpha) * n`` is fractional — comparisons across the two
    must use one convention (the IS regression test passes uniform weights
    to the reference sample too)."""
    if not 0.0 <= alpha < 1.0:
        raise ValueError("need 0 <= alpha < 1")
    arr = np.asarray(values, dtype=float)
    if arr.size == 0:
        raise ValueError("cvar of an empty sample")
    if weights is None:
        arr = np.sort(arr)
        k = int(math.ceil((1.0 - alpha) * arr.size))
        return float(arr[-k:].mean())
    w = np.asarray(weights, dtype=float)
    if w.shape != arr.shape:
        raise ValueError("weights must match values in shape")
    if np.any(w < 0) or not w.sum() > 0:
        raise ValueError("weights must be >= 0 with positive total")
    order = np.argsort(arr)[::-1]            # worst first
    v, w = arr[order], w[order]
    tail = (1.0 - alpha) * w.sum()
    before = np.cumsum(w) - w                # weight strictly worse than i
    take = np.minimum(w, np.maximum(0.0, tail - before))
    return float(np.dot(v, take) / tail)


def _weighted_quantile(values, weights, q: float) -> float:
    """Lower weighted quantile: smallest v with cumulative weight >= q."""
    v = np.asarray(values, dtype=float)
    w = np.asarray(weights, dtype=float)
    order = np.argsort(v)
    v, w = v[order], w[order]
    cum = np.cumsum(w) / w.sum()
    return float(v[int(np.searchsorted(cum, q, side="left").clip(0,
                                                                 v.size - 1))])


def scenario_distribution(net: EdgeNetwork, n: int, *, seed: int = 0,
                          config: FuzzConfig | None = None, profile=None,
                          sol=None, b: int | None = None,
                          num_microbatches: int = 4) -> tuple:
    """``n`` seeded fuzzed scenarios over ``net`` — the failure distribution
    every candidate plan is scored against (one *fixed* tuple, so scores are
    comparable across plans).  Passing a reference plan scales windows to
    its closed-form run length and arms the ``adversarial`` family against
    *its* bottleneck — the natural choice is the nominal (closed-form)
    selection, making the distribution a worst-case probe of the default
    plan."""
    config = config or FuzzConfig()
    rng = np.random.default_rng(seed)
    return tuple(fuzz_scenario(rng, net, config, profile=profile, sol=sol,
                               b=b, num_microbatches=num_microbatches)
                 for _ in range(n))


def importance_scenario_distribution(net: EdgeNetwork, n: int, *,
                                     seed: int = 0, tilt: float = 3.0,
                                     kind_tilt: dict | None = None,
                                     severity_tilt: float = 1.0,
                                     config: FuzzConfig | None = None,
                                     profile=None, sol=None,
                                     b: int | None = None,
                                     num_microbatches: int = 4) -> tuple:
    """``(scenarios, weights)``: an *importance-sampled* scenario
    distribution that over-draws rare compound failures and reweights.

    The nominal fuzzer draws the event count uniformly on
    ``[min_events, max_events]``, so at small ``n`` the compound tail — the
    scenarios stacking ``max_events`` simultaneous failures, which dominate
    CVaR — gets only ``n / K`` samples.  Here the count is drawn from the
    tilted proposal ``q(k) ∝ tilt**k`` (conditional stream given the count
    is unchanged: the fuzzer with ``min_events = max_events = k`` *is* the
    nominal conditional law), and each scenario carries the likelihood
    ratio ``p(k) / q(k)``.  Feed the weights to :func:`cvar` /
    :func:`score_plan`: the estimator stays unbiased for the uniform-count
    distribution while the tail is sampled ``~tilt**(K-1)`` x more densely.

    Beyond the count marginal, ``kind_tilt`` tilts the per-event *family*
    choice (name -> relative proposal mass, e.g. ``{"outage": 4.0}``) and
    ``severity_tilt > 1`` tilts each family's magnitude draw toward its
    damaging end — ``sim.fuzz.fuzz_scenario_weighted``.  The returned
    weights are the *joint* likelihood ratios (count x family x severity),
    so weighted estimators stay unbiased under any tilt combination.

    ``tilt=1`` with no kind/severity tilt recovers the uniform sampler
    (all weights 1, same RNG stream as :func:`scenario_distribution`)."""
    if tilt <= 0:
        raise ValueError("tilt must be > 0")
    config = config or FuzzConfig()
    ks = np.arange(config.min_events, config.max_events + 1)
    if ks.size == 0:
        raise ValueError("empty event-count range")
    p = np.full(ks.size, 1.0 / ks.size)
    q = np.power(float(tilt), ks - ks[0])
    q = q / q.sum()
    rng = np.random.default_rng(seed)
    scens, weights = [], []
    for _ in range(n):
        j = int(rng.choice(ks.size, p=q))
        cfg_k = dataclasses.replace(config, min_events=int(ks[j]),
                                    max_events=int(ks[j]))
        scen, w = fuzz_scenario_weighted(
            rng, net, cfg_k, profile=profile, sol=sol, b=b,
            num_microbatches=num_microbatches, family_tilt=kind_tilt,
            severity_tilt=severity_tilt)
        scens.append(scen)
        weights.append(float(p[j] / q[j]) * w)
    return tuple(scens), tuple(weights)


@dataclasses.dataclass(frozen=True)
class RobustnessReport:
    """Tail-risk profile of one plan across a scenario distribution."""
    makespans: tuple             # measured L_t, one per scenario
    nominal: float               # scenario-free makespan of the same plan
    alpha: float                 # CVaR confidence level
    blocked: dict | None = None  # resource -> mean blocked seconds, or None
    weights: tuple | None = None  # importance-sampling ratios, or None

    @property
    def mean(self) -> float:
        if self.weights is None:
            return float(np.mean(self.makespans))
        return float(np.average(self.makespans, weights=self.weights))

    @property
    def p95(self) -> float:
        if self.weights is None:
            return float(np.quantile(np.asarray(self.makespans), 0.95))
        return _weighted_quantile(self.makespans, self.weights, 0.95)

    @property
    def cvar(self) -> float:
        return cvar(self.makespans, self.alpha, self.weights)

    @property
    def worst(self) -> float:
        return float(np.max(self.makespans))

    @property
    def tail_inflation(self) -> float:
        """CVaR relative to the failure-free run — how much of the nominal
        speed the tail scenarios take back."""
        return self.cvar / self.nominal if self.nominal > 0 else math.inf

    def top_blocked(self, k: int = 3) -> list:
        """The ``k`` resources losing the most time to zero-capacity windows
        (``[(resource, mean_blocked_seconds)]``), worst first."""
        if not self.blocked:
            return []
        items = sorted(self.blocked.items(), key=lambda kv: -kv[1])
        return [(res, t) for res, t in items[:k] if t > 0.0]


def _blocked_attribution(profile, net, sol, b, reports, scenarios) -> dict:
    """Mean per-resource blocked seconds across the distribution's runs."""
    from ..obs import resource_traces
    table = build_visit_table(profile, net, sol, b)
    resources = set(table.resources)
    total: dict = {}
    for rep, scen in zip(reports, scenarios):
        traces = resource_traces(net, scen, resources)
        for res, u in rep.utilization(traces=traces).resources.items():
            total[res] = total.get(res, 0.0) + u.blocked
    return {res: t / len(reports) for res, t in total.items()}


def score_plan(profile, net, sol, b: int, *, B: int | None = None,
               num_microbatches: int | None = None, scenarios,
               weights=None, policy="fifo", engine: str = "auto",
               alpha: float = 0.95, attribution: bool = True,
               device="cuda") -> RobustnessReport:
    """Run one plan across ``scenarios`` on ``device`` and report its tail
    risk.  With ``attribution=True`` each run keeps its timeline and the
    report carries mean per-resource blocked time (where the failures
    actually bit).  ``weights`` (from
    :func:`importance_scenario_distribution`) makes every summary statistic
    importance-weighted."""
    dev = resolve_device(device)
    scenarios = tuple(scenarios)
    if not scenarios:
        raise ValueError("need at least one scenario")
    weights = None if weights is None else tuple(weights)
    kw = dict(B=B, num_microbatches=num_microbatches, policy=policy,
              engine=engine, device=dev)
    nominal = simulate_plan(profile, net, sol, b, **kw)
    if attribution:
        reports = [simulate_plan(profile, net, sol, b, scenario=s, **kw)
                   for s in scenarios]
        blocked = _blocked_attribution(profile, net, sol, b, reports,
                                       scenarios)
    else:
        reports = [
            simulate_plans(profile, net, [(sol, b)], B=B,
                           num_microbatches=None if num_microbatches is None
                           else [num_microbatches],
                           scenario=s, policy=policy, engine=engine,
                           device=dev)[0]
            for s in scenarios]
        blocked = None
    return RobustnessReport(makespans=tuple(r.L_t for r in reports),
                            nominal=nominal.L_t, alpha=alpha,
                            blocked=blocked, weights=weights)


def score_plans(profile, net, cands, *, B: int, scenarios, policy="fifo",
                engine: str = "auto", alpha: float = 0.95,
                device="cuda") -> list:
    """Batched :func:`score_plan` (no attribution): for each scenario, ONE
    ``simulate_plans`` call on ``device`` scores every candidate on the
    stacked plan axis; the per-candidate reports aggregate across
    scenarios."""
    dev = resolve_device(device)
    cands = list(cands)
    scenarios = tuple(scenarios)
    if not scenarios:
        raise ValueError("need at least one scenario")
    nominal = simulate_plans(profile, net, cands, B=B, policy=policy,
                             engine=engine, device=dev)
    cols = [simulate_plans(profile, net, cands, B=B, scenario=s,
                           policy=policy, engine=engine, device=dev)
            for s in scenarios]
    return [RobustnessReport(
                makespans=tuple(col[i].L_t for col in cols),
                nominal=nominal[i].L_t, alpha=alpha)
            for i in range(len(cands))]


def memory_occupancy_overflow(profile, net, sol, b: int, report,
                              scenario: NetworkScenario | None = None, *,
                              memory_model: str = "refined") -> dict:
    """Measured peak bytes ABOVE each node's *effective* memory budget
    during one simulated run — ``{}`` when occupancy fits everywhere.

    Occupied bytes on node ``n`` at time ``t`` are the Eq. (11) claims
    (``core.cost_model.stage_memory_claims``) driven by the engine's
    measured per-stage activation occupancy
    (``sim.policies.activation_occupancy``):
    ``static_n + sum_j occ_j(t) * act_j`` over the node's stages.  The
    budget is ``scenario.mem_trace(net, n)`` — ``Node.mem`` scaled by the
    scenario's memory-pressure trace (nominal when ``scenario`` is None) —
    evaluated at every occupancy change and every budget breakpoint inside
    the run.  Returns ``{node: peak_overflow_bytes}`` for nodes that
    overflow: the ground truth nominal and
    :class:`~repro_torch.core.cost_model.DegradedTail` admission windows are
    measured against."""
    from ..core.cost_model import stage_memory_claims
    from .policies import activation_occupancy
    scenario = scenario or NetworkScenario()
    claims = stage_memory_claims(profile, net, sol, b, memory_model)
    occ = activation_occupancy(report.records)
    static_n: dict = {}
    stages_n: dict = {}
    for c in claims:
        static_n[c.node] = static_n.get(c.node, 0.0) + c.static_bytes
        stages_n.setdefault(c.node, []).append(c)
    horizon = report.makespan
    out: dict = {}
    for node, cls in stages_n.items():
        mem_tr = scenario.mem_trace(net, node)
        times = {0.0}
        for c in cls:
            times.update(t for t, _ in occ.get(c.position, ()))
        times.update(t for t in mem_tr.times if 0.0 <= t <= horizon)
        ts = np.asarray(sorted(times), dtype=float)
        occupied = np.full(ts.shape, static_n[node])
        for c in cls:
            series = occ.get(c.position, [])
            if not series:
                continue
            st = np.asarray([t for t, _ in series], dtype=float)
            sv = np.asarray([o for _, o in series], dtype=float)
            # post-event occupancy at the last change <= t (step function)
            idx = np.searchsorted(st, ts, side="right") - 1
            occupied += np.where(idx >= 0, sv[np.clip(idx, 0, None)],
                                 0.0) * c.act_bytes
        budget = np.asarray([mem_tr.value_at(float(t)) for t in ts])
        over = float(np.max(occupied - budget)) if ts.size else 0.0
        if over > 0.0:
            out[node] = over
    return out


class RobustMakespan(CostModel):
    """Distributionally-robust objective for the planner seam:

        objective = (1 - risk_aversion) * mean(L_t over scenarios)
                    + risk_aversion * CVaR_alpha(L_t over scenarios)

    measured by the simulator under an admission policy (memory-budgeted by
    default, like :class:`~repro_torch.core.cost_model.SimMakespan`, whose
    memory predicate this model reuses — the Eq. (24) feasible-b box is a
    *capacity* property, not a scenario property).

    The scenario distribution is either passed explicitly (``scenarios=`` —
    what the benchmark does, so nominal- and robust-selected plans face the
    *same* failures) or lazily fuzzed on first evaluation against a network
    (seeded; windows scaled to the first-scored candidate, which under
    ``bcd_solve`` is the closed-form warm start — i.e. the distribution
    probes the default plan's weak spots).  Distributions are cached per
    network object: the elastic coordinator re-solves on *mutated* networks
    and must not reuse traces keyed to the old indices.  ``device`` is
    where the simulator runs (``"cuda"`` unless the caller passes
    ``"cpu"``).
    """

    name = "robust_makespan"

    def __init__(self, *, scenarios=None, n_scenarios: int = 12,
                 alpha: float = 0.95, risk_aversion: float = 1.0,
                 seed: int = 0, config: FuzzConfig | None = None,
                 policy="memory", engine: str = "auto",
                 memory_model: str = "refined", device="cuda"):
        if not 0.0 <= risk_aversion <= 1.0:
            raise ValueError("need 0 <= risk_aversion <= 1")
        self.scenarios = None if scenarios is None else tuple(scenarios)
        self.n_scenarios = n_scenarios
        self.alpha = alpha
        self.risk_aversion = risk_aversion
        self.seed = seed
        self.config = config or FuzzConfig()
        self._sim = SimMakespan(policy=policy, engine=engine,
                                memory_model=memory_model, device=device)
        self.device = self._sim.device
        self._dist_cache: list = []      # [(net, scenarios)], small FIFO

    # -- the distribution ---------------------------------------------------
    def distribution(self, profile, net, sol=None, b=None,
                     B: int | None = None) -> tuple:
        """The scenario tuple this model scores against ``net`` — explicit
        ``scenarios`` if given, else the cached lazily-fuzzed one."""
        if self.scenarios is not None:
            return self.scenarios
        for cached_net, scens in self._dist_cache:
            if cached_net is net:
                return scens
        Q = 4
        if b and B:
            Q = max(1, 1 + math.ceil((B - b) / b))
        scens = scenario_distribution(net, self.n_scenarios, seed=self.seed,
                                      config=self.config, profile=profile,
                                      sol=sol, b=b, num_microbatches=Q)
        self._dist_cache.append((net, scens))
        del self._dist_cache[:-4]
        return scens

    def _risk(self, makespans) -> float:
        lam = self.risk_aversion
        return ((1.0 - lam) * float(np.mean(makespans))
                + lam * cvar(makespans, self.alpha))

    # -- the CostModel surface ---------------------------------------------
    def evaluate(self, profile, net, sol, b, B) -> float:
        return self.evaluate_many(profile, net, [(sol, b)], B)[0]

    def evaluate_many(self, profile, net, cands, B) -> list:
        cands = list(cands)
        out = [math.inf] * len(cands)
        live = [i for i, (sol, b) in enumerate(cands)
                if b >= 1 and self._sim.memory_feasible(profile, net, sol, b)]
        if not live:
            return out
        s0, b0 = cands[live[0]]
        scens = self.distribution(profile, net, s0, b0, B)
        cols = [simulate_plans(profile, net, [cands[i] for i in live], B=B,
                               scenario=s, policy=self._sim.policy,
                               engine=self._sim.engine, device=self.device)
                for s in scens]
        for j, i in enumerate(live):
            out[i] = self._risk([col[j].L_t for col in cols])
        return out

    def memory_feasible(self, profile, net, sol, b) -> bool:
        return self._sim.memory_feasible(profile, net, sol, b)

    def memory_feasible_many(self, profile, net, sol, bs) -> list:
        return self._sim.memory_feasible_many(profile, net, sol, bs)

    def report(self, profile, net, sol, b, B) -> RobustnessReport:
        """Full :class:`RobustnessReport` (with blocked-time attribution)
        for one plan under this model's distribution."""
        return score_plan(profile, net, sol, b, B=B,
                          scenarios=self.distribution(profile, net, sol, b,
                                                      B),
                          policy=self._sim.policy, engine=self._sim.engine,
                          alpha=self.alpha, device=self.device)

    def __repr__(self):
        src = f"n_scenarios={self.n_scenarios}, seed={self.seed}" \
            if self.scenarios is None else f"scenarios={len(self.scenarios)}"
        return (f"RobustMakespan({src}, alpha={self.alpha}, "
                f"risk_aversion={self.risk_aversion})")
