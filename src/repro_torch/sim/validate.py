"""Cross-validation of the simulator against the analytical latency model —
the port of ``repro/sim/validate.py``.

On a deterministic network whose plan places every submodel on a distinct
node, each resource is visited exactly once per micro-batch, so the FIFO
pipeline is a permutation flow shop with identical jobs and the analytical
Eqs. (12)-(14) are *exact*: simulated T_f, T_i and L_t must agree with
``core.latency.fill_latency`` / ``pipeline_interval`` / ``total_latency`` to
numerical tolerance.  ``cross_validate_many`` runs this over randomized
(profile, network, plan) triples — the standing consistency test that keeps
the closed-form model and the event engine honest against each other —
and ``compare_engines`` holds the heap engine and the vectorized engine to
the same timelines under every admission policy.

>>> import numpy as np
>>> from repro_torch.core import (uniform_profile, EdgeNetwork, Node,
...                               SplitSolution)
>>> prof = uniform_profile(4, fp=1.0, bp=1.0, act=1.0)
>>> nodes = [Node("c", f=1.0, t0=0.0, t1=0.0, b_th=0, is_client=True),
...          Node("s", f=1.0, t0=0.0, t1=0.0, b_th=0)]
>>> net = EdgeNetwork(nodes=nodes, rate=np.array([[0., 10.], [10., 0.]]),
...                   num_clients=1)
>>> sol = SplitSolution(cuts=(2, 4), placement=(0, 1))
>>> cross_validate(prof, net, sol, b=1, B=3, device="cpu").ok
True
>>> compare_engines(prof, net, sol, 1, 3, policy="1f1b",
...                 device="cpu") < 1e-12
True
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import latency as L
from ..core.latency import SplitSolution, validate_solution
from ..core.network import EdgeNetwork, make_edge_network
from ..core.profiles import ModelProfile, random_profile
from ..obs import resource_traces
from .engine import build_visit_table, simulate_plan

#: topologies cycled through by ``random_instance``
TOPOLOGIES = ("mesh", "line", "star", "tree")


@dataclasses.dataclass(frozen=True)
class CrossCheck:
    """Simulated vs analytical latencies for one (profile, net, plan, b, B)."""
    T_f_sim: float
    T_f_ana: float
    T_i_sim: float
    T_i_ana: float
    L_t_sim: float
    L_t_ana: float
    b: int
    B: int
    cuts: tuple
    placement: tuple
    rtol: float

    def _rel(self, a: float, c: float) -> float:
        return abs(a - c) / max(abs(c), 1e-30)

    @property
    def max_rel_err(self) -> float:
        errs = [self._rel(self.T_f_sim, self.T_f_ana),
                self._rel(self.L_t_sim, self.L_t_ana)]
        if self.B > self.b:          # T_i only observable with >= 2 slots
            errs.append(self._rel(self.T_i_sim, self.T_i_ana))
        return max(errs)

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.L_t_ana) and self.max_rel_err <= self.rtol)


def random_chain_solution(rng: np.random.Generator, profile: ModelProfile,
                          net: EdgeNetwork,
                          max_stages: int | None = None) -> SplitSolution:
    """A random feasible solution with *distinct* placements (no co-located
    submodels — the regime where Eq. (14) is exact; see module docstring)."""
    I = profile.num_layers
    cap = min(max_stages or I, net.num_servers + 1, I)
    K = int(rng.integers(2, cap + 1)) if cap >= 2 else 1
    if K == 1:
        sol = SplitSolution((I,), (0,))
    else:
        inner = np.sort(rng.choice(np.arange(1, I), size=K - 1, replace=False))
        cuts = tuple(int(c) for c in inner) + (I,)
        servers = rng.choice(np.arange(1, len(net.nodes)), size=K - 1,
                             replace=False)
        sol = SplitSolution(cuts, (0,) + tuple(int(s) for s in servers))
    validate_solution(sol, profile, net)
    return sol


def random_instance(seed: int):
    """One randomized (profile, network, solution, b, B) validation triple."""
    rng = np.random.default_rng(seed)
    num_layers = int(rng.integers(4, 12))
    num_servers = int(rng.integers(2, 6))
    topology = TOPOLOGIES[seed % len(TOPOLOGIES)]
    profile = random_profile(rng, num_layers)
    net = make_edge_network(num_servers=num_servers,
                            num_clients=int(rng.integers(1, 5)),
                            topology=topology, seed=seed)
    sol = random_chain_solution(rng, profile, net)
    b = int(rng.integers(1, 17))
    B = b * int(rng.integers(2, 9)) + int(rng.integers(0, b))
    return profile, net, sol, b, B


def cross_validate(profile: ModelProfile, net: EdgeNetwork,
                   sol: SplitSolution, b: int, B: int, *,
                   rtol: float = 1e-6, device="cuda") -> CrossCheck:
    """Simulate (the event engine, the reference's default) and compare
    against Eqs. (12)-(14) for one instance."""
    rep = simulate_plan(profile, net, sol, b, B=B, device=device)
    return CrossCheck(
        T_f_sim=rep.T_f,
        T_f_ana=L.fill_latency(profile, net, sol, b),
        T_i_sim=rep.T_i,
        T_i_ana=L.pipeline_interval(profile, net, sol, b),
        L_t_sim=rep.L_t,
        L_t_ana=L.total_latency(profile, net, sol, b, B),
        b=b, B=B, cuts=sol.cuts, placement=sol.placement, rtol=rtol)


def cross_validate_many(trials: int = 20, *, seed: int = 0,
                        rtol: float = 1e-6, device="cuda") -> list:
    """The standing cross-check over ``trials`` randomized triples."""
    return [cross_validate(*random_instance(seed * 1000 + i), rtol=rtol,
                           device=device)
            for i in range(trials)]


def compare_engines(profile: ModelProfile, net: EdgeNetwork,
                    sol: SplitSolution, b: int, num_microbatches: int, *,
                    policy="fifo", scenario=None, device="cuda") -> float:
    """Max relative gap between heap-engine and vectorized-engine micro-batch
    completion times for one instance — the standing engine-equivalence
    check (must be ulp-level wherever the vectorized engine is eligible:
    constant *and* piecewise-constant traces via ``scenario``, distinct
    *and* reentrant placements, every admission policy), computed on
    ``device``."""
    ev = simulate_plan(profile, net, sol, b,
                       num_microbatches=num_microbatches, policy=policy,
                       scenario=scenario, engine="event", device=device)
    vec = simulate_plan(profile, net, sol, b,
                        num_microbatches=num_microbatches, policy=policy,
                        scenario=scenario, engine="vectorized", device=device)
    denom = torch.clamp(torch.abs(ev.mb_complete), min=1e-30)
    return float(torch.max(torch.abs(ev.mb_complete - vec.mb_complete)
                           / denom))


def compare_utilization(profile: ModelProfile, net: EdgeNetwork,
                        sol: SplitSolution, b: int, num_microbatches: int, *,
                        policy="fifo", scenario=None,
                        device="cuda") -> float:
    """Max absolute gap (normalized by the run horizon) between the two
    engines' ``UtilizationReport`` decompositions for one instance — the
    standing idle-accounting parity check.

    The event engine's report is reconstructed from eager ``TraceRecord``s
    and the vectorized engine's directly from the dense SoA ``Timeline``,
    so this exercises two genuinely independent interval extractions of
    what must be the same schedule: per-resource service, fill, bubble,
    drain (and blocked, when a ``scenario`` provides traces) are compared
    field by field.
    """
    traces = None
    if scenario is not None:
        table = build_visit_table(profile, net, sol, b)
        traces = resource_traces(net, scenario, set(table.resources))
    ev = simulate_plan(profile, net, sol, b,
                       num_microbatches=num_microbatches, policy=policy,
                       scenario=scenario, engine="event", device=device)
    vec = simulate_plan(profile, net, sol, b,
                        num_microbatches=num_microbatches, policy=policy,
                        scenario=scenario, engine="vectorized", device=device)
    ue = ev.utilization(traces=traces)
    uv = vec.utilization(traces=traces)
    if set(ue.resources) != set(uv.resources):
        raise AssertionError(
            f"resource sets differ: {set(ue.resources) ^ set(uv.resources)}")
    scale = max(ue.span, uv.span, 1e-30)
    worst = abs(ue.span - uv.span) / scale
    for res, a in ue.resources.items():
        c = uv.resources[res]
        for field in ("busy", "blocked", "fill", "bubble", "drain",
                      "first_start", "last_end"):
            worst = max(worst,
                        abs(getattr(a, field) - getattr(c, field)) / scale)
        if a.num_tasks != c.num_tasks:
            raise AssertionError(
                f"{res}: task counts differ {a.num_tasks} != {c.num_tasks}")
    return float(worst)


def random_reentrant_solution(rng: np.random.Generator,
                              profile: ModelProfile,
                              net: EdgeNetwork) -> SplitSolution:
    """A random feasible solution whose placements may repeat (co-located
    submodels) — the reentrant regime the merged-scan fixpoint covers."""
    I = profile.num_layers
    cap = min(I, 6)
    K = int(rng.integers(2, cap + 1))
    inner = np.sort(rng.choice(np.arange(1, I), size=K - 1, replace=False))
    cuts = tuple(int(c) for c in inner) + (I,)
    servers = rng.integers(1, len(net.nodes), size=K - 1)
    sol = SplitSolution(cuts, (0,) + tuple(int(s) for s in servers))
    validate_solution(sol, profile, net)
    return sol
