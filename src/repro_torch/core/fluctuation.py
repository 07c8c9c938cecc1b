"""Resource-fluctuation robustness (Fig. 6).

Edge resources fluctuate during training: the plan is computed on
*measured* conditions but runs under *actual* ones.  ``mode="iid"`` (the
paper's Fig. 6 model): each draw perturbs the whole network once by
Gaussian multiplicative noise of a given coefficient of variation and
evaluates the fixed plan's analytical Eq. (14) latency on the host.

``mode="trace"``: each draw builds a time-varying capacity scenario
(piecewise-constant i.i.d. resampling or Gauss-Markov drift, per
``trace_model``) from ``numpy.random.default_rng((seed, d))`` and runs the
plan in the discrete-event simulator (``sim.simulate_plan``,
``engine="auto"``) on ``device``, so conditions drift during the pipeline.
The baseline is then the simulated deterministic run.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import latency as L
from .bcd import Plan
from .network import EdgeNetwork
from .profiles import ModelProfile


@dataclasses.dataclass
class FluctuationReport:
    cv: float
    mean_latency: float
    std_latency: float
    p95_latency: float
    planned_latency: float
    degradation: float       # mean / planned

    def row(self):
        return (self.cv, self.mean_latency, self.std_latency,
                self.p95_latency, self.planned_latency, self.degradation)


def evaluate_under_fluctuation(profile: ModelProfile, net: EdgeNetwork,
                               plan: Plan, cv: float, *, draws: int = 32,
                               seed: int = 0, mode: str = "iid",
                               trace_model: str = "piecewise",
                               dt: float | None = None,
                               horizon: float | None = None,
                               corr: float = 0.9,
                               device="cuda") -> FluctuationReport:
    """The plan's latency over ``draws`` perturbed networks: perturbed once
    by ``net.with_fluctuation`` from ``numpy.random.default_rng(seed)``
    (``mode="iid"``, host arithmetic), or under a sampled capacity trace in
    the simulator on ``device`` (``mode="trace"``)."""
    lats = []
    baseline = plan.L_t
    if mode == "iid":
        rng = np.random.default_rng(seed)
        for _ in range(draws):
            lats.append(L.total_latency(profile, net.with_fluctuation(rng, cv),
                                        plan.solution, plan.b, plan.B))
    elif mode == "trace":
        # deferred: sim imports core
        from ..sim import (gauss_markov_scenario, piecewise_cv_scenario,
                           simulate_plan)
        planned = plan.L_t if np.isfinite(plan.L_t) and plan.L_t > 0 else 1.0
        if dt is None:
            dt = max(planned / 32.0, 1e-9)         # ~32 epochs per run
        if horizon is None:
            horizon = 4.0 * planned                # slack for degraded runs
        if dt <= 0 or horizon <= 0:
            raise ValueError("dt and horizon must be positive")
        # the simulated deterministic run: co-located submodels (where FIFO
        # execution deviates from Eq. 14) report no degradation at cv = 0
        baseline = simulate_plan(profile, net, plan.solution, plan.b,
                                 B=plan.B, engine="auto", device=device).L_t
        for d in range(draws):
            r = np.random.default_rng((seed, d))
            if trace_model == "piecewise":
                scen = piecewise_cv_scenario(net, cv, r, dt=dt,
                                             horizon=horizon)
            elif trace_model == "gauss_markov":
                scen = gauss_markov_scenario(net, cv, r, dt=dt,
                                             horizon=horizon, corr=corr)
            else:
                raise ValueError(f"unknown trace_model {trace_model!r}")
            rep = simulate_plan(profile, net, plan.solution, plan.b,
                                B=plan.B, scenario=scen, engine="auto",
                                device=device)
            lats.append(rep.L_t)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    lats = np.asarray(lats)
    return FluctuationReport(
        cv=cv, mean_latency=float(lats.mean()), std_latency=float(lats.std()),
        p95_latency=float(np.percentile(lats, 95)),
        planned_latency=float(baseline),
        degradation=float(lats.mean() / baseline) if baseline > 0 else 1.0)
