"""Resource-fluctuation robustness (Fig. 6).

Edge resources fluctuate during training: the plan is computed on
*measured* conditions but runs under *actual* ones.  ``mode="iid"`` (the
paper's Fig. 6 model): each draw perturbs the whole network once by
Gaussian multiplicative noise of a given coefficient of variation and
evaluates the fixed plan's analytical Eq. (14) latency on the host.

``mode="trace"`` (a time-varying scenario run through the discrete-event
simulator, ``sim.simulate_plan``) waits for ROADMAP Queue 1 item 4b and
raises.
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
                               seed: int = 0,
                               mode: str = "iid") -> FluctuationReport:
    """The plan's latency over ``draws`` networks perturbed by
    ``net.with_fluctuation`` from ``numpy.random.default_rng(seed)``."""
    if mode == "trace":
        raise NotImplementedError(
            "mode='trace' runs the plan in the discrete-event simulator "
            "under sampled traces, which is not ported yet (ROADMAP "
            "Queue 1 item 4b)")
    if mode != "iid":
        raise ValueError(f"unknown mode {mode!r}")
    rng = np.random.default_rng(seed)
    baseline = plan.L_t
    lats = np.asarray([
        L.total_latency(profile, net.with_fluctuation(rng, cv),
                        plan.solution, plan.b, plan.B)
        for _ in range(draws)])
    return FluctuationReport(
        cv=cv, mean_latency=float(lats.mean()), std_latency=float(lats.std()),
        p95_latency=float(np.percentile(lats, 95)),
        planned_latency=float(baseline),
        degradation=float(lats.mean() / baseline) if baseline > 0 else 1.0)
