"""Seeded, shrinking scenario fuzzer — production failure families over the
``NetworkScenario`` primitives, plus the standing event-vs-vectorized
differential oracle.  The port of ``repro/sim/fuzz.py``.

The fuzzer *composes* the scenario primitives into the failure families
edge deployments exhibit: regional degradation (one cause scaling a node
subset and every link touching it), flapping links (square waves),
adversarially-timed outages on the plan's bottleneck resource,
stragglers, hard outages, Gauss-Markov drift, and the opt-in memory
pressure.  Windows scale to the instance's closed-form timescale so fuzzed
events land inside the run.  Every draw comes from the caller's
``numpy.random.Generator`` in the reference's order, so one seed gives the
reference's scenario (equal as :func:`scenario_to_dict`).

Every fuzzed trace returns to positive capacity (``NetworkScenario.drains``)
unless ``FuzzConfig(allow_dead=True)`` asks for the one shape the
vectorized engine refuses, to exercise the ``engine="auto"`` fallback.

A :class:`FuzzCase` couples a deterministic instance (regenerated from its
seed) with the fuzzed scenario; :func:`check_parity` replays it through the
heap event engine on the host and the auto-dispatched vectorized engine on
``device`` and reports the completion-time gap — the differential oracle
:func:`run_fuzz` sweeps.  :func:`shrink_case` minimizes a failing case and
:func:`save_case` persists it in the reference's corpus schema
(``tests/corpus/``), which both packages read and write.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np

from .._device import resolve_device
from ..core import latency as L
from ..core.network import EdgeNetwork, make_edge_network
from ..core.profiles import random_profile
from .engine import build_visit_table, resource_trace, simulate_plan
from .scenario import NetworkScenario, PiecewiseTrace
from .validate import (TOPOLOGIES, random_chain_solution,
                       random_reentrant_solution)

__all__ = [
    "FuzzConfig", "FuzzCase", "ParityResult", "FuzzSummary",
    "FAMILIES", "ALL_FAMILIES",
    "fuzz_scenario", "fuzz_scenario_weighted", "fuzz_case",
    "fuzz_event_stream", "check_parity",
    "run_fuzz", "shrink_case", "save_case", "load_case", "load_corpus",
    "scenario_to_dict", "scenario_from_dict", "case_instance",
]

#: failure families the fuzzer samples from (see module docstring)
FAMILIES = ("degradation", "flapping", "outage", "straggler", "drift",
            "adversarial")

#: every family, including the opt-in "mem_pressure" (a co-tenant claiming
#: part of a node's memory — no timing effect, so it is excluded from the
#: default tuple to keep every historical seeded stream byte-identical;
#: enable via ``FuzzConfig(families=ALL_FAMILIES)``)
ALL_FAMILIES = FAMILIES + ("mem_pressure",)


@dataclasses.dataclass(frozen=True)
class FuzzConfig:
    """Knobs for one fuzzing campaign.

    ``horizon`` is the *fallback* timescale (seconds) used when no plan is
    given; with a plan, windows scale to the instance's closed-form total
    latency so perturbations overlap the simulated run.  ``allow_dead``
    permits non-draining traces (zero trailing capacity) — event-engine-only
    instances, off by default so fuzzed makespans are always finite.
    """
    families: tuple = FAMILIES
    min_events: int = 1
    max_events: int = 3
    horizon: float = 8.0
    allow_dead: bool = False
    policies: tuple = ("fifo", "1f1b")


# ---------------------------------------------------------------------------
# Failure-family samplers
# ---------------------------------------------------------------------------

def _links(net: EdgeNetwork) -> list:
    """Directed (a, c) pairs with positive effective rate."""
    n = len(net.nodes)
    return [(a, c) for a in range(n) for c in range(n)
            if a != c and net.rate[a, c] > 0]


def _window(rng: np.random.Generator, t_scale: float) -> tuple:
    """A perturbation window inside ~[0, 2 * t_scale)."""
    start = float(rng.uniform(0.0, 1.2)) * t_scale
    dur = float(rng.uniform(0.05, 0.8)) * t_scale
    return start, start + dur


def _timescale(profile, net, sol, b, num_microbatches) -> float:
    """Closed-form makespan estimate — the unit all fuzz windows scale by."""
    try:
        t = L.fill_latency(profile, net, sol, b) + \
            max(num_microbatches - 1, 0) * \
            L.pipeline_interval(profile, net, sol, b)
    except Exception:
        return 1.0
    return t if math.isfinite(t) and t > 0 else 1.0


def _bottleneck_resource(profile, net, sol, b) -> tuple:
    """The resource with the largest per-micro-batch service under nominal
    capacities — where an adversarially-timed outage hurts most."""
    table = build_visit_table(profile, net, sol, b)
    totals: dict = {}
    for v, res in enumerate(table.resources):
        tr = resource_trace(net, None, res)
        cap = tr.values[0]
        d = float(table.fixed[v]) + \
            (float(table.work[v]) / cap if cap > 0 else 0.0)
        totals[res] = totals.get(res, 0.0) + d
    return max(totals, key=totals.get)


def _sev(rng: np.random.Generator, lo: float, hi: float, tilt: float,
         worse: str) -> tuple:
    """One severity draw on ``[lo, hi)``, optionally tilted toward the
    *worse* end (``"high"`` or ``"low"``), as ``(value, log_lr)``.

    ``tilt=1`` is exactly ``rng.uniform(lo, hi)`` (same single RNG call,
    zero log-likelihood-ratio), so untilted streams stay byte-identical to
    the historical sampler.  ``tilt>1`` draws the unit coordinate from
    ``Beta(tilt, 1)`` (inverse CDF of one ``rng.random()``), concentrating
    mass near the worse end; the returned ``log_lr`` is
    ``log p(x) - log q(x)`` for the uniform nominal law ``p``."""
    if tilt == 1.0:
        return float(rng.uniform(lo, hi)), 0.0
    u = max(float(rng.random()) ** (1.0 / tilt), 1e-12)
    log_lr = -(math.log(tilt) + (tilt - 1.0) * math.log(u))
    x = u if worse == "high" else 1.0 - u
    return lo + (hi - lo) * x, log_lr


def _fuzz_scenario_impl(rng: np.random.Generator, net: EdgeNetwork,
                        config: FuzzConfig, *, profile, sol, b,
                        num_microbatches: int, family_probs=None,
                        severity_tilt: float = 1.0) -> tuple:
    """Shared sampler behind :func:`fuzz_scenario` (nominal law) and
    :func:`fuzz_scenario_weighted` (tilted proposal).  Returns
    ``(scenario, log_likelihood_ratio)``; the nominal path (no
    ``family_probs``, ``severity_tilt=1``) consumes the RNG stream
    byte-identically to the historical sampler and returns ``log_lr=0``."""
    planful = profile is not None and sol is not None and b is not None
    t_scale = _timescale(profile, net, sol, b, num_microbatches) \
        if planful else config.horizon
    families = [f for f in config.families
                if f != "adversarial" or planful]
    if not families:
        raise ValueError("no applicable failure families")
    links = _links(net)
    scen = NetworkScenario()
    log_lr = 0.0
    n_events = int(rng.integers(config.min_events, config.max_events + 1))
    for _ in range(n_events):
        if family_probs is None:
            fam = families[int(rng.integers(len(families)))]
        else:
            j = int(rng.choice(len(families), p=family_probs))
            fam = families[j]
            log_lr += math.log(1.0 / len(families)) - \
                math.log(family_probs[j])
        start, end = _window(rng, t_scale)
        if fam == "degradation":
            n_nodes = len(net.nodes)
            k = int(rng.integers(1, min(3, n_nodes) + 1))
            region = [int(i) for i in
                      rng.choice(n_nodes, size=k, replace=False)]
            touched = [lk for lk in links
                       if lk[0] in region or lk[1] in region]
            factor, lw = _sev(rng, 0.05, 0.6, severity_tilt, "low")
            scen = scen.with_region_degradation(region, touched, start, end,
                                                factor=factor)
            log_lr += lw
        elif fam == "flapping" and links:
            a, c = links[int(rng.integers(len(links)))]
            period = float(rng.uniform(0.05, 0.25)) * t_scale
            duty, lw = _sev(rng, 0.3, 0.7, severity_tilt, "low")
            scen = scen.with_flapping(
                a, c, start, end, period=period, duty=duty,
                low=float(rng.choice([0.0, 0.1])))
            log_lr += lw
        elif fam == "outage" and links:
            a, c = links[int(rng.integers(len(links)))]
            scen = scen.with_outage(a, c, start, end)
        elif fam == "straggler":
            node = int(rng.integers(len(net.nodes)))
            slowdown, lw = _sev(rng, 2.0, 16.0, severity_tilt, "high")
            scen = scen.with_straggler(node, start, end, slowdown=slowdown)
            log_lr += lw
        elif fam == "drift":
            from .scenario import gauss_markov
            cv, lw = _sev(rng, 0.1, 0.5, severity_tilt, "high")
            tr = gauss_markov(rng, cv=cv, dt=t_scale / 16,
                              horizon=2 * t_scale, corr=0.9)
            log_lr += lw
            if rng.random() < 0.5 or not links:
                node = int(rng.integers(len(net.nodes)))
                nm = dict(scen.node_mult)
                nm[node] = nm[node] * tr if node in nm else tr
                scen = dataclasses.replace(scen, node_mult=nm)
            else:
                a, c = links[int(rng.integers(len(links)))]
                lm = dict(scen.link_mult)
                lm[(a, c)] = lm[(a, c)] * tr if (a, c) in lm else tr
                scen = dataclasses.replace(scen, link_mult=lm)
        elif fam == "mem_pressure":
            node = int(rng.integers(len(net.nodes)))
            factor, lw = _sev(rng, 0.25, 0.9, severity_tilt, "low")
            scen = scen.with_mem_pressure(node, start, end, factor)
            log_lr += lw
        elif fam == "adversarial":
            res = _bottleneck_resource(profile, net, sol, b)
            t_fill = L.fill_latency(profile, net, sol, b)
            if not (math.isfinite(t_fill) and t_fill > 0):
                t_fill = t_scale
            a_start = float(rng.uniform(0.5, 1.2)) * t_fill
            a_end = a_start + float(rng.uniform(0.2, 0.8)) * t_fill
            if res[0] in ("fwd", "bwd"):
                scen = scen.with_outage(res[1], res[2], a_start, a_end)
            else:
                scen = scen.with_straggler(res[1], a_start, a_end,
                                           slowdown=50.0)
    if config.allow_dead and rng.random() < 0.5 and links:
        # opt-in: a trailing-zero trace (outage that never lifts) — the one
        # shape the vectorized engine refuses; exercises the auto fallback
        a, c = links[int(rng.integers(len(links)))]
        dead = PiecewiseTrace((0.0, float(rng.uniform(0.1, 0.9)) * t_scale),
                              (1.0, 0.0))
        lm = dict(scen.link_mult)
        lm[(a, c)] = lm[(a, c)] * dead if (a, c) in lm else dead
        scen = dataclasses.replace(scen, link_mult=lm)
    if not config.allow_dead:
        assert scen.drains(), "fuzzer invariant: scenarios must drain"
    return scen, log_lr


def fuzz_scenario(rng: np.random.Generator, net: EdgeNetwork,
                  config: FuzzConfig = FuzzConfig(), *, profile=None,
                  sol=None, b: int | None = None,
                  num_microbatches: int = 4) -> NetworkScenario:
    """Compose ``min_events..max_events`` sampled failure families into one
    scenario.  With a plan (``profile``/``sol``/``b``), windows scale to the
    closed-form run length and the ``adversarial`` family targets the plan's
    bottleneck resource; without one, that family is skipped and windows use
    ``config.horizon``.
    """
    scen, _ = _fuzz_scenario_impl(rng, net, config, profile=profile, sol=sol,
                                  b=b, num_microbatches=num_microbatches)
    return scen


def fuzz_scenario_weighted(rng: np.random.Generator, net: EdgeNetwork,
                           config: FuzzConfig = FuzzConfig(), *,
                           profile=None, sol=None, b: int | None = None,
                           num_microbatches: int = 4, family_tilt=None,
                           severity_tilt: float = 1.0) -> tuple:
    """Importance-sampled :func:`fuzz_scenario`: draw from a *tilted*
    proposal and return ``(scenario, weight)`` with the likelihood-ratio
    weight ``p(scenario) / q(scenario)`` against the nominal fuzzer law.

    ``family_tilt`` maps failure-family name -> relative proposal mass
    (unnormalized; families absent from the map keep mass 1), so e.g.
    ``{"outage": 4.0}`` over-draws outages 4x while the weights keep every
    downstream weighted statistic unbiased.  ``severity_tilt > 1`` tilts
    each family's magnitude draw toward its damaging end (low degradation
    factor, high straggler slowdown, ...) via a ``Beta(tilt, 1)`` unit
    coordinate.  Both tilts compose: the joint weight is the product of the
    per-event family and severity ratios.  ``family_tilt=None`` with
    ``severity_tilt=1`` recovers :func:`fuzz_scenario` exactly (same RNG
    stream, weight 1).

    Feed the weights to ``sim.robustness.cvar`` / ``score_plan`` —
    see ``importance_scenario_distribution(kind_tilt=..., severity_tilt=...)``
    for the distribution-level wrapper that also tilts event counts."""
    if severity_tilt <= 0:
        raise ValueError("severity_tilt must be > 0")
    family_probs = None
    if family_tilt:
        planful = profile is not None and sol is not None and b is not None
        families = [f for f in config.families
                    if f != "adversarial" or planful]
        unknown = set(family_tilt) - set(config.families)
        if unknown:
            raise ValueError(f"family_tilt names unknown families "
                             f"{sorted(unknown)}; config has "
                             f"{sorted(config.families)}")
        if any(v <= 0 for v in family_tilt.values()):
            raise ValueError("family_tilt masses must be > 0")
        q = np.asarray([float(family_tilt.get(f, 1.0)) for f in families])
        family_probs = q / q.sum()
    scen, log_lr = _fuzz_scenario_impl(
        rng, net, config, profile=profile, sol=sol, b=b,
        num_microbatches=num_microbatches, family_probs=family_probs,
        severity_tilt=severity_tilt)
    return scen, float(math.exp(log_lr))


# ---------------------------------------------------------------------------
# Cases: deterministic instance + fuzzed scenario, (de)serializable
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FuzzCase:
    """One differential-oracle input.  The (profile, net, sol) instance is
    regenerated deterministically from ``seed``/``reentrant`` by
    :func:`case_instance`; the scenario rides along explicitly so a shrunk
    case stays reproducible byte-for-byte."""
    seed: int
    reentrant: bool
    b: int
    num_microbatches: int
    policy: str
    scenario: NetworkScenario
    note: str = ""

    def to_dict(self) -> dict:
        if self.scenario.replan_triggers:
            raise ValueError("replan triggers are not serializable")
        return {"format": "repro.sim.fuzz/1", "seed": self.seed,
                "reentrant": self.reentrant, "b": self.b,
                "num_microbatches": self.num_microbatches,
                "policy": self.policy, "note": self.note,
                "scenario": scenario_to_dict(self.scenario)}

    @classmethod
    def from_dict(cls, d: dict) -> "FuzzCase":
        if d.get("format") != "repro.sim.fuzz/1":
            raise ValueError(f"unknown corpus format {d.get('format')!r}")
        return cls(seed=int(d["seed"]), reentrant=bool(d["reentrant"]),
                   b=int(d["b"]),
                   num_microbatches=int(d["num_microbatches"]),
                   policy=str(d["policy"]), note=str(d.get("note", "")),
                   scenario=scenario_from_dict(d["scenario"]))


def _trace_to_dict(tr: PiecewiseTrace) -> dict:
    return {"times": list(tr.times), "values": list(tr.values)}


def _trace_from_dict(d: dict) -> PiecewiseTrace:
    return PiecewiseTrace(tuple(float(t) for t in d["times"]),
                          tuple(float(v) for v in d["values"]))


def scenario_to_dict(scen: NetworkScenario) -> dict:
    """JSON-safe scenario encoding (capacity multipliers only; replan
    triggers carry arbitrary event objects and are rejected)."""
    if scen.replan_triggers:
        raise ValueError("replan triggers are not serializable")
    out = {
        "node_mult": {str(n): _trace_to_dict(tr)
                      for n, tr in sorted(scen.node_mult.items())},
        "link_mult": {f"{a},{c}": _trace_to_dict(tr)
                      for (a, c), tr in sorted(scen.link_mult.items())},
    }
    if scen.mem_mult:            # omitted when empty: corpus back-compat
        out["mem_mult"] = {str(n): _trace_to_dict(tr)
                           for n, tr in sorted(scen.mem_mult.items())}
    return out


def scenario_from_dict(d: dict) -> NetworkScenario:
    node_mult = {int(n): _trace_from_dict(tr)
                 for n, tr in d.get("node_mult", {}).items()}
    link_mult = {}
    for key, tr in d.get("link_mult", {}).items():
        a, c = key.split(",")
        link_mult[(int(a), int(c))] = _trace_from_dict(tr)
    mem_mult = {int(n): _trace_from_dict(tr)
                for n, tr in d.get("mem_mult", {}).items()}
    return NetworkScenario(node_mult=node_mult, link_mult=link_mult,
                           mem_mult=mem_mult)


def _instance_from_rng(rng: np.random.Generator, seed: int, reentrant: bool):
    num_layers = int(rng.integers(5, 11))
    num_servers = int(rng.integers(2, 5))
    num_clients = int(rng.integers(1, 4))
    profile = random_profile(rng, num_layers)
    net = make_edge_network(num_servers=num_servers, num_clients=num_clients,
                            topology=TOPOLOGIES[seed % len(TOPOLOGIES)],
                            seed=seed)
    make = random_reentrant_solution if reentrant else random_chain_solution
    # the reentrant generator can draw consecutive same-node placements
    # (invalid under Eq. 21) — redraw from the same stream, so the instance
    # stays a pure function of (seed, reentrant)
    for _ in range(32):
        try:
            return profile, net, make(rng, profile, net)
        except ValueError:
            continue
    return profile, net, random_chain_solution(rng, profile, net)


def case_instance(case: FuzzCase):
    """Regenerate the deterministic (profile, net, sol) behind ``case``."""
    rng = np.random.default_rng(case.seed)
    return _instance_from_rng(rng, case.seed, case.reentrant)


def fuzz_case(seed: int, config: FuzzConfig = FuzzConfig()) -> FuzzCase:
    """One seeded oracle input: instance, run shape, and fuzzed scenario.
    Same seed + config -> byte-identical case."""
    rng = np.random.default_rng(seed)
    reentrant = seed % 3 == 2
    profile, net, sol = _instance_from_rng(rng, seed, reentrant)
    b = int(rng.integers(1, 5))
    Q = int(rng.integers(2, 9))
    policy = config.policies[int(rng.integers(len(config.policies)))]
    scen = fuzz_scenario(rng, net, config, profile=profile, sol=sol, b=b,
                         num_microbatches=Q)
    return FuzzCase(seed=seed, reentrant=reentrant, b=b,
                    num_microbatches=Q, policy=policy, scenario=scen)


# ---------------------------------------------------------------------------
# The differential oracle
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParityResult:
    """Event-vs-auto replay of one case."""
    gap: float                   # max relative micro-batch completion gap
    engine: str                  # engine the auto dispatch ran
    engine_reason: str
    makespan: float
    finite: bool
    rtol: float = 1e-9

    @property
    def ok(self) -> bool:
        return self.finite and self.gap <= self.rtol


def check_parity(case: FuzzCase, *, rtol: float = 1e-9,
                 device="cuda") -> ParityResult:
    """Replay ``case`` through the exact heap event engine (on the host) and
    the auto-dispatched vectorized engine (on ``device``); report the
    completion-time gap.  When auto falls back to the event engine
    (non-draining trace, fixpoint non-convergence) the gap is trivially 0
    and ``engine``/``engine_reason`` say why."""
    dev = resolve_device(device)
    profile, net, sol = case_instance(case)
    kw = dict(num_microbatches=case.num_microbatches, scenario=case.scenario,
              policy=case.policy)
    ev = simulate_plan(profile, net, sol, case.b, engine="event",
                       device="cpu", **kw)
    au = simulate_plan(profile, net, sol, case.b, engine="auto", device=dev,
                       **kw)
    ev_mb = ev.mb_complete.numpy()
    au_mb = au.mb_complete.cpu().numpy()
    same = ev_mb == au_mb                             # inf == inf agrees
    with np.errstate(invalid="ignore"):
        rel = np.abs(ev_mb - au_mb) / np.maximum(np.abs(ev_mb), 1e-30)
    rel = np.where(same, 0.0, rel)
    gap = float(np.max(rel)) if rel.size else 0.0
    if math.isnan(gap):                               # inf vs finite
        gap = float("inf")
    finite = bool(math.isfinite(ev.makespan) and math.isfinite(au.makespan))
    return ParityResult(gap=gap, engine=au.engine,
                        engine_reason=au.engine_reason,
                        makespan=au.makespan, finite=finite, rtol=rtol)


@dataclasses.dataclass
class FuzzSummary:
    """Outcome of one :func:`run_fuzz` campaign."""
    trials: int
    vectorized: int              # cases the auto dispatch vectorized
    event_fallback: int          # cases auto fell back to the heap
    max_gap: float
    failures: list               # [(FuzzCase, ParityResult)] — parity broken

    @property
    def ok(self) -> bool:
        return not self.failures


def run_fuzz(trials: int, *, seed: int = 0,
             config: FuzzConfig = FuzzConfig(),
             rtol: float = 1e-9, device="cuda") -> FuzzSummary:
    """The standing differential campaign: ``trials`` seeded cases replayed
    through both engines (:func:`check_parity` on ``device``).
    Deterministic for a fixed (trials, seed, config).
    """
    dev = resolve_device(device)
    vec = fb = 0
    max_gap = 0.0
    failures: list = []
    for i in range(trials):
        case = fuzz_case(seed * 100_003 + i, config)
        res = check_parity(case, rtol=rtol, device=dev)
        if res.engine == "vectorized":
            vec += 1
        else:
            fb += 1
        max_gap = max(max_gap, res.gap)
        if not res.ok:
            failures.append((case, res))
    return FuzzSummary(trials=trials, vectorized=vec, event_fallback=fb,
                       max_gap=max_gap, failures=failures)


# ---------------------------------------------------------------------------
# Shrinking: minimize a failing case while the predicate still fails
# ---------------------------------------------------------------------------

def _trace_variants(tr: PiecewiseTrace):
    """Simpler candidate replacements for one trace, simplest first."""
    n = len(tr.times)
    if n <= 1:
        return
    yield PiecewiseTrace((0.0,), (tr.values[-1],))      # constant tail value
    yield PiecewiseTrace(tr.times[:1 + n // 2], tr.values[:1 + n // 2])
    if n > 2:                                           # decimate interior
        idx = [0] + list(range(1, n - 1, 2)) + [n - 1]
        yield PiecewiseTrace(tuple(tr.times[i] for i in idx),
                             tuple(tr.values[i] for i in idx))


def _scenario_edits(scen: NetworkScenario):
    """Candidate one-step simplifications of a scenario, biggest first."""
    for n in sorted(scen.node_mult):
        nm = {k: v for k, v in scen.node_mult.items() if k != n}
        yield dataclasses.replace(scen, node_mult=nm)
    for lk in sorted(scen.link_mult):
        lm = {k: v for k, v in scen.link_mult.items() if k != lk}
        yield dataclasses.replace(scen, link_mult=lm)
    for n in sorted(scen.node_mult):
        for var in _trace_variants(scen.node_mult[n]):
            nm = dict(scen.node_mult)
            nm[n] = var
            yield dataclasses.replace(scen, node_mult=nm)
    for lk in sorted(scen.link_mult):
        for var in _trace_variants(scen.link_mult[lk]):
            lm = dict(scen.link_mult)
            lm[lk] = var
            yield dataclasses.replace(scen, link_mult=lm)


def shrink_case(case: FuzzCase, failing, *, max_rounds: int = 16) -> FuzzCase:
    """Greedy minimization: while ``failing(case)`` stays True, try dropping
    whole multiplier traces, simplifying the survivors' breakpoints, and
    shrinking the run (fewer micro-batches, smaller b).  Deterministic; the
    result still satisfies ``failing``."""
    if not failing(case):
        raise ValueError("shrink_case needs a failing case to start from")
    for _ in range(max_rounds):
        progressed = False
        for scen in _scenario_edits(case.scenario):
            cand = dataclasses.replace(case, scenario=scen)
            if failing(cand):
                case = cand
                progressed = True
                break
        if progressed:
            continue
        for Q in (case.num_microbatches // 2, case.num_microbatches - 1):
            if Q >= 1 and Q < case.num_microbatches:
                cand = dataclasses.replace(case, num_microbatches=Q)
                if failing(cand):
                    case = cand
                    progressed = True
                    break
        if progressed:
            continue
        if case.b > 1:
            cand = dataclasses.replace(case, b=1)
            if failing(cand):
                case = cand
                continue
        break
    return case


# ---------------------------------------------------------------------------
# Corpus: persisted minimized repros, replayed by CI
# ---------------------------------------------------------------------------

def save_case(case: FuzzCase, directory: str, name: str | None = None,
              note: str | None = None) -> str:
    """Persist a (usually shrunk) case as JSON; returns the path."""
    os.makedirs(directory, exist_ok=True)
    if note is not None:
        case = dataclasses.replace(case, note=note)
    name = name or f"case_{case.seed}"
    path = os.path.join(directory, f"{name}.json")
    with open(path, "w") as f:
        json.dump(case.to_dict(), f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def load_case(path: str) -> FuzzCase:
    with open(path) as f:
        return FuzzCase.from_dict(json.load(f))


def load_corpus(directory: str) -> list:
    """All corpus cases in ``directory``, as ``[(path, FuzzCase)]``."""
    if not os.path.isdir(directory):
        return []
    out = []
    for fn in sorted(os.listdir(directory)):
        if fn.endswith(".json"):
            path = os.path.join(directory, fn)
            out.append((path, load_case(path)))
    return out


# ---------------------------------------------------------------------------
# Event-stream fuzzing: churn for the elastic coordinator
# ---------------------------------------------------------------------------

def fuzz_event_stream(rng: np.random.Generator, net: EdgeNetwork, *,
                      horizon: float, max_events: int = 3,
                      min_servers: int = 2, allow_failure: bool = True,
                      flap_fraction: float = 0.0,
                      flap_window: float | None = None) -> tuple:
    """A time-ordered tuple of ``ReplanTrigger``s drawn from the
    ``repro_torch.ft`` event vocabulary — mid-round node churn
    (``NodeFailure``), rate drops, stragglers — with indices kept valid across the renumbering each failure
    causes (the coordinator's ``degraded()`` drops a server and shifts later
    indices).  Feed to ``simulate_with_replanning``.

    ``flap_fraction`` of the drawn events (rounded down) become *flaps*: a
    ``RateChange(a, c, f)`` followed within ``flap_window`` (default
    ``horizon / 20``) by its exact reversal ``RateChange(a, c, 1/f)`` — the
    route-dampening workload a debounced replan policy exists to absorb
    (``ft.Hysteresis`` sees the pair cancel to zero cumulative
    deviation).  Flaps never stack with node failures; each flap consumes
    one drawn event slot but emits two triggers."""
    from ..ft.coordinator import NodeFailure, RateChange, Straggler
    from .scenario import ReplanTrigger
    if not 0.0 <= flap_fraction <= 1.0:
        raise ValueError("flap_fraction must be in [0, 1]")
    if flap_window is None:
        flap_window = horizon / 20.0
    n_nodes = len(net.nodes)
    times = np.sort(rng.uniform(0.05 * horizon, 0.95 * horizon,
                                int(rng.integers(1, max_events + 1))))
    n_flaps = int(math.floor(flap_fraction * len(times)))
    flap_slots = set(rng.choice(len(times), size=n_flaps, replace=False)
                     .tolist()) if n_flaps else set()
    trigs = []
    for i, t in enumerate(times):
        if i in flap_slots:
            a = int(rng.integers(n_nodes))
            c = int(rng.integers(n_nodes))
            if a == c:
                c = (c + 1) % n_nodes
            f = float(rng.uniform(0.1, 0.8))
            dt = float(rng.uniform(0.1, 1.0)) * flap_window
            if i + 1 < len(times):
                # keep the reversal before the next drawn event so a later
                # NodeFailure's renumbering can't invalidate its indices
                dt = min(dt, 0.5 * (float(times[i + 1]) - float(t)))
            trigs.append(ReplanTrigger(float(t), RateChange(a, c, f)))
            trigs.append(ReplanTrigger(float(t) + dt,
                                       RateChange(a, c, 1.0 / f)))
            continue
        kinds = ["straggler", "rate"]
        if allow_failure and n_nodes - 1 > min_servers:
            kinds.append("failure")
        kind = kinds[int(rng.integers(len(kinds)))]
        if kind == "failure":
            server = int(rng.integers(1, n_nodes))
            trigs.append(ReplanTrigger(float(t), NodeFailure(server)))
            n_nodes -= 1
        elif kind == "straggler":
            node = int(rng.integers(1, n_nodes))
            trigs.append(ReplanTrigger(
                float(t), Straggler(node, float(rng.uniform(1.5, 8.0)))))
        else:
            a = int(rng.integers(n_nodes))
            c = int(rng.integers(n_nodes))
            if a == c:
                c = (c + 1) % n_nodes
            trigs.append(ReplanTrigger(
                float(t), RateChange(a, c, float(rng.uniform(0.1, 0.8)))))
    return tuple(sorted(trigs, key=lambda tr: tr.time))
