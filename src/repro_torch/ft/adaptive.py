"""Adaptive robustness: self-tuning replan cadence and online policy search.
The port of ``repro/ft/adaptive.py``.

The best fixed :class:`~repro_torch.ft.policy.Periodic` cadence shifts with
the drift regime: slow Gauss-Markov drift wants long cadences (solves are pure
overhead), fast drift wants short ones (staleness dominates).  Picking the
cadence therefore requires offline tuning per deployment — exactly the
manual knob this module removes.

Two layers:

* :class:`DriftEstimator` + :class:`AdaptiveCadence` — estimate the
  network's *drift rate* online from the cumulative **signed**
  log-deviation level the event stream already carries (the
  ``event_deviation`` coordinate ``Hysteresis`` debounces in) and set the
  ``Periodic`` cadence from the classic drift-vs-fixed-cost balance.  If
  capacity log-deviation grows ~linearly at rate ``r`` (log-units/s) and a
  stale plan costs ``staleness_weight * deviation`` in relative latency,
  the staleness cost accrued over a window ``tau`` is ``w r tau^2 / 2``
  while each window pays one ``solve_cost`` — minimizing their sum per
  unit time gives the square-root rule
  ``tau* = sqrt(2 solve_cost / (w r))``.  Two details make this robust to
  the regimes the frontier sweeps: increments are *signed*, so a flap's
  down/up edges and mean-reverting Gauss-Markov fluctuation cancel instead
  of masquerading as drift; and the EWMA rate only counts once it clears
  ``z x`` its own standard error (tracked by a companion variance EWMA), so
  bounded noise reads as rate 0 (ride out) while a persistent trend
  switches the square-root cadence on.  The policy re-evaluates ``tau*``
  at every delivered event, so one deployment tracks the frontier across
  regimes with no per-regime tuning.

* :func:`tune_policies` — successive-halving search over a grid of
  Hysteresis / RateLimited / AdaptiveCadence knobs, driven by
  :func:`repro_torch.ft.policy.evaluate_policies` on fuzzed event-stream
  corpora (``sim.fuzz_event_stream``).  Rounds replay geometrically growing
  stream batches, prune by CVaR-blended confidence bounds, and cache the
  winner per network signature so repeated tuning on the same deployment
  is free.

>>> est = DriftEstimator(halflife=1.0)
>>> for t in range(8):              # a consistent 0.2 log-dev/s ramp...
...     _ = est.observe(0.2 * t, float(t))
>>> round(est.rate, 2)              # ...reads as significant drift
0.2
>>> est2 = DriftEstimator(halflife=1.0)
>>> for t in range(8):              # a flapping level has no net drift
...     _ = est2.observe(0.3 * (t % 2), float(t))
>>> est2.rate
0.0
>>> p = AdaptiveCadence(solve_cost=0.05, staleness_weight=1.0)
>>> p.cadence                       # no drift observed yet -> ride out
inf
>>> p.estimator = est               # drifting at 0.2/s:
>>> 0.5 < p.cadence < 0.9           # ~sqrt(2 * 0.05 / (1.0 * 0.2)) = 0.71
True
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np

from .. import obs
from .._device import resolve_device
from .policy import (Hysteresis, PolicyDecision, RateLimited,
                             ReplanPolicy, evaluate_policies,
                             event_deviation)

__all__ = ["DriftEstimator", "AdaptiveCadence", "TuneResult",
           "default_tuning_grid", "tune_policies", "network_signature",
           "clear_tune_cache"]


class DriftEstimator:
    """Significance-gated EWMA drift-rate estimator over the cumulative
    *signed* log-deviation level.

    Each observation is the current cumulative signed deviation ``level``
    (log units — the coordinate :func:`repro_torch.ft.policy.event_deviation`
    measures in) at a simulated time; the rate sample is the signed
    increment ``(level - prev_level) / dt``.  Two EWMAs with time-aware
    decay (an old estimate loses half its weight every ``halflife``
    seconds) track the sample mean and variance; :attr:`rate` reports the
    mean only when it is *significantly* positive — above ``z x`` the
    EWMA's own standard error.  Mean-reverting fluctuation and flap pairs
    produce zero-mean increments with large variance, so they read as rate
    0 (ride out); a persistent capacity trend produces consistent samples
    that clear the gate.

    ``rebase`` forgets the level reference (call after a replan, when the
    deviation coordinate restarts from the fresh plan) while *keeping* the
    learned rate statistics, so the cadence stays stable across replans.
    Non-finite levels (node failures, topology renumbering) are ignored —
    those are topological events, not drift.
    """

    def __init__(self, halflife: float = 1.0, z: float = 2.0,
                 initial_rate: float = 0.0, min_samples: int = 3):
        if halflife <= 0:
            raise ValueError("halflife must be > 0 (seconds)")
        if z < 0:
            raise ValueError("z must be >= 0 (significance gate)")
        if initial_rate < 0:
            raise ValueError("initial_rate must be >= 0")
        if min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        self.halflife = float(halflife)
        self.z = float(z)
        self.initial_rate = float(initial_rate)
        self.min_samples = int(min_samples)
        self._mean = float(initial_rate)  # EWMA of signed rate samples
        self._var = 0.0                   # EWMA of squared residuals
        self._w2 = 0.0                    # sum of squared EWMA weights
        self._n = 0                       # rate samples folded in
        self._prev: tuple | None = None   # (level, time)

    def observe(self, level: float, time: float) -> float:
        """Fold one cumulative-deviation level in; returns the gated rate."""
        if not math.isfinite(level):
            return self.rate
        prev = self._prev
        self._prev = (float(level), float(time))
        if prev is None:
            return self.rate
        dt = max(float(time) - prev[1], 1e-6 * self.halflife)
        sample = (float(level) - prev[0]) / dt
        w = 0.5 ** (dt / self.halflife)
        self._var = w * self._var + (1.0 - w) * (sample - self._mean) ** 2
        self._mean = w * self._mean + (1.0 - w) * sample
        self._w2 = w * w * self._w2 + (1.0 - w) ** 2
        self._n += 1
        return self.rate

    @property
    def rate(self) -> float:
        """Drift rate (log-dev/s): |EWMA mean| when significantly nonzero,
        else 0 (noise — ride it out).  Two-sided: capacity degrading *or*
        recovering both stale the incumbent plan.  Fewer than
        ``min_samples`` increments is never significant — a single large
        sample (e.g. one flap reversal) can clear any ``z x SE`` bound
        because the variance EWMA is still anchored at its initialization."""
        if self._n < self.min_samples:
            return 0.0
        se = math.sqrt(max(self._var, 0.0) * self._w2)
        m = abs(self._mean)
        return m if m > self.z * se else 0.0

    def rebase(self) -> None:
        """Forget the level reference (the deviation coordinate restarted,
        e.g. after a replan) but keep the learned rate statistics."""
        self._prev = None

    def reset(self) -> None:
        self._mean = self.initial_rate
        self._var = 0.0
        self._w2 = 0.0
        self._n = 0
        self._prev = None

    def __repr__(self):
        return (f"DriftEstimator(halflife={self.halflife!r}, z={self.z!r}, "
                f"rate={self.rate:.4g})")


def _signed_net_deviations(ref, net) -> dict:
    """Per-resource signed log capacity ratios of ``net`` vs ``ref`` — the
    vector form of :func:`repro_torch.ft.policy.net_deviation`, keyed like
    ``event_deviation``.  Empty when shapes differ (renumbered topology)."""
    if ref is None or len(ref.nodes) != len(net.nodes):
        return {}
    out = {}
    for i, (a, b) in enumerate(zip(ref.nodes, net.nodes)):
        if a.f > 0 and b.f > 0:
            out[("node", i)] = math.log(b.f / a.f)
    pos = np.argwhere((ref.rate > 0) & (net.rate > 0))
    for i, j in pos:
        out[("link", int(i), int(j))] = float(
            math.log(net.rate[i, j] / ref.rate[i, j]))
    return out


class AdaptiveCadence(ReplanPolicy):
    """``Periodic`` whose cadence is set online by the square-root rule.

    The cumulative signed deviation level is harvested from the events
    themselves: ``Resync`` measurement snapshots contribute per-resource
    signed log capacity ratios against the snapshot the incumbent was last
    replanned at (:func:`_signed_net_deviations`), and discrete
    ``RateChange`` / ``Straggler`` events accumulate their signed
    ``event_deviation`` per resource — the same coordinate system
    ``Hysteresis`` debounces in.  The level fed to the
    :class:`DriftEstimator` is the worst (largest-|.|) resource's signed
    deviation; its significantly-positive increments are drift, everything
    else is noise.  Node failures replan immediately and invalidate the
    snapshot reference (indices renumber).

    A severe capacity *step* needs no special casing: the jump lands as one
    huge level increment, the estimator's rate spikes, and the cadence
    collapses — the next event replans.  For workloads that cannot afford
    even that one-event delay an optional debounced **step guard** — a
    :class:`~repro_torch.ft.policy.Hysteresis` on the same deviation coordinate
    (``step_threshold`` / ``step_cooldown``, trailing-edge so flaps still
    cancel) — escalates past the estimator.  It is *off* by default
    (``step_threshold=math.inf``): under mean-reverting noise the guard
    trips on transient excursions the estimator correctly rides out
    (AR(1) decorrelation is typically longer than any sane cooldown), and
    the measured cadence frontier is strictly worse with it armed.

    ``solve_cost`` is the expected per-replan downtime in simulated seconds
    (match ``solve_downtime`` + restart cost of the harness);
    ``staleness_weight`` converts drift (log-deviation) into relative
    latency cost.  With no significant drift the cadence clamps to
    ``max_cadence`` (default: ride out).
    """

    name = "adaptive_cadence"

    def __init__(self, *, solve_cost: float = 0.05,
                 staleness_weight: float = 1.0, halflife: float = 1.0,
                 z: float = 2.0, min_cadence: float = 0.0,
                 max_cadence: float = math.inf, initial_rate: float = 0.0,
                 step_threshold: float = math.inf,
                 step_cooldown: float = 0.3):
        if solve_cost <= 0:
            raise ValueError("solve_cost must be > 0 (seconds per replan)")
        if staleness_weight <= 0:
            raise ValueError("staleness_weight must be > 0")
        if min_cadence < 0 or max_cadence < min_cadence:
            raise ValueError("need 0 <= min_cadence <= max_cadence")
        self.solve_cost = float(solve_cost)
        self.staleness_weight = float(staleness_weight)
        self.min_cadence = float(min_cadence)
        self.max_cadence = float(max_cadence)
        self.estimator = DriftEstimator(halflife=halflife, z=z,
                                        initial_rate=initial_rate)
        self.step_threshold = float(step_threshold)
        self.step_cooldown = float(step_cooldown)
        self._guard = None if math.isinf(step_threshold) else \
            Hysteresis(step_threshold, cooldown=step_cooldown)
        self._last_replan = -math.inf
        self._ref_snap = None        # Resync snapshot at the last replan
        self._cum: dict = {}         # key -> cumulative signed log dev
        self._sigs: dict = {}        # last Resync's per-resource signed devs

    @property
    def cadence(self) -> float:
        """Current ``tau* = sqrt(2 c / (w r))``, clamped to the bounds."""
        r = self.estimator.rate
        if r <= 0:
            return self.max_cadence
        tau = math.sqrt(2.0 * self.solve_cost / (self.staleness_weight * r))
        return min(max(tau, self.min_cadence), self.max_cadence)

    def _ingest(self, event, time: float) -> None:
        from .coordinator import Resync
        if isinstance(event, Resync):
            if self._ref_snap is None:
                self._ref_snap = event.net
            self._sigs = _signed_net_deviations(self._ref_snap, event.net)
        else:
            key, d = event_deviation(event)
            if math.isfinite(d):
                self._cum[key] = self._cum.get(key, 0.0) + d
        levels = {**self._cum, **self._sigs}
        level = max(levels.values(), key=abs) if levels else 0.0
        self.estimator.observe(level, time)

    def decide(self, event, time, coord) -> PolicyDecision:
        from .coordinator import NodeFailure
        if isinstance(event, NodeFailure):
            return PolicyDecision.do_replan("adaptive: node failure")
        if self._last_replan == -math.inf:
            # the incumbent was solved at stream start: the first cadence
            # window opens at t = 0, not at the first delivered event
            self._last_replan = 0.0
        self._ingest(event, time)
        if self._guard is not None:
            g = self._guard.decide(event, time, coord)
            if g.replan:
                return PolicyDecision.do_replan(
                    f"adaptive: step guard [{g.reason}]")
        tau = self.cadence
        if time - self._last_replan >= tau:
            return PolicyDecision.do_replan(
                f"adaptive: cadence {tau:.3g}s elapsed "
                f"(drift {self.estimator.rate:.3g}/s)")
        return PolicyDecision.absorb(
            f"adaptive: inside cadence window ({tau:.3g}s)")

    def observe(self, outcome, time) -> None:
        from .coordinator import NodeFailure, Resync
        if self._guard is not None:
            self._guard.observe(outcome, time)
        if outcome.action in ("replan", "microbatch"):
            self._last_replan = time
            obs.inc("ft.adaptive.replans")
            # the deviation coordinate restarts at the fresh plan; the
            # learned drift statistics survive (rebase, not reset)
            self._cum.clear()
            self._sigs.clear()
            self.estimator.rebase()
            if isinstance(outcome.event, Resync):
                self._ref_snap = outcome.event.net
        if isinstance(outcome.event, NodeFailure):
            self._ref_snap = None    # renumbered topology: stale reference
            self._cum.clear()
            self._sigs.clear()
            self.estimator.rebase()

    def reset(self) -> None:
        self.estimator.reset()
        if self._guard is not None:
            self._guard.reset()
        self._last_replan = -math.inf
        self._ref_snap = None
        self._cum.clear()
        self._sigs.clear()

    def __repr__(self):
        return (f"AdaptiveCadence(solve_cost={self.solve_cost!r}, "
                f"staleness_weight={self.staleness_weight!r}, "
                f"halflife={self.estimator.halflife!r}, "
                f"z={self.estimator.z!r}, "
                f"step_threshold={self.step_threshold!r}, "
                f"step_cooldown={self.step_cooldown!r})")


# ---------------------------------------------------------------------------
# Successive-halving policy search
# ---------------------------------------------------------------------------

def network_signature(net) -> str:
    """Stable short digest of a network's numeric surface — the
    :func:`tune_policies` cache key component, so re-tuning the *same*
    deployment is a lookup while any capacity/memory/topology change
    invalidates it.

    >>> from repro_torch.core.network import make_edge_network
    >>> a = make_edge_network(num_servers=2, seed=0)
    >>> b = make_edge_network(num_servers=2, seed=0)
    >>> network_signature(a) == network_signature(b)
    True
    >>> network_signature(a) == network_signature(
    ...     make_edge_network(num_servers=2, seed=1))
    False
    """
    h = hashlib.sha1()
    rows = [(n.f, n.kappa, n.mem, n.p, n.t0, n.t1, float(n.b_th),
             float(n.is_client)) for n in net.nodes]
    h.update(np.asarray(rows, dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(net.rate, dtype=np.float64).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one :func:`tune_policies` search.

    ``best`` names the winning config in the grid the caller passed (look
    its factory up there to deploy it); ``knobs`` is the winner's repr —
    the knob settings, human-readable and cacheable.  ``leaderboard`` holds
    ``(name, score, n_streams)`` for every config, sorted best-first, with
    ``n_streams`` the number of corpus streams the config survived to see.
    """
    best: str
    knobs: str
    score: float
    alpha: float
    cvar_weight: float
    leaderboard: tuple
    rounds: tuple                # ((n_configs_alive, n_streams_total), ...)
    signature: str
    from_cache: bool = False

    def row(self) -> dict:
        return {"best": self.best, "knobs": self.knobs, "score": self.score,
                "alpha": self.alpha, "cvar_weight": self.cvar_weight,
                "rounds": [list(r) for r in self.rounds],
                "leaderboard": [list(e) for e in self.leaderboard],
                "signature": self.signature, "from_cache": self.from_cache}


def default_tuning_grid(*, solve_cost: float = 0.05) -> dict:
    """The stock knob grid: Hysteresis thresholds x cooldowns, the
    hand-picked ``RateLimited(Hysteresis(0.25, cooldown=0.3))`` point (so
    the tuner can never do worse than it on the tuning corpus), and
    AdaptiveCadence staleness weights.

    >>> g = default_tuning_grid()
    >>> "rate_limited+hyst(0.25,cd=0.3)" in g and len(g) == 10
    True
    """
    grid: dict = {}
    for thr in (0.15, 0.25, 0.4):
        for cd in (0.0, 0.3):
            grid[f"hyst(t={thr:g},cd={cd:g})"] = \
                (lambda t=thr, c=cd: Hysteresis(t, cooldown=c))
    grid["rate_limited+hyst(0.25,cd=0.3)"] = \
        (lambda: RateLimited(Hysteresis(0.25, cooldown=0.3)))
    for w in (0.5, 1.0, 2.0):
        grid[f"adaptive(w={w:g})"] = \
            (lambda k=w: AdaptiveCadence(solve_cost=solve_cost,
                                         staleness_weight=k))
    return grid


_TUNE_CACHE: dict = {}


def clear_tune_cache() -> None:
    _TUNE_CACHE.clear()


def _score_stats(makespans, alpha: float, w: float, z: float) -> tuple:
    """(score, half_width): CVaR-blended score and its normal-approx
    confidence half-width over one config's accumulated makespans."""
    from ..sim.robustness import cvar
    ms = np.asarray(makespans, dtype=float)
    score = (1.0 - w) * float(np.mean(ms)) + w * cvar(ms, alpha)
    hw = z * float(np.std(ms)) / math.sqrt(len(ms)) if len(ms) > 1 else \
        math.inf
    return score, hw


def tune_policies(profile, net, B: int, streams, *, configs: dict | None =
                  None, alpha: float = 0.9, cvar_weight: float = 0.5,
                  eta: int = 2, min_streams: int = 4, z: float = 1.0,
                  remap_penalty: float = 0.0,
                  solve_downtime: float | str = 0.0,
                  engine: str = "event", cache: bool = True,
                  device="cuda", **coordinator_kwargs) -> TuneResult:
    """Successive-halving knob search over replan-policy configs.

    ``streams`` is a corpus of event streams (``sim.fuzz_event_stream`` /
    ``sim.periodic_resync_triggers`` tuples); ``configs`` maps name ->
    zero-arg policy factory (default :func:`default_tuning_grid`).  Round
    ``r`` replays each surviving config over a geometrically growing
    prefix of the corpus (``min_streams * eta**r`` streams total, new
    streams only — makespans accumulate), scores every survivor with
    ``(1 - cvar_weight) * mean + cvar_weight * CVaR_alpha``, drops configs
    whose score lower-bound clears the best config's upper-bound
    (``z``-sigma normal bounds), then keeps at most ``ceil(alive / eta)``
    of the rest.  Ranking (and the final pick) applies a one-SE parsimony
    rule: configs statistically tied with the best — score within the best
    config's confidence half-width — are ordered by fewest replans per
    stream, so a conservative config is never displaced by a thrasher it
    cannot be distinguished from.  Ends when one config survives or the
    corpus is spent.

    Results are cached per ``(network_signature, knobs, corpus size,
    search params)`` in a module-level table (``cache=False`` bypasses;
    :func:`clear_tune_cache` empties) — counters ``ft.tune.rounds``,
    ``ft.tune.pruned``, ``ft.tune.cache_hits`` trace the search.  Every
    replay runs on ``device``, which is part of the cache key.
    """
    dev = resolve_device(device)
    if configs is None:
        sc = solve_downtime if isinstance(solve_downtime, (int, float)) \
            and solve_downtime > 0 else 0.05
        configs = default_tuning_grid(solve_cost=float(sc))
    if not configs:
        raise ValueError("configs must be a non-empty mapping")
    if not 0.0 <= cvar_weight <= 1.0:
        raise ValueError("cvar_weight must be in [0, 1]")
    if eta < 2:
        raise ValueError("eta must be >= 2")
    if min_streams < 1:
        raise ValueError("min_streams must be >= 1")
    streams = [tuple(s) for s in streams]
    if not streams:
        raise ValueError("streams must be a non-empty corpus")

    def _knobs(name):
        f = configs[name]
        return repr(f() if callable(f) else f)

    sig = network_signature(net)
    key = (sig, B, tuple(sorted((n, _knobs(n)) for n in configs)),
           len(streams), alpha, cvar_weight, eta, min_streams, z,
           remap_penalty, repr(solve_downtime), engine,
           repr(sorted(coordinator_kwargs.items())), str(dev))
    if cache and key in _TUNE_CACHE:
        obs.inc("ft.tune.cache_hits")
        return dataclasses.replace(_TUNE_CACHE[key], from_cache=True)

    alive = dict(configs)
    acc: dict = {name: [] for name in configs}
    seen: dict = {name: 0 for name in configs}
    repl: dict = {name: 0 for name in configs}
    consumed = 0
    rounds = []
    r = 0

    def _rank_key(n, stats):
        # one-SE rule: configs statistically tied with the best (score
        # within the best's confidence half-width) rank by *parsimony* —
        # fewest replans per stream — so a conservative config is never
        # displaced by a noisy thrasher it cannot be distinguished from
        s, _hw = stats[n]
        s_best, hw_best = min(stats.values())
        tied = s <= s_best + hw_best
        rps = repl[n] / max(seen[n], 1)
        return (0, rps, s) if tied else (1, s, s)
    # always run at least one round, even for a single-config grid
    while consumed < len(streams) and (len(alive) > 1 or consumed == 0):
        target = min(len(streams), min_streams * eta ** r)
        r += 1
        batch = streams[consumed:target]
        if batch:
            reports = evaluate_policies(
                profile, net, B, batch, alive, alpha=alpha,
                remap_penalty=remap_penalty, solve_downtime=solve_downtime,
                engine=engine, device=dev, **coordinator_kwargs)
            for name, rep in reports.items():
                acc[name].extend(rep.makespans)
                seen[name] += len(batch)
                repl[name] += rep.replans
        consumed = target
        obs.inc("ft.tune.rounds")
        stats = {n: _score_stats(acc[n], alpha, cvar_weight, z)
                 for n in alive}
        best_up = min(s + hw for s, hw in stats.values())
        confident = {n for n, (s, hw) in stats.items() if s - hw > best_up}
        ranked = sorted((n for n in alive if n not in confident),
                        key=lambda n: _rank_key(n, stats))
        cap = max(1, math.ceil(len(alive) / eta))
        survivors = set(ranked[:cap])
        dropped = len(alive) - len(survivors)
        if dropped:
            obs.inc("ft.tune.pruned", dropped)
        alive = {n: alive[n] for n in alive if n in survivors}
        rounds.append((len(alive), consumed))

    final = {n: _score_stats(acc[n], alpha, cvar_weight, z)[0]
             for n in acc if acc[n]}
    board = tuple(sorted(((n, s, seen[n]) for n, s in final.items()),
                         key=lambda e: e[1]))
    fstats = {n: _score_stats(acc[n], alpha, cvar_weight, z) for n in alive}
    best = min(alive, key=lambda n: _rank_key(n, fstats))
    result = TuneResult(best=best, knobs=_knobs(best), score=final[best],
                        alpha=alpha, cvar_weight=cvar_weight,
                        leaderboard=board, rounds=tuple(rounds),
                        signature=sig)
    if cache:
        _TUNE_CACHE[key] = result
    return result
