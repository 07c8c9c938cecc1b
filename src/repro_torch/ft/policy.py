"""Replanning policies — *when* should the elastic coordinator act at all?
The port of ``repro/ft/policy.py``.

``ft.Coordinator`` turns the paper's Algorithm 2 into a runtime:
every event (rate change, straggler, node failure) triggers a BCD re-solve.
That is the right reflex for a one-shot failure, but production event
streams are *noisy*: a flapping link emits a rate-change per square-wave
edge, capacity drift emits a measurement per sampling tick, and each eager
replan costs solve time, a pipeline restart (in-flight micro-batches are
discarded), and possibly a checkpoint restore.  Replanning frequency is a
resource to budget, not a free action.

A :class:`ReplanPolicy` sits between event arrival and the solve: the
coordinator's ``deliver`` consults ``decide(event, time, coord)`` and either
**replans** (``Coordinator.apply`` — the eager path) or **absorbs** the
event (``Coordinator.absorb`` — the network still mutates, the incumbent
plan rides out, indices remapped across failures; absorption escalates to a
forced replan when riding out is impossible).  After every outcome the
policy's ``observe`` hook sees what happened, which is where rate-limit
budgets and backoff state live.

The zoo:

* :class:`Eager` — replan on every event (the historical behavior).
* :class:`RideOut` — never replan voluntarily; absorb everything.
* :class:`Periodic` — replan at most once per ``cadence`` simulated
  seconds (the trace-driven replanning-cadence knob).
* :class:`Hysteresis` — debounced triggers: per-resource *cumulative*
  log-deviation since the last replan; below ``threshold`` is absorbed,
  above it arms a pending replan that only fires once the deviation has
  **persisted** for ``cooldown`` seconds (trailing-edge debounce, so a
  flapping link is suppressed), and a reversal (the link recovers, the
  cumulative deviation returns inside the band) *cancels* the pending
  replan.
* :class:`RateLimited` — wraps any inner policy with a token-bucket
  replan budget whose refill period backs off exponentially while
  consecutive replans fail to beat riding out by ``margin`` — replan
  storms degrade gracefully to ride-out instead of thrashing.
* :class:`CVaRPreSpill` — tail-risk watchdog: score the incumbent's
  CVaR on the post-event network (``sim.robustness``) and
  pre-migrate to the ``RobustMakespan``-preferred placement when the
  scored tail exceeds ``bound x`` the incumbent's nominal latency.

>>> p = Hysteresis(threshold=0.25, cooldown=1.0)
>>> p.name
'hysteresis'
>>> resolve_replan_policy("eager").name
'eager'
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .. import obs
from .._device import resolve_device

__all__ = ["PolicyDecision", "ReplanPolicy", "Eager", "RideOut", "Periodic",
           "Hysteresis", "RateLimited", "CVaRPreSpill",
           "resolve_replan_policy", "event_deviation", "net_deviation",
           "PolicyEvalReport", "evaluate_policies"]


@dataclasses.dataclass(frozen=True)
class PolicyDecision:
    """What the policy chose for one delivered event.

    ``replan=True`` routes to ``Coordinator.apply`` (full treatment:
    BCD/Theorem-1 solve, ride-out comparison); ``False`` routes to
    ``Coordinator.absorb`` (mutate the network, keep the incumbent plan).
    ``cost_model`` optionally overrides the coordinator's cost model for
    *this* replan only — how :class:`CVaRPreSpill` solves with the
    tail-risk objective while the steady state keeps the cheap one.
    """
    replan: bool
    reason: str
    cost_model: object = None

    @staticmethod
    def do_replan(reason: str, cost_model=None) -> "PolicyDecision":
        return PolicyDecision(True, reason, cost_model)

    @staticmethod
    def absorb(reason: str) -> "PolicyDecision":
        return PolicyDecision(False, reason)


def event_deviation(event) -> tuple:
    """``(key, signed_log_deviation)`` of one ft event — the hysteresis
    coordinate system.  Capacity *drops* are negative (a rate-change factor
    ``f`` contributes ``ln f``; a straggler slowdown ``s`` contributes
    ``-ln s``), so a flap's down/up edges cancel to ~0 cumulative
    deviation.  Node failures are topological, not a magnitude: ``inf``.

    >>> from repro_torch.ft.coordinator import RateChange, Straggler
    >>> key, d = event_deviation(RateChange(0, 2, 0.5))
    >>> key, round(d, 4)
    (('link', 0, 2), -0.6931)
    >>> event_deviation(Straggler(1, 2.0))[1] < 0
    True
    """
    from .coordinator import NodeFailure, RateChange, Resync, Straggler
    if isinstance(event, RateChange):
        if event.factor <= 0:
            return ("link", event.n_from, event.n_to), -math.inf
        return ("link", event.n_from, event.n_to), math.log(event.factor)
    if isinstance(event, Straggler):
        if event.slowdown <= 0:
            return ("node", event.node), math.inf
        return ("node", event.node), -math.log(event.slowdown)
    if isinstance(event, NodeFailure):
        return ("failure", event.server), -math.inf
    if isinstance(event, Resync):
        return ("resync",), 0.0          # magnitude computed vs a reference
    return ("other", type(event).__name__), -math.inf


def net_deviation(ref, net) -> float:
    """Largest absolute log capacity ratio between two same-shape networks
    — the magnitude of a ``Resync`` measurement snapshot.  The deviation
    coordinate :class:`Hysteresis` measures snapshots in, and the increment
    ``ft.adaptive.DriftEstimator`` accumulates drift rates from."""
    if ref is None or len(ref.nodes) != len(net.nodes):
        return math.inf
    dev = 0.0
    for a, b in zip(ref.nodes, net.nodes):
        if a.f > 0 and b.f > 0:
            dev = max(dev, abs(math.log(b.f / a.f)))
        elif a.f != b.f:
            return math.inf
    pos = (ref.rate > 0) & (net.rate > 0)
    if np.any(pos):
        dev = max(dev, float(np.max(np.abs(
            np.log(net.rate[pos] / ref.rate[pos])))))
    if np.any((ref.rate > 0) != (net.rate > 0)):
        return math.inf
    return dev


class ReplanPolicy:
    """Decision seam between event arrival and ``Coordinator.apply``.

    ``decide`` is consulted by ``Coordinator.deliver`` *before* the event
    mutates anything; ``observe`` runs after the outcome (replan, absorb,
    or an absorb escalated to a forced replan) so budget/backoff/reference
    state tracks what actually happened.  Policies are stateful and
    single-coordinator: use one instance per coordinator.
    """

    name = "abstract"

    def decide(self, event, time: float, coord) -> PolicyDecision:
        raise NotImplementedError

    def observe(self, outcome, time: float) -> None:
        """Called after every delivered event with the ``ReplanOutcome``."""

    def reset(self) -> None:
        """Drop accumulated state (new coordinator / new run)."""

    def __repr__(self):
        return f"{type(self).__name__}()"


class Eager(ReplanPolicy):
    """Replan on every event — the historical ``Coordinator.apply``
    behavior, now spelled as the trivial policy."""

    name = "eager"

    def decide(self, event, time, coord) -> PolicyDecision:
        return PolicyDecision.do_replan("eager")


class RideOut(ReplanPolicy):
    """Never replan voluntarily: absorb every event and keep the incumbent
    plan (the coordinator still escalates to a forced replan when riding
    out is impossible, e.g. the failed server hosted a stage)."""

    name = "ride_out"

    def decide(self, event, time, coord) -> PolicyDecision:
        return PolicyDecision.absorb("ride-out")


class Periodic(ReplanPolicy):
    """Replan at most once per ``cadence`` simulated seconds; absorb
    in-between.  With a stream of periodic ``Resync`` measurement
    snapshots this *is* the ROADMAP's replanning-cadence knob: small
    cadences track drift closely but pay solve/restart downtime per
    replan, large cadences ride out staleness."""

    name = "periodic"

    def __init__(self, cadence: float):
        if cadence < 0:
            raise ValueError("cadence must be >= 0")
        self.cadence = cadence
        self._last = -math.inf

    def decide(self, event, time, coord) -> PolicyDecision:
        from .coordinator import NodeFailure
        if isinstance(event, NodeFailure):
            return PolicyDecision.do_replan("periodic: node failure")
        if time - self._last >= self.cadence:
            return PolicyDecision.do_replan(
                f"periodic: cadence {self.cadence:g} elapsed")
        return PolicyDecision.absorb("periodic: inside cadence window")

    def observe(self, outcome, time) -> None:
        if outcome.action in ("replan", "microbatch"):
            self._last = time

    def reset(self) -> None:
        self._last = -math.inf

    def __repr__(self):
        return f"Periodic(cadence={self.cadence!r})"


class Hysteresis(ReplanPolicy):
    """Debounced triggers with reversal detection (see module docstring).

    State per resource key (a link or a node): the *cumulative* signed log
    deviation of its capacity since the last adopted replan.  An event
    whose key stays inside ``[-threshold, +threshold]`` is absorbed
    outright (and cancels any pending replan on that key — reversal
    detection: a recovered link un-arms the trigger).  Crossing the
    threshold arms a pending replan stamped with the crossing time; the
    replan fires at the first delivered event (any key) once the deviation
    has persisted ``cooldown`` seconds — trailing-edge debounce, so a link
    flapping faster than its own recovery never fires.  Node failures
    replan immediately (topology changed; per-index state is invalidated
    by the renumbering and dropped).

    ``Resync`` snapshots are measured against the network the incumbent
    plan was last solved for: the largest per-resource log capacity ratio
    is the deviation, under the same arm/persist/cancel mechanics.
    """

    name = "hysteresis"

    def __init__(self, threshold: float = 0.25, cooldown: float = 0.0):
        if threshold <= 0:
            raise ValueError("threshold must be > 0 (log-ratio units)")
        if cooldown < 0:
            raise ValueError("cooldown must be >= 0")
        self.threshold = threshold
        self.cooldown = cooldown
        self._dev: dict = {}         # key -> cumulative signed log deviation
        self._pending: dict = {}     # key -> time the deviation crossed
        self._ref_net = None         # Resync reference (last replanned-for)

    def decide(self, event, time, coord) -> PolicyDecision:
        from .coordinator import NodeFailure, Resync
        if isinstance(event, NodeFailure):
            return PolicyDecision.do_replan("hysteresis: node failure")
        key, delta = event_deviation(event)
        if isinstance(event, Resync):
            ref = self._ref_net if self._ref_net is not None else coord.net
            dev = net_deviation(ref, event.net)
        else:
            self._dev[key] = self._dev.get(key, 0.0) + delta
            dev = abs(self._dev[key])
        if dev < self.threshold:
            if key in self._pending:
                del self._pending[key]
                obs.inc("ft.policy.reversals")
                return self._or_matured(
                    time, "hysteresis: reversal cancelled pending replan")
            return self._or_matured(time, "hysteresis: below threshold")
        armed = self._pending.setdefault(key, time)
        if time - armed >= self.cooldown:
            return PolicyDecision.do_replan(
                f"hysteresis: deviation {dev:.3g} persisted >= "
                f"cooldown on {key}")
        return self._or_matured(
            time, f"hysteresis: deviation {dev:.3g} inside "
                  f"flap-suppression window on {key}")

    def _or_matured(self, time: float, absorb_reason: str) -> PolicyDecision:
        """Absorb — unless some *other* armed key's deviation has now
        persisted past the cooldown, in which case fire its replan (the
        only chance a deferred trigger gets is a later delivery)."""
        for key, armed in self._pending.items():
            if time - armed >= self.cooldown:
                return PolicyDecision.do_replan(
                    f"hysteresis: deferred replan matured on {key}")
        return PolicyDecision.absorb(absorb_reason)

    def observe(self, outcome, time) -> None:
        from .coordinator import NodeFailure, Resync
        if isinstance(outcome.event, NodeFailure):
            # degraded() renumbered every node/link index: per-key state
            # would silently track the wrong resources
            self.reset()
            return
        if outcome.action in ("replan", "microbatch"):
            self._dev.clear()
            self._pending.clear()
            if isinstance(outcome.event, Resync):
                self._ref_net = outcome.event.net

    def reset(self) -> None:
        self._dev.clear()
        self._pending.clear()
        self._ref_net = None

    def __repr__(self):
        return (f"Hysteresis(threshold={self.threshold!r}, "
                f"cooldown={self.cooldown!r})")


class RateLimited(ReplanPolicy):
    """Token-bucket replan budget with exponential backoff, wrapping any
    inner policy.

    The bucket holds up to ``capacity`` replans and refills one token per
    ``refill_period`` simulated seconds.  When the inner policy asks to
    replan with an empty bucket, the event is absorbed instead (ride-out),
    so replan storms cost a bounded number of solves.  *Backoff*: each
    adopted replan whose improvement over riding out is below ``margin``
    (relative) counts as unhelpful; the effective refill period is
    ``refill_period * backoff ** consecutive_unhelpful`` (capped at
    ``max_backoff`` doublings), and one helpful replan resets it — a storm
    of no-gain replans degrades the budget toward pure ride-out instead of
    thrashing, and recovers as soon as replanning pays again.

    Forced replans (an absorb the coordinator escalated because riding out
    was impossible) do not consume tokens — the budget gates *voluntary*
    solves only.
    """

    name = "rate_limited"

    def __init__(self, inner: ReplanPolicy, *, capacity: float = 2.0,
                 refill_period: float = 1.0, backoff: float = 2.0,
                 margin: float = 0.02, max_backoff: int = 8):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if refill_period <= 0 or backoff < 1:
            raise ValueError("need refill_period > 0 and backoff >= 1")
        self.inner = inner
        self.capacity = float(capacity)
        self.refill_period = float(refill_period)
        self.backoff = float(backoff)
        self.margin = float(margin)
        self.max_backoff = int(max_backoff)
        self._tokens = float(capacity)
        self._last_refill = 0.0
        self._unhelpful = 0
        self._charged = False        # did the last decide spend a token?

    @property
    def effective_refill_period(self) -> float:
        return self.refill_period * \
            self.backoff ** min(self._unhelpful, self.max_backoff)

    def _refill(self, time: float) -> None:
        dt = max(0.0, time - self._last_refill)
        self._tokens = min(self.capacity,
                           self._tokens + dt / self.effective_refill_period)
        self._last_refill = time

    def decide(self, event, time, coord) -> PolicyDecision:
        self._refill(time)
        self._charged = False
        d = self.inner.decide(event, time, coord)
        if not d.replan:
            return d
        if self._tokens < 1.0:
            obs.inc("ft.policy.rate_limited")
            return PolicyDecision.absorb(
                f"rate-limited: bucket empty (refill every "
                f"{self.effective_refill_period:.3g}s after "
                f"{self._unhelpful} unhelpful replans) [{d.reason}]")
        self._tokens -= 1.0
        self._charged = True
        return d

    def observe(self, outcome, time) -> None:
        self.inner.observe(outcome, time)
        if outcome.action not in ("replan", "microbatch"):
            return
        if not self._charged:
            return                   # forced escalation: not budgeted
        ride = outcome.ride_out_latency
        if ride is None:
            return                   # no ride-out was scored: can't judge
        # an impossible ride-out (inf) means the replan was *necessary* —
        # that is the budget working as intended, not thrash
        helpful = (not math.isfinite(ride)
                   or outcome.new_latency <= ride * (1.0 - self.margin))
        if helpful:
            self._unhelpful = 0
        else:
            self._unhelpful += 1
            obs.inc("ft.policy.backoff_steps")

    def reset(self) -> None:
        self.inner.reset()
        self._tokens = self.capacity
        self._last_refill = 0.0
        self._unhelpful = 0
        self._charged = False

    def __repr__(self):
        return (f"RateLimited({self.inner!r}, capacity={self.capacity!r}, "
                f"refill_period={self.refill_period!r}, "
                f"backoff={self.backoff!r}, margin={self.margin!r})")


class CVaRPreSpill(ReplanPolicy):
    """Pre-migrate when the incumbent's *tail* goes bad, even if its mean
    is fine.

    On each event, score the incumbent plan's tail risk on the post-event
    network with ``sim.robustness.RobustMakespan`` (a seeded, cached
    fuzzed scenario distribution, simulated on ``device``).  If the scored
    risk exceeds ``bound x`` the incumbent's nominal (closed-form)
    latency, the event is escalated
    to a replan **solved under the robust objective** — the BCD then
    prefers the tail-safe placement, i.e. the coordinator pre-spills to
    where the ``RobustMakespan`` planner would have put it.  Otherwise the
    event is absorbed.  Node failures always replan (robustly).
    """

    name = "cvar_pre_spill"

    def __init__(self, *, bound: float = 1.5, n_scenarios: int = 6,
                 alpha: float = 0.9, seed: int = 0,
                 risk_aversion: float = 1.0, device="cuda"):
        if bound <= 0:
            raise ValueError("bound must be > 0")
        from ..sim.robustness import RobustMakespan  # deferred: sim dep
        self.bound = bound
        self.robust = RobustMakespan(n_scenarios=n_scenarios, alpha=alpha,
                                     seed=seed, risk_aversion=risk_aversion,
                                     device=device)

    def decide(self, event, time, coord) -> PolicyDecision:
        from .coordinator import Coordinator, NodeFailure
        if isinstance(event, NodeFailure):
            return PolicyDecision.do_replan("pre-spill: node failure",
                                            cost_model=self.robust)
        # memoized preview: repeated decides on the same flap reuse one
        # Planner per previewed network identity
        net, sol, _pl = coord.preview_cached(coord.plan.solution, event)
        if sol is None:
            return PolicyDecision.do_replan("pre-spill: incumbent displaced",
                                            cost_model=self.robust)
        try:
            nominal = coord.cost_model.evaluate(coord.profile, net, sol,
                                                coord.plan.b, coord.B)
            tail = self.robust.evaluate(coord.profile, net, sol,
                                        coord.plan.b, coord.B)
        except (ValueError, ArithmeticError):
            coord.eval_errors += 1
            obs.inc("ft.eval_errors")
            return PolicyDecision.do_replan("pre-spill: incumbent unscorable",
                                            cost_model=self.robust)
        if not math.isfinite(tail) or (math.isfinite(nominal) and nominal > 0
                                       and tail > self.bound * nominal):
            obs.inc("ft.policy.pre_spills")
            return PolicyDecision.do_replan(
                f"pre-spill: incumbent tail {tail:.4g} > "
                f"{self.bound:g} x nominal {nominal:.4g}",
                cost_model=self.robust)
        return PolicyDecision.absorb(
            f"pre-spill: incumbent tail {tail:.4g} within "
            f"{self.bound:g} x nominal {nominal:.4g}")

    def __repr__(self):
        return f"CVaRPreSpill(bound={self.bound!r}, robust={self.robust!r})"


# ---------------------------------------------------------------------------
# Policy evaluation harness: replay fuzzed event streams under each policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PolicyEvalReport:
    """One policy's aggregate over a corpus of replayed event streams.

    ``makespans`` are end-to-end (they already include the per-replan
    solve + restore + remap downtime ``simulate_with_replanning`` charges);
    ``final_objectives`` are each run's closing ``plan.objective`` — the
    latency the deployment is left with once the stream ends (the
    corpus-level guarantee is Hysteresis <= RideOut here, since absorbs
    escalate whenever riding out is impossible and every kept incumbent is
    re-priced)."""
    policy: str
    makespans: tuple
    final_objectives: tuple
    replans: int                 # replans actually issued across the corpus
    suppressed: int              # events absorbed without a solve
    downtime: float              # total solve + restore + remap seconds
    blocked: dict | None = None  # resource -> mean blocked seconds/stream
    alpha: float = 0.9
    eval_errors: int = 0         # expected-infeasibility evals swallowed
    #                              (Coordinator.eval_errors, summed) — a
    #                              policy silently failing its evals is
    #                              visible here, not just in the obs registry

    @property
    def mean(self) -> float:
        return float(np.mean(self.makespans))

    @property
    def cvar(self) -> float:
        from ..sim.robustness import cvar
        return cvar(self.makespans, self.alpha)

    def row(self) -> dict:
        return {"policy": self.policy, "mean": self.mean, "cvar": self.cvar,
                "replans": self.replans, "suppressed": self.suppressed,
                "downtime": self.downtime,
                "eval_errors": self.eval_errors,
                "mean_final_objective":
                    float(np.mean(self.final_objectives))}


def evaluate_policies(profile, net, B: int, streams, policies, *,
                      remap_penalty: float = 0.0,
                      solve_downtime: float | str = 0.0,
                      alpha: float = 0.9, engine: str = "event",
                      attribution: bool = False, device="cuda",
                      **coordinator_kwargs) -> dict:
    """Replay each event ``stream`` (tuples of ``sim.ReplanTrigger``, e.g.
    from ``sim.fuzz_event_stream``) through
    ``sim.simulate_with_replanning`` under every policy and aggregate a
    :class:`PolicyEvalReport` per policy — the policy-search harness.  Each
    stream's coordinator (its replans) and simulation run on ``device``.

    ``policies`` maps name -> *factory* (zero-arg callable returning a
    fresh :class:`ReplanPolicy` or ``None`` for eager): policies are
    stateful, so every stream must get its own instance.  A non-callable
    string value is resolved per stream via :func:`resolve_replan_policy`.
    ``attribution=True`` additionally aggregates per-resource blocked
    seconds from every segment's utilization decomposition."""
    from ..sim.engine import simulate_with_replanning
    from .coordinator import Coordinator
    dev = resolve_device(device)
    streams = [tuple(s) for s in streams]
    out = {}
    for name, factory in policies.items():
        makespans, finals = [], []
        replans = suppressed = eval_errors = 0
        downtime = 0.0
        blocked: dict = {}
        for stream in streams:
            pol = factory() if callable(factory) else \
                resolve_replan_policy(factory)
            coord = Coordinator(profile, net, B, policy=pol, device=dev,
                                **coordinator_kwargs)
            with obs.span("ft.policy.eval", policy=name):
                rep = simulate_with_replanning(
                    profile, net, B, stream, coordinator=coord,
                    remap_penalty=remap_penalty,
                    solve_downtime=solve_downtime, engine=engine,
                    device=dev)
            makespans.append(rep.makespan)
            finals.append(coord.plan.objective)
            replans += rep.num_replans
            suppressed += rep.num_suppressed
            downtime += rep.downtime
            eval_errors += coord.eval_errors
            if attribution:
                for seg in rep.segments:
                    u = seg.report.utilization()
                    for res, ru in u.resources.items():
                        blocked[res] = blocked.get(res, 0.0) + ru.blocked
        if attribution and streams:
            blocked = {r: t / len(streams) for r, t in blocked.items()}
        out[name] = PolicyEvalReport(
            policy=name, makespans=tuple(makespans),
            final_objectives=tuple(finals), replans=replans,
            suppressed=suppressed, downtime=downtime,
            blocked=(blocked if attribution else None), alpha=alpha,
            eval_errors=eval_errors)
    return out


_NAMED = {
    "eager": Eager,
    "ride_out": RideOut,
    "rideout": RideOut,
    "hysteresis": Hysteresis,
}


def resolve_replan_policy(policy) -> ReplanPolicy | None:
    """``None`` passes through (the coordinator treats it as eager);
    strings name zero-argument zoo members; instances pass through.
    (Named after ``sim.resolve_policy``, which resolves *admission*
    policies — a different seam.)"""
    if policy is None or isinstance(policy, ReplanPolicy):
        return policy
    if isinstance(policy, str):
        if policy.lower() == "adaptive":     # lazy: adaptive imports us
            from .adaptive import AdaptiveCadence
            return AdaptiveCadence()
        try:
            return _NAMED[policy.lower()]()
        except KeyError:
            raise ValueError(
                f"unknown replan policy {policy!r}; named policies: "
                f"{sorted(set(_NAMED) | {'adaptive'})}") from None
    raise TypeError(f"expected a ReplanPolicy, name, or None, got "
                    f"{policy!r}")
