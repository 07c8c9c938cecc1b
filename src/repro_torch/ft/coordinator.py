"""Elastic coordinator — the paper's BCD promoted to a runtime feature.

The port of ``repro/ft/coordinator.py``.  Events:

  NodeFailure(server)  a server drops out -> rebuild the network without it,
                       re-run Algorithm 2 (BCD), remap submodels, resume
                       from the latest checkpoint
  RateChange(n,n',f)   a link's measured rate changed by factor f -> replan
  Straggler(node, f)   a node's compute slowed by factor f -> first try the
                       cheap fix (Theorem 1: re-solve the micro-batch size
                       against the new bottleneck); only if that recovers
                       too little, a full re-plan
  Resync(net)          a measured capacity snapshot -> re-solve on it

Every event's network mutation goes through the coordinator's one
``Planner`` (``Planner.update``: cached graphs patched in place, warm
hints kept), so a replan after a single-link event is a warm re-sweep, not
a cold Algorithm 1.  The planner, every preview planner and the BCD solves
run on ``device`` (``"cuda"`` unless the caller passes ``"cpu"``).

A replanning *policy* (``ft.policy``: debounce, rate limits, cadence,
tail-risk pre-spill) sits between an event's arrival and the solve:
``deliver`` consults ``policy.decide`` and either replans (``apply``) or
absorbs the event (``absorb``: the network mutates, the incumbent plan
rides out).  ``policy=None`` — apply every event at once — is the default.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time

from .. import obs
from ..core import (EdgeNetwork, ModelProfile, Plan, bcd_solve,
                    optimal_microbatch, total_latency, pipeline_interval,
                    fill_latency)
from ..core.cost_model import resolve_cost_model
from ..core.shortest_path import Planner


@dataclasses.dataclass(frozen=True)
class NodeFailure:
    server: int                  # node index in the current network


@dataclasses.dataclass(frozen=True)
class RateChange:
    n_from: int
    n_to: int
    factor: float


@dataclasses.dataclass(frozen=True)
class Straggler:
    node: int
    slowdown: float              # f_n -> f_n / slowdown


@dataclasses.dataclass(frozen=True)
class Resync:
    """A measured capacity snapshot.  Replanning against it re-solves on
    the *snapshot* while the coordinator's base network stays untouched
    (the snapshot already folds in whatever produced it); absorbing a
    Resync is a no-op."""
    net: EdgeNetwork


logger = logging.getLogger("repro_torch.ft.coordinator")


def _event_key(event):
    """Hashable identity of an event for the preview-planner memo."""
    if isinstance(event, NodeFailure):
        return ("NF", event.server)
    if isinstance(event, RateChange):
        return ("RC", event.n_from, event.n_to, event.factor)
    if isinstance(event, Straggler):
        return ("ST", event.node, event.slowdown)
    if isinstance(event, Resync):
        return ("RS", id(event.net))
    return ("??", id(event))


@dataclasses.dataclass
class ReplanOutcome:
    event: object
    old_latency: float
    new_plan: Plan
    action: str                  # "microbatch" | "replan" | "absorb"
    remapped_stages: bool
    solve_seconds: float = 0.0   # wall-clock spent replanning
    sim_time: float | None = None  # simulated time the event fired (if driven)
    restore_seconds: float = 0.0  # checkpoint-restore charge (NodeFailure)
    ride_out_latency: float | None = None  # incumbent on the mutated net
    #                              (inf: riding out impossible; None: unknown)
    net_changed: bool = True     # did coord.net mutate (Resync: no)
    decision: object = None      # PolicyDecision when routed via deliver()

    @property
    def new_latency(self) -> float:
        return self.new_plan.objective

    def log_record(self) -> dict:
        """Structured replan record — what the coordinator logs."""
        return {
            "event": type(self.event).__name__,
            "action": self.action,
            "remapped_stages": self.remapped_stages,
            "old_latency": self.old_latency,
            "new_latency": self.new_latency,
            "solve_seconds": self.solve_seconds,
            "sim_time": self.sim_time,
            "restore_seconds": self.restore_seconds,
            "ride_out_latency": self.ride_out_latency,
            "reason": None if self.decision is None else self.decision.reason,
        }


class Coordinator:
    """Holds the live (profile, network, plan); applies events.

    ``cost_model`` (default: closed form) is threaded through every replan.
    ``restore_cost`` is the checkpoint-restore charge of a ``NodeFailure``:
    seconds, or a zero-argument callable queried at failure time (e.g.
    ``lambda: checkpoint.estimate_restore_seconds(ckpt_dir)``); it lands
    on ``ReplanOutcome.restore_seconds``.  ``policy`` is the replan policy
    ``deliver`` consults (``ft.policy``: an instance, a name, or ``None``
    for eager).

    Every full replan also scores the *ride-out* candidate — the old
    ``(solution, b)`` carried onto the mutated network (placement indices
    remapped across a failure's renumbering) — and keeps it when it beats
    the fresh BCD solve, so a replan is never worse than standing pat.
    """

    def __init__(self, profile: ModelProfile, net: EdgeNetwork, B: int,
                 *, theta: float = 0.01,
                 microbatch_gain_threshold: float = 0.95, cost_model=None,
                 restore_cost=0.0, policy=None,
                 preview_cache_size: int = 8, device="cuda"):
        from .policy import resolve_replan_policy
        if preview_cache_size < 1:
            raise ValueError("preview_cache_size must be >= 1")
        self.profile = profile
        self.net = net
        self.B = B
        self.theta = theta
        self.mb_gain_threshold = microbatch_gain_threshold
        self.cost_model = resolve_cost_model(cost_model)
        self.restore_cost = restore_cost
        self.policy = resolve_replan_policy(policy)
        # ONE Planner serves every replan of this coordinator's lifetime:
        # events route through Planner.update (in-place graph patches + warm
        # hints), so an adopted replan after a single-link event costs a
        # patched re-sweep, not a cold Algorithm-1 solve
        self.planner = Planner(profile, net, device=device)
        self.device = self.planner.device
        # LRU memo of preview Planners, capped at preview_cache_size
        self.preview_cache_size = int(preview_cache_size)
        self._preview_planners: dict = {}   # net-identity -> Planner memo
        self.eval_errors = 0   # expected-infeasibility evals (also counted
        #                        in obs as "ft.eval_errors")
        self.plan = bcd_solve(profile, net, B, theta=theta,
                              cost_model=self.cost_model,
                              planner=self.planner, device=self.device)
        self.events: list = []

    # -- event delivery (policy seam) -----------------------------------------
    def deliver(self, event, *, sim_time: float | None = None) -> ReplanOutcome:
        """Route one event through the replan policy: consult
        ``policy.decide`` and either ``apply`` (full treatment) or
        ``absorb`` (mutate the network, keep the incumbent plan); the
        policy's ``observe`` sees the outcome.  With no policy this *is*
        ``apply``."""
        if self.policy is None:
            return self.apply(event, sim_time=sim_time)
        t = 0.0 if sim_time is None else sim_time
        with obs.span("ft.policy.decide", policy=self.policy.name,
                      event=type(event).__name__):
            decision = self.policy.decide(event, t, self)
        obs.inc("ft.policy.decisions[%s]"
                % ("replan" if decision.replan else "absorb"))
        logger.info("policy %s: %s -> %s (%s)", self.policy.name,
                    type(event).__name__,
                    "replan" if decision.replan else "absorb", decision.reason)
        if decision.replan:
            outcome = self.apply(event, sim_time=sim_time,
                                 cost_model=decision.cost_model)
        else:
            outcome = self.absorb(event, sim_time=sim_time)
        outcome.decision = decision
        self.policy.observe(outcome, t)
        return outcome

    # -- event application ----------------------------------------------------
    def apply(self, event, *, sim_time: float | None = None,
              cost_model=None) -> ReplanOutcome:
        """Mutate the network per ``event`` and replan.  ``sim_time`` is the
        simulated instant the event fired (recorded on the outcome).
        ``cost_model`` overrides the coordinator's model for *this* replan
        only."""
        base_model = self.cost_model
        if cost_model is not None:
            self.cost_model = resolve_cost_model(cost_model)
        try:
            return self._apply(event, sim_time)
        finally:
            self.cost_model = base_model

    def _apply(self, event, sim_time) -> ReplanOutcome:
        with obs.span("ft.apply", event=type(event).__name__):
            t0 = time.perf_counter()
            old_L = self._current_latency()
            old_sol, old_b = self.plan.solution, self.plan.b
            net_changed = True
            if isinstance(event, NodeFailure):
                self._mutate(event)
                old_sol = self._remap_across_failure(old_sol, event.server)
                outcome = self._full_replan(event, old_L)
                outcome.restore_seconds = self._restore_seconds()
            elif isinstance(event, RateChange):
                self._mutate(event)
                outcome = self._full_replan(event, old_L)
            elif isinstance(event, Straggler):
                self._mutate(event)
                outcome = self._straggler_mitigation(event, old_L)
            elif isinstance(event, Resync):
                # solve against the measured snapshot; the base net stays
                net_changed = False
                outcome = self._full_replan(event, old_L, net=event.net)
            else:
                raise TypeError(event)
            self._prefer_ride_out(
                old_sol, old_b, outcome,
                net=event.net if isinstance(event, Resync) else None)
            outcome.solve_seconds = time.perf_counter() - t0
            outcome.sim_time = sim_time
            outcome.net_changed = net_changed
        obs.inc("ft.replans")
        obs.inc(f"ft.action[{outcome.action}]")
        logger.info(
            "replan: event=%s action=%s remapped=%s old_latency=%.6g "
            "new_latency=%.6g solve_s=%.4f sim_time=%s",
            type(event).__name__, outcome.action, outcome.remapped_stages,
            outcome.old_latency, outcome.new_latency, outcome.solve_seconds,
            "-" if sim_time is None else f"{sim_time:.6g}")
        self.events.append(outcome)
        return outcome

    def _mutate(self, event) -> None:
        """Commit an event's network mutation through the shared planner
        (``Planner.update`` replays the reference's float ops, so
        ``self.net`` is bit-identical to mutating it directly)."""
        self.planner.update(event)
        self.net = self.planner.net
        self._preview_planners.clear()      # previews were for the old net

    def _planner_for(self, net: EdgeNetwork) -> Planner:
        """The memoized Planner for ``net``: the live planner when ``net``
        IS the coordinator's network, else one planner per network
        identity (Resync snapshots, previews)."""
        if net is self.planner.net or net is self.net:
            return self.planner
        hit = None
        for k, pl in self._preview_planners.items():  # bounded dict: scan ok
            if pl.net is net:
                hit = k
                break
        if hit is not None:
            obs.inc("ft.preview_planner_hit")
            return self._memo_touch(hit)
        obs.inc("ft.preview_planner_miss")
        pl = Planner(self.profile, net, device=self.device)
        self._memo_put(id(net), pl)
        return pl

    def _memo_touch(self, key):
        """Mark ``key`` most-recently-used and return its planner."""
        pl = self._preview_planners.pop(key)
        self._preview_planners[key] = pl
        return pl

    def _memo_put(self, key, pl) -> None:
        """Insert into the preview-planner memo, evicting least-recently
        used entries over the cap (``ft.preview_evictions`` counts them)."""
        self._preview_planners[key] = pl
        while len(self._preview_planners) > self.preview_cache_size:
            self._preview_planners.pop(next(iter(self._preview_planners)))
            obs.inc("ft.preview_evictions")

    # -- event absorption (ride-out path) --------------------------------------
    def absorb(self, event, *, sim_time: float | None = None) -> ReplanOutcome:
        """Take the event's network mutation **without replanning**: the
        incumbent ``(solution, b)`` rides out the change (placement indices
        remapped across a failure's renumbering), its objective re-priced on
        the mutated network.  When riding out is impossible — the failed
        server hosted a stage, or the incumbent is infeasible on the mutated
        network — the absorb escalates to a forced ``apply``."""
        with obs.span("ft.absorb", event=type(event).__name__):
            t0 = time.perf_counter()
            old_L = self._current_latency()
            sol, b = self.plan.solution, self.plan.b
            net_changed = True
            if isinstance(event, Resync):
                new_net = self.net         # true no-op: nothing mutates
                net_changed = False
            else:
                new_net, sol = self.preview(self.net, sol, event)
                if sol is None:
                    return self._escalate(
                        event, sim_time, "failed server hosts a stage")
            ride_L = self._evaluate_candidate(new_net, sol, b)
            if not math.isfinite(ride_L):
                return self._escalate(
                    event, sim_time, "incumbent infeasible on mutated network")
            if net_changed:
                # commit through the shared planner (same float ops as the
                # previewed new_net — values stay bit-identical)
                self._mutate(event)
                new_net = self.net
                self.plan = dataclasses.replace(
                    self.plan, solution=sol, b=b,
                    T_f=fill_latency(self.profile, new_net, sol, b),
                    T_i=pipeline_interval(self.profile, new_net, sol, b),
                    L_t=total_latency(self.profile, new_net, sol, b, self.B),
                    objective=ride_L, feasible=True,
                    cost_model=self.cost_model.name)
            outcome = ReplanOutcome(
                event=event, old_latency=old_L, new_plan=self.plan,
                action="absorb", remapped_stages=False,
                solve_seconds=time.perf_counter() - t0, sim_time=sim_time,
                ride_out_latency=ride_L, net_changed=net_changed)
        obs.inc("ft.absorbed")
        obs.inc("ft.action[absorb]")
        logger.info("absorb: event=%s new_latency=%.6g sim_time=%s",
                    type(event).__name__, outcome.new_latency,
                    "-" if sim_time is None else f"{sim_time:.6g}")
        self.events.append(outcome)
        return outcome

    def _escalate(self, event, sim_time, why: str) -> ReplanOutcome:
        """Ride-out impossible: the absorb becomes a forced full replan."""
        obs.inc("ft.absorb_escalated")
        logger.info("absorb escalated to replan: event=%s (%s)",
                    type(event).__name__, why)
        outcome = self.apply(event, sim_time=sim_time)
        if outcome.ride_out_latency is None:
            outcome.ride_out_latency = math.inf
        return outcome

    def _evaluate_candidate(self, net, sol, b: int) -> float:
        """Cost (under the active model) of ``(sol, b)`` on ``net`` —
        ``inf`` when memory-infeasible or expectedly unevaluable."""
        if sol is None or b < 1:
            return math.inf
        try:
            if not self.cost_model.memory_feasible(self.profile, net, sol, b):
                return math.inf
            return self.cost_model.evaluate(self.profile, net, sol, b, self.B)
        except (ValueError, ArithmeticError):
            # expected infeasibility — anything else is a programming
            # error: re-raise
            self.eval_errors += 1
            obs.inc("ft.eval_errors")
            return math.inf

    @staticmethod
    def preview(net: EdgeNetwork, sol, event):
        """``(mutated_net, remapped_solution)`` the event *would* produce —
        no coordinator state touched (``remapped_solution`` is ``None``
        when a failure displaces a hosted stage)."""
        if isinstance(event, NodeFailure):
            return (net.degraded([event.server]),
                    Coordinator._remap_across_failure(sol, event.server))
        if isinstance(event, RateChange):
            rate = net.rate.copy()
            rate[event.n_from, event.n_to] *= event.factor
            return dataclasses.replace(net, rate=rate), sol
        if isinstance(event, Straggler):
            return dataclasses.replace(
                net, nodes=[dataclasses.replace(n, f=n.f / event.slowdown)
                            if i == event.node else n
                            for i, n in enumerate(net.nodes)]), sol
        if isinstance(event, Resync):
            return event.net, sol
        raise TypeError(event)

    def preview_cached(self, sol, event):
        """``(mutated_net, remapped_solution, planner)`` for the event —
        :meth:`preview` plus a memoized :class:`Planner` per (base network,
        event) identity, so repeated previews of the same event stop
        re-paying graph builds.  Coordinator state is untouched."""
        key = (id(self.net), _event_key(event))
        if key in self._preview_planners:
            obs.inc("ft.preview_planner_hit")
            got = self._memo_touch(key)
            psol = (self._remap_across_failure(sol, event.server)
                    if isinstance(event, NodeFailure) else sol)
            return got.net, psol, got
        net, psol = Coordinator.preview(self.net, sol, event)
        pl = self._planner_for(net)
        self._memo_put(key, pl)
        return net, psol, pl

    def _current_latency(self) -> float:
        try:
            return self.cost_model.evaluate(self.profile, self.net,
                                            self.plan.solution, self.plan.b,
                                            self.B)
        except (ValueError, ArithmeticError):
            # expected infeasibility errors only — see _evaluate_candidate
            self.eval_errors += 1
            obs.inc("ft.eval_errors")
            return math.inf

    def _restore_seconds(self) -> float:
        rc = self.restore_cost
        return float(rc()) if callable(rc) else float(rc)

    @staticmethod
    def _remap_across_failure(sol, server: int):
        """The old solution re-expressed in the degraded network's indices
        (``degraded([server])`` drops one row/column and shifts the rest
        down), or ``None`` when the failed server hosted a stage."""
        if server in sol.placement:
            return None
        placement = tuple(n - 1 if n > server else n for n in sol.placement)
        return dataclasses.replace(sol, placement=placement)

    def _prefer_ride_out(self, old_sol, old_b: int, outcome,
                         net: EdgeNetwork | None = None) -> None:
        """Score the ride-out candidate — the pre-event ``(solution, b)``
        on the *mutated* network (``net`` overrides for Resync snapshots) —
        and keep it when it strictly beats the fresh solve.  Mutates
        ``outcome.new_plan`` (and ``self.plan``) in place; always records
        ``outcome.ride_out_latency`` (``inf`` when riding out is
        impossible)."""
        net = self.net if net is None else net
        ride_L = self._evaluate_candidate(net, old_sol, old_b)
        outcome.ride_out_latency = ride_L
        if not (math.isfinite(ride_L)
                and ride_L < self.plan.objective * (1.0 - 1e-12)):
            return
        obs.inc("ft.ride_out_kept")
        self.plan = dataclasses.replace(
            self.plan, solution=old_sol, b=old_b,
            T_f=fill_latency(self.profile, net, old_sol, old_b),
            T_i=pipeline_interval(self.profile, net, old_sol, old_b),
            L_t=total_latency(self.profile, net, old_sol, old_b, self.B),
            objective=ride_L, feasible=True,
            cost_model=self.cost_model.name)
        outcome.new_plan = self.plan
        outcome.remapped_stages = False

    def _full_replan(self, event, old_L,
                     net: EdgeNetwork | None = None) -> ReplanOutcome:
        net = self.net if net is None else net
        old_sol = self.plan.solution
        obs.inc("ft.full_solves")
        self.plan = bcd_solve(self.profile, net, self.B,
                              b0=max(self.plan.b, 1), theta=self.theta,
                              cost_model=self.cost_model,
                              planner=self._planner_for(net),
                              device=self.device)
        return ReplanOutcome(
            event=event, old_latency=old_L, new_plan=self.plan,
            action="replan",
            remapped_stages=(self.plan.solution != old_sol))

    def _straggler_mitigation(self, event, old_L) -> ReplanOutcome:
        """Cheap path first: keep (x, y), re-solve b for the new bottleneck
        (no weight movement); fall back to a full re-plan if that recovers
        too little.  A straggler only removes capacity, so the pre-event
        latency ``old_L`` bounds what a fresh solve can reach: when the
        micro-batch fix lands within the gain threshold of it, the BCD
        solve is skipped (``ft.full_solve_saved``)."""
        incumbent = self.plan
        sol = incumbent.solution
        T_i = pipeline_interval(self.profile, self.net, sol, incumbent.b)
        mb = optimal_microbatch(self.profile, self.net, sol, self.B, T_i,
                                cost_model=self.cost_model)
        if mb.b > 0:
            cheap_L = self._evaluate_candidate(self.net, sol, mb.b)
        else:
            cheap_L = math.inf

        def adopt_cheap():
            self.plan = dataclasses.replace(
                incumbent, b=mb.b,
                T_f=fill_latency(self.profile, self.net, sol, mb.b),
                T_i=pipeline_interval(self.profile, self.net, sol, mb.b),
                L_t=total_latency(self.profile, self.net, sol, mb.b, self.B),
                objective=cheap_L, cost_model=self.cost_model.name)
            return ReplanOutcome(event=event, old_latency=old_L,
                                 new_plan=self.plan, action="microbatch",
                                 remapped_stages=False)

        if (math.isfinite(cheap_L) and math.isfinite(old_L)
                and cheap_L <= old_L / self.mb_gain_threshold):
            obs.inc("ft.full_solve_saved")
            return adopt_cheap()
        full_outcome = self._full_replan(event, old_L)
        full = self.plan
        if (math.isfinite(cheap_L)
                and cheap_L <= full.objective / self.mb_gain_threshold):
            return adopt_cheap()
        return dataclasses.replace(full_outcome, remapped_stages=True)
