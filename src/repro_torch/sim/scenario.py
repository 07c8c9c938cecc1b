"""Time-varying network scenarios for the simulator — the port of
``repro/sim/scenario.py``.

Capacities (node FLOP/s, link bytes/s) evolve as *piecewise-constant* step
functions of simulated time — rich enough to express every dynamic the
surrounding papers study (sampled Gauss-Markov channels, straggler windows,
link outages) while keeping task-completion times exactly integrable: a task
of ``work`` units started at ``t0`` finishes when the integral of the
capacity trace reaches ``work``.

Draws use ``numpy.random.Generator`` as the reference's do, so a scenario
made from a seed is the reference's, draw for draw.  A trace's breakpoints
are host data (tuples and numpy arrays, scanned by ``bisect`` in the scalar
methods); the vectorized engine's segmented scans
(:meth:`PiecewiseTrace.work_done_many` / :meth:`~PiecewiseTrace.finish_many`)
run on tensors, on whatever device their input lives on, with the
breakpoint arrays moved there once per trace and device.

>>> tr = piecewise((0.0, 1.0), (2.0, 0.5))      # 2 units/s, then 0.5
>>> tr.time_to_complete(0.0, 3.0)               # 2.0 by t=1, then 1.0 at 0.5
3.0
>>> scen = NetworkScenario().with_straggler(1, start=1.0, end=3.0,
...                                         slowdown=4.0)
>>> scen.node_mult[1].value_at(2.0)             # 4x slower inside the window
0.25
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import math

import numpy as np
import torch

from ..core.network import EdgeNetwork


# ---------------------------------------------------------------------------
# Piecewise-constant traces
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PiecewiseTrace:
    """value(t) = values[i] on [times[i], times[i+1]); last value holds
    forever.  ``times`` is strictly increasing with ``times[0] == 0.0``.

    ``__post_init__`` precomputes the breakpoint arrays and the
    cumulative-work prefix ``cumwork[i] = integral of the trace over
    [0, times[i])`` once per trace, in host numpy (the reference's
    ``np.cumsum``), so :meth:`value_at` and :meth:`time_to_complete` are a
    bisect and the vectorized engine's segmented scans
    (:meth:`work_done_many` / :meth:`finish_many`) are
    ``torch.searchsorted`` lookups on the run's device.
    """
    times: tuple
    values: tuple

    def __post_init__(self):
        if len(self.times) != len(self.values) or not self.times:
            raise ValueError("times/values must be non-empty, equal length")
        if self.times[0] != 0.0:
            raise ValueError("trace must start at t = 0")
        if any(b <= a for a, b in zip(self.times, self.times[1:])):
            raise ValueError("times must be strictly increasing")
        if not math.isfinite(self.times[-1]):
            raise ValueError("breakpoints must be finite (the last value "
                             "holds forever, so an inf breakpoint is "
                             "expressed by dropping it)")
        if any(v < 0 for v in self.values):
            raise ValueError("capacities must be non-negative")
        times_arr = np.asarray(self.times, dtype=float)
        values_arr = np.asarray(self.values, dtype=float)
        cumwork = np.zeros(len(times_arr))
        if len(times_arr) > 1:
            np.cumsum(values_arr[:-1] * np.diff(times_arr), out=cumwork[1:])
        # frozen dataclass: the derived caches are not fields
        object.__setattr__(self, "times_arr", times_arr)
        object.__setattr__(self, "values_arr", values_arr)
        object.__setattr__(self, "cumwork", cumwork)
        object.__setattr__(self, "_on_device", {})

    def arrays_on(self, device) -> tuple:
        """``(times, values, cumwork)`` as float64 tensors on ``device`` —
        copied from the host arrays once per device, then cached."""
        key = str(torch.device(device))
        got = self._on_device.get(key)
        if got is None:
            got = self._on_device[key] = tuple(
                torch.as_tensor(a, dtype=torch.float64, device=device)
                for a in (self.times_arr, self.values_arr, self.cumwork))
        return got

    def value_at(self, t: float) -> float:
        i = bisect.bisect_right(self.times, t) - 1
        return self.values[max(i, 0)]

    def scale(self, factor: float) -> "PiecewiseTrace":
        return PiecewiseTrace(self.times,
                              tuple(v * factor for v in self.values))

    def __mul__(self, other: "PiecewiseTrace") -> "PiecewiseTrace":
        """Pointwise product (merged breakpoints)."""
        times = sorted(set(self.times) | set(other.times))
        values = tuple(self.value_at(t) * other.value_at(t) for t in times)
        return PiecewiseTrace(tuple(times), values)

    def is_constant(self) -> bool:
        return len(set(self.values)) == 1

    def drains(self) -> bool:
        """True when any positive amount of work eventually completes from
        any start time — i.e. the trailing capacity is positive.  The
        vectorized engine's eligibility gate (a trailing-zero trace stalls
        forever, which only the event engine reports exactly as ``inf``)."""
        return self.values[-1] > 0.0

    # -- cumulative-work coordinates (the segmented-scan primitives) --------
    def work_done(self, t: float) -> float:
        """Integral of the trace over [0, t) (extrapolating ``values[0]``
        left of 0, matching the historical integration semantics)."""
        if math.isinf(t):
            return math.inf if self.values[-1] > 0.0 \
                else float(self.cumwork[-1])
        i = max(bisect.bisect_right(self.times, t) - 1, 0)
        return float(self.cumwork[i]) + self.values[i] * (t - self.times[i])

    def finish_time(self, target: float) -> float:
        """Smallest ``t`` with ``work_done(t) >= target`` (``inf`` when the
        trace's total capacity never reaches ``target``)."""
        if target <= 0.0:
            return 0.0
        j = bisect.bisect_left(self.cumwork, target)
        if j < len(self.cumwork):
            return self.times[j - 1] + \
                (target - float(self.cumwork[j - 1])) / self.values[j - 1]
        v = self.values[-1]
        if v <= 0.0:
            return math.inf
        return self.times[-1] + (target - float(self.cumwork[-1])) / v

    def work_done_many(self, t: torch.Tensor) -> torch.Tensor:
        """Vectorized :meth:`work_done` over a tensor of times, on the
        tensor's device."""
        t = _f64(t)
        times, values, cumwork = self.arrays_on(t.device)
        i = (torch.searchsorted(times, t, right=True) - 1).clamp_(min=0)
        return cumwork[i] + values[i] * (t - times[i])

    def finish_many(self, target: torch.Tensor) -> torch.Tensor:
        """Vectorized :meth:`finish_time` over a tensor of work targets.

        Assumes every positive target is reachable (``drains()`` — the
        vectorized engine gates on it); non-positive targets map to 0.
        """
        target = _f64(target)
        times, values, cumwork = self.arrays_on(target.device)
        j = torch.searchsorted(cumwork, target, right=False)
        pos = j.clamp_(1, len(self.cumwork)) - 1
        out = times[pos] + (target - cumwork[pos]) / values[pos]
        return torch.where(target <= 0.0, 0.0, out)

    def time_to_complete(self, t0: float, work: float) -> float:
        """Seconds after ``t0`` until the integral of the trace covers
        ``work``; ``inf`` if capacity stays zero before the work drains."""
        if work <= 0.0:
            return 0.0
        t = self.finish_time(self.work_done(t0) + work)
        if math.isinf(t):
            return math.inf
        return t - t0


def _f64(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous float64 tensor (``torch.searchsorted`` wants
    contiguous inputs)."""
    return x.to(torch.float64).contiguous()


@functools.lru_cache(maxsize=4096)
def _constant_cached(value: float) -> PiecewiseTrace:
    return PiecewiseTrace((0.0,), (value,))


def constant(value: float) -> PiecewiseTrace:
    """Constant-capacity trace.  Instances are immutable and cached — the
    engine asks for the same node/link constants once per visit per run,
    and the breakpoint-array precompute is not free."""
    return _constant_cached(float(value))


def piecewise(times, values) -> PiecewiseTrace:
    """Build a trace, coalescing zero-length segments.

    ``PiecewiseTrace`` itself is strict (strictly increasing breakpoints);
    this constructor additionally accepts *duplicate* consecutive times —
    zero-length segments, as produced e.g. by composing windows that share a
    boundary — and keeps the **last** value given for each time, matching
    the right-continuous ``value(t) = values[i] on [times[i], times[i+1])``
    semantics under which a zero-length segment covers no time at all.

    >>> piecewise((0.0, 1.0, 1.0, 2.0), (1.0, 99.0, 2.0, 3.0))
    PiecewiseTrace(times=(0.0, 1.0, 2.0), values=(1.0, 2.0, 3.0))
    """
    ts = [float(t) for t in times]
    vs = [float(v) for v in values]
    if len(ts) != len(vs):
        raise ValueError("times/values must have equal length")
    out_t: list = []
    out_v: list = []
    for t, v in zip(ts, vs):
        if out_t and t == out_t[-1]:
            out_v[-1] = v            # zero-length segment: last value wins
        else:
            out_t.append(t)
            out_v.append(v)
    return PiecewiseTrace(tuple(out_t), tuple(out_v))


def _window(start: float, end: float, inside: float) -> PiecewiseTrace:
    """Multiplier trace: ``inside`` on [start, end), 1 elsewhere.

    A zero-length window (``start == end``) covers no time and degenerates
    to the identity multiplier."""
    if not 0.0 <= start <= end:
        raise ValueError("need 0 <= start <= end")
    if start == end:
        return constant(1.0)
    if start == 0.0:
        return piecewise((0.0, end), (inside, 1.0))
    return piecewise((0.0, start, end), (1.0, inside, 1.0))


def square_wave(start: float, end: float, *, period: float,
                duty: float = 0.5, low: float = 0.0,
                high: float = 1.0) -> PiecewiseTrace:
    """Flapping-link multiplier: alternates ``high`` (for ``duty * period``)
    and ``low`` within ``[start, end)``, 1 outside — the square-wave model
    of a link that repeatedly drops and recovers.  The trace always returns
    to 1 at ``end``, so it drains (finite makespans) by construction.

    >>> square_wave(0.0, 2.0, period=1.0, duty=0.5, low=0.0)
    PiecewiseTrace(times=(0.0, 0.5, 1.0, 1.5, 2.0), values=(1.0, 0.0, 1.0, 0.0, 1.0))
    """
    if not 0.0 <= start <= end:
        raise ValueError("need 0 <= start <= end")
    if period <= 0.0 or not 0.0 < duty < 1.0:
        raise ValueError("need period > 0 and 0 < duty < 1")
    if start == end:
        return constant(1.0)
    times = [0.0] if start == 0.0 else [0.0, start]
    values = [high] if start == 0.0 else [1.0, high]
    t = start
    up = True
    while t < end:
        t = min(t + (duty if up else 1.0 - duty) * period, end)
        up = not up
        times.append(t)
        values.append((high if up else low) if t < end else 1.0)
    return piecewise(tuple(times), tuple(values))


def iid_piecewise(rng: np.random.Generator, cv: float, *, dt: float,
                  horizon: float, mean: float = 1.0,
                  floor: float = 0.05) -> PiecewiseTrace:
    """Independent ``max(N(mean, cv*mean), floor)`` draws every ``dt`` —
    the trace analogue of ``EdgeNetwork.with_fluctuation``'s marginals."""
    if cv <= 0:
        return constant(mean)
    n = max(int(math.ceil(horizon / dt)), 1) + 1
    vals = np.maximum(rng.normal(mean, cv * mean, n), floor)
    return piecewise(tuple(i * dt for i in range(n)), tuple(vals))


def gauss_markov(rng: np.random.Generator, cv: float, *, dt: float,
                 horizon: float, mean: float = 1.0, corr: float = 0.9,
                 floor: float = 0.05) -> PiecewiseTrace:
    """Sampled stationary AR(1) (Gauss-Markov) multiplier trace:

        x[j+1] = mean + corr * (x[j] - mean) + sigma * sqrt(1-corr^2) * eps

    with stationary std ``sigma = cv * mean`` — temporally *correlated*
    fluctuation, the standard mobility/channel drift model.
    """
    if cv <= 0:
        return constant(mean)
    n = max(int(math.ceil(horizon / dt)), 1) + 1
    sigma = cv * mean
    x = mean + sigma * float(rng.standard_normal())
    vals = []
    innov = sigma * math.sqrt(max(1.0 - corr * corr, 0.0))
    for _ in range(n):
        vals.append(max(x, floor))
        x = mean + corr * (x - mean) + innov * float(rng.standard_normal())
    return piecewise(tuple(i * dt for i in range(n)), tuple(vals))


# ---------------------------------------------------------------------------
# Network scenario: per-node / per-link multipliers + replan triggers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplanTrigger:
    """At simulated ``time``, feed ``event`` (an ``ft`` event —
    Straggler/RateChange/NodeFailure) to the coordinator and resume the
    remaining micro-batches under its new plan."""
    time: float
    event: object


@dataclasses.dataclass(frozen=True)
class NetworkScenario:
    """Multiplier traces over a base ``EdgeNetwork``.

    ``node_mult[n]`` scales node n's compute capability f_n over time;
    ``link_mult[(n, n')]`` scales the directed effective rate.  Absent keys
    mean "constant 1".  Scenarios are immutable; ``with_*`` helpers compose
    extra windows multiplicatively.

    ``mem_mult[n]`` scales node n's *available memory* (``Node.mem``) —
    co-tenant pressure, not a timing effect: the engines ignore it (task
    durations depend on compute/link capacity only), but admission sizing
    (``core.cost_model.DegradedTail``) and measurement snapshots
    (:func:`sampled_network`) consume it, so plans can be sized for the
    degraded-memory tail instead of the nominal budget.
    """
    node_mult: dict = dataclasses.field(default_factory=dict)
    link_mult: dict = dataclasses.field(default_factory=dict)
    replan_triggers: tuple = ()
    mem_mult: dict = dataclasses.field(default_factory=dict)

    # -- capacity traces ----------------------------------------------------
    def node_trace(self, net: EdgeNetwork, node: int) -> PiecewiseTrace:
        base = constant(net.nodes[node].f)
        m = self.node_mult.get(node)
        return base * m if m is not None else base

    def link_trace(self, net: EdgeNetwork, a: int, c: int) -> PiecewiseTrace:
        base = constant(net.rate[a, c])
        m = self.link_mult.get((a, c))
        return base * m if m is not None else base

    def mem_trace(self, net: EdgeNetwork, node: int) -> PiecewiseTrace:
        """Node ``node``'s *available memory* in bytes over time."""
        base = constant(net.nodes[node].mem)
        m = self.mem_mult.get(node)
        return base * m if m is not None else base

    # -- composition --------------------------------------------------------
    def _compose(self, table: dict, key, trace: PiecewiseTrace) -> dict:
        out = dict(table)
        out[key] = out[key] * trace if key in out else trace
        return out

    def with_straggler(self, node: int, start: float, end: float,
                       slowdown: float) -> "NetworkScenario":
        """Node ``node`` computes ``slowdown``x slower on [start, end)."""
        return dataclasses.replace(self, node_mult=self._compose(
            self.node_mult, node, _window(start, end, 1.0 / slowdown)))

    def with_outage(self, a: int, c: int, start: float, end: float,
                    both_directions: bool = True) -> "NetworkScenario":
        """Link (a, c) carries zero bytes on [start, end) — transfers in
        flight stall and resume when the outage lifts."""
        lm = self._compose(self.link_mult, (a, c), _window(start, end, 0.0))
        s = dataclasses.replace(self, link_mult=lm)
        if both_directions:
            lm = s._compose(s.link_mult, (c, a), _window(start, end, 0.0))
            s = dataclasses.replace(s, link_mult=lm)
        return s

    def with_flapping(self, a: int, c: int, start: float, end: float, *,
                      period: float, duty: float = 0.5, low: float = 0.0,
                      both_directions: bool = True) -> "NetworkScenario":
        """Link (a, c) flaps as a square wave on [start, end): up at full
        rate for ``duty * period``, down at ``low`` x for the rest of each
        period.  ``low=0`` models hard drops (transfers stall and resume)."""
        wave = square_wave(start, end, period=period, duty=duty, low=low)
        lm = self._compose(self.link_mult, (a, c), wave)
        s = dataclasses.replace(self, link_mult=lm)
        if both_directions:
            lm = s._compose(s.link_mult, (c, a), wave)
            s = dataclasses.replace(s, link_mult=lm)
        return s

    def with_mem_pressure(self, node: int, start: float, end: float,
                          factor: float) -> "NetworkScenario":
        """Node ``node``'s available memory shrinks to ``factor`` x on
        [start, end) — a co-tenant claiming part of the device.  No timing
        effect (the engines ignore it); consumed by tail-sized admission
        (``core.cost_model.DegradedTail``) and :func:`sampled_network`."""
        if factor < 0.0:
            raise ValueError("memory factor must be >= 0")
        return dataclasses.replace(self, mem_mult=self._compose(
            self.mem_mult, node, _window(start, end, factor)))

    def with_region_degradation(self, nodes, links, start: float, end: float,
                                factor: float) -> "NetworkScenario":
        """Correlated regional degradation: every node in ``nodes`` and every
        directed link in ``links`` is scaled by the SAME ``factor`` on
        [start, end) — the one-shared-cause failure mode (congested backhaul,
        regional power event) that independent per-resource noise never
        produces.  Callers pass the affected link pairs explicitly (e.g. all
        links touching the region's nodes) so the scenario stays
        network-agnostic."""
        if factor <= 0.0:
            raise ValueError("degradation factor must be positive "
                             "(use with_outage for hard zero-capacity)")
        win = _window(start, end, factor)
        nm = dict(self.node_mult)
        for n in nodes:
            nm[n] = nm[n] * win if n in nm else win
        lm = dict(self.link_mult)
        for key in links:
            a, c = key
            lm[(a, c)] = lm[(a, c)] * win if (a, c) in lm else win
        return dataclasses.replace(self, node_mult=nm, link_mult=lm)

    def drains(self) -> bool:
        """True when every multiplier trace ends at positive capacity — no
        resource can stall forever, so makespans stay finite.  ``mem_mult``
        is not part of the predicate: memory pressure resizes admission
        windows (a count, not a runtime resource), so it cannot wedge a
        run."""
        return all(tr.drains() for tr in self.node_mult.values()) and \
            all(tr.drains() for tr in self.link_mult.values())

    def with_replan(self, time: float, event) -> "NetworkScenario":
        trig = ReplanTrigger(time, event)
        return dataclasses.replace(
            self, replan_triggers=tuple(sorted(
                self.replan_triggers + (trig,), key=lambda t: t.time)))


def _scenario_from_sampler(net: EdgeNetwork, sampler) -> NetworkScenario:
    node_mult = {i: sampler() for i in range(len(net.nodes))}
    link_mult = {}
    for a in range(len(net.nodes)):
        for c in range(len(net.nodes)):
            if a != c and net.rate[a, c] > 0:
                link_mult[(a, c)] = sampler()
    return NetworkScenario(node_mult=node_mult, link_mult=link_mult)


def piecewise_cv_scenario(net: EdgeNetwork, cv: float,
                          rng: np.random.Generator, *, dt: float,
                          horizon: float, floor: float = 0.05
                          ) -> NetworkScenario:
    """Every node/link gets an independent i.i.d.-resampled piecewise trace
    with coefficient-of-variation ``cv`` (Fig. 6's noise, unfolded in time)."""
    return _scenario_from_sampler(
        net, lambda: iid_piecewise(rng, cv, dt=dt, horizon=horizon,
                                   floor=floor))


def gauss_markov_scenario(net: EdgeNetwork, cv: float,
                          rng: np.random.Generator, *, dt: float,
                          horizon: float, corr: float = 0.9,
                          floor: float = 0.05) -> NetworkScenario:
    """Every node/link gets an independent Gauss-Markov (AR(1)) trace."""
    return _scenario_from_sampler(
        net, lambda: gauss_markov(rng, cv, dt=dt, horizon=horizon, corr=corr,
                                  floor=floor))


def sampled_network(net: EdgeNetwork, scenario: NetworkScenario,
                    t: float) -> EdgeNetwork:
    """The network's *instantaneous measured capacities* at time ``t`` under
    ``scenario`` — what a monitoring tick would report: node ``f`` and link
    rates scaled by each multiplier trace's value at ``t``.  Feed to an
    ``ft.Resync`` event so a cadence-driven coordinator replans
    against the measurement snapshot."""
    nodes = list(net.nodes)
    for i, mult in scenario.node_mult.items():
        nodes[i] = dataclasses.replace(nodes[i],
                                       f=nodes[i].f * mult.value_at(t))
    for i, mult in scenario.mem_mult.items():
        nodes[i] = dataclasses.replace(nodes[i],
                                       mem=nodes[i].mem * mult.value_at(t))
    rate = net.rate.copy()
    for (a, c), mult in scenario.link_mult.items():
        rate[a, c] = rate[a, c] * mult.value_at(t)
    return dataclasses.replace(net, nodes=nodes, rate=rate)


def periodic_resync_triggers(net: EdgeNetwork, scenario: NetworkScenario, *,
                             cadence: float, horizon: float,
                             start: float | None = None) -> tuple:
    """Measurement ticks every ``cadence`` seconds up to ``horizon``: each
    trigger carries a ``Resync`` with the scenario's sampled capacities at
    that instant."""
    from ..ft.coordinator import Resync  # local: ft imports the planner
    if cadence <= 0:
        raise ValueError("cadence must be > 0")
    t = cadence if start is None else start
    out = []
    while t < horizon:
        out.append(ReplanTrigger(t, Resync(sampled_network(net, scenario, t))))
        t += cadence
    return tuple(out)
