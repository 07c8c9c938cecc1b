"""The replan policies in the port against the reference.

The same numpy-seeded instances (``random_instance(3)``, the instance of
``tests/test_policy.py``) and the same fuzzed event streams
(``fuzz_event_stream`` from one seed in each package) are delivered to a
``repro.ft.Coordinator`` and a ``repro_torch.ft.Coordinator``
(``device="cpu"``), each with its own instance of the same policy.  After
every event the decision (replan or absorb, and its reason), the outcome's
action and the plan are equal (``==``).  ``evaluate_policies`` reports are
equal field for field with a float ``solve_downtime`` (``"wall"`` reads a
clock and is only checked for its accounting); ``simulate_with_replanning``
under a policy gives equal segments.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.core as R
import repro.ft as R_ft
import repro.sim as RS

import repro_torch.core as T
import repro_torch.ft as T_ft
import repro_torch.sim as TS
from repro_torch import obs

CPU = "cpu"

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: the simulator's many
    small CPU ops gain nothing from a thread pool, and parallel test
    workers each spinning a full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _plan_key(plan):
    return (plan.solution.cuts, plan.solution.placement, plan.b, plan.L_t,
            plan.objective, plan.feasible, plan.cost_model)


def _small(C, seed=5):
    """``tests/test_policy.py``'s ``inst``: 6 layers over 4 servers."""
    rng = np.random.default_rng(seed)
    return (C.random_profile(rng, 6),
            C.make_edge_network(num_servers=4, num_clients=2, seed=seed))


#: one factory per package for each policy of the zoo
POLICIES = {
    "none": (lambda ft: None),
    "eager": (lambda ft: ft.Eager()),
    "ride_out": (lambda ft: ft.RideOut()),
    "periodic": (lambda ft: ft.Periodic(0.5)),
    "hysteresis": (lambda ft: ft.Hysteresis(0.25, cooldown=0.3)),
    "hysteresis_now": (lambda ft: ft.Hysteresis(0.4)),
    "rate_limited": (lambda ft: ft.RateLimited(ft.Hysteresis(0.25,
                                                             cooldown=0.3))),
    "rate_limited_eager": (lambda ft: ft.RateLimited(
        ft.Eager(), capacity=1.0, refill_period=0.5)),
    "adaptive": (lambda ft: ft.AdaptiveCadence()),
    "adaptive_guard": (lambda ft: ft.AdaptiveCadence(step_threshold=0.3,
                                                     staleness_weight=2.0)),
    "named_hysteresis": (lambda ft: "hysteresis"),
    "named_adaptive": (lambda ft: "adaptive"),
}


def _deliver_both(rc, tc, rtrigs, ttrigs):
    for rt, tt in zip(rtrigs, ttrigs):
        ro = rc.deliver(rt.event, sim_time=rt.time)
        to = tc.deliver(tt.event, sim_time=tt.time)
        rd, td = ro.decision, to.decision
        if rd is None:
            assert td is None
        else:
            assert (td.replan, td.reason) == (rd.replan, rd.reason)
            assert (td.cost_model is None) == (rd.cost_model is None)
        assert (to.action, to.remapped_stages, to.old_latency,
                to.ride_out_latency, to.net_changed) == \
            (ro.action, ro.remapped_stages, ro.old_latency,
             ro.ride_out_latency, ro.net_changed)
        assert to.log_record()["reason"] == ro.log_record()["reason"]
        assert _plan_key(tc.plan) == _plan_key(rc.plan)
        assert np.array_equal(tc.net.rate, rc.net.rate)
        assert [n.f for n in tc.net.nodes] == [n.f for n in rc.net.nodes]


def _streams(rn, tn, seeds, **kw):
    return ([RS.fuzz_event_stream(np.random.default_rng(s), rn, **kw)
             for s in seeds],
            [TS.fuzz_event_stream(np.random.default_rng(s), tn, **kw)
             for s in seeds])


@pytest.mark.parametrize("name", list(POLICIES))
def test_policy_decisions_equal_reference_on_flap_streams(name):
    rp, rn, _, _, B = RS.random_instance(3)
    tp, tn, _, _, _ = TS.random_instance(3)
    rstreams, tstreams = _streams(rn, tn, range(1000, 1003), horizon=4.0,
                                  max_events=5, allow_failure=False,
                                  flap_fraction=0.75)
    for rtrigs, ttrigs in zip(rstreams, tstreams):
        rc = R_ft.Coordinator(rp, rn, B, policy=POLICIES[name](R_ft))
        tc = T_ft.Coordinator(tp, tn, B, policy=POLICIES[name](T_ft),
                              device=CPU)
        assert type(tc.policy).__name__ == type(rc.policy).__name__
        _deliver_both(rc, tc, rtrigs, ttrigs)


@pytest.mark.parametrize("name", ["eager", "ride_out", "periodic",
                                  "hysteresis", "rate_limited", "adaptive"])
def test_policy_decisions_equal_reference_with_failures(name):
    """Streams with node failures (renumbering) and stragglers on the
    policy test's 4-server instance."""
    (rp, rn), (tp, tn) = _small(R), _small(T)
    rstreams, tstreams = _streams(rn, tn, [2, 4], horizon=2.0, max_events=4)
    for rtrigs, ttrigs in zip(rstreams, tstreams):
        rc = R_ft.Coordinator(rp, rn, 128, policy=POLICIES[name](R_ft))
        tc = T_ft.Coordinator(tp, tn, 128, policy=POLICIES[name](T_ft),
                              device=CPU)
        _deliver_both(rc, tc, rtrigs, ttrigs)


@pytest.mark.parametrize("name", ["hysteresis", "periodic", "adaptive",
                                  "ride_out"])
def test_policy_decisions_on_resync_snapshots(name):
    """Periodic Gauss-Markov measurement snapshots (``Resync``)."""
    (rp, rn), (tp, tn) = _small(R), _small(T)
    rscen = RS.gauss_markov_scenario(rn, 0.3, np.random.default_rng(7),
                                     dt=0.05, horizon=2.0)
    tscen = TS.gauss_markov_scenario(tn, 0.3, np.random.default_rng(7),
                                     dt=0.05, horizon=2.0)
    rtr = RS.periodic_resync_triggers(rn, rscen, cadence=0.1, horizon=1.0)
    ttr = TS.periodic_resync_triggers(tn, tscen, cadence=0.1, horizon=1.0)
    rc = R_ft.Coordinator(rp, rn, 128, policy=POLICIES[name](R_ft))
    tc = T_ft.Coordinator(tp, tn, 128, policy=POLICIES[name](T_ft),
                          device=CPU)
    _deliver_both(rc, tc, rtr, ttr)


@pytest.mark.parametrize("bound", [1.05, 1.5, 1e6])
def test_cvar_pre_spill_decisions_equal_reference(bound):
    rp, rn, _, _, B = RS.random_instance(3)
    tp, tn, _, _, _ = TS.random_instance(3)
    rpol = R_ft.CVaRPreSpill(bound=bound, n_scenarios=4, seed=0)
    tpol = T_ft.CVaRPreSpill(bound=bound, n_scenarios=4, seed=0, device=CPU)
    assert repr(tpol) == repr(rpol)
    rc = R_ft.Coordinator(rp, rn, B, policy=rpol)
    tc = T_ft.Coordinator(tp, tn, B, policy=tpol, device=CPU)
    for ev in ((R_ft.Straggler(1, 3.0), T_ft.Straggler(1, 3.0)),):
        rd, td = rpol.decide(ev[0], 1.0, rc), tpol.decide(ev[1], 1.0, tc)
        assert (td.replan, td.reason) == (rd.replan, rd.reason)
        if td.replan:
            assert td.cost_model is tpol.robust
    rstreams, tstreams = _streams(rn, tn, [1000], horizon=4.0, max_events=3,
                                  allow_failure=False, flap_fraction=0.75)
    _deliver_both(rc, tc, rstreams[0], tstreams[0])


def test_event_deviation_and_net_deviation_equal_reference():
    evs = [("RateChange", (0, 2, 0.5)), ("RateChange", (1, 0, 0.0)),
           ("Straggler", (1, 2.0)), ("Straggler", (2, 0.0)),
           ("NodeFailure", (1,))]
    for kind, args in evs:
        assert T_ft.event_deviation(getattr(T_ft, kind)(*args)) == \
            R_ft.event_deviation(getattr(R_ft, kind)(*args))
    (_, rn), (_, tn) = _small(R), _small(T)
    assert T_ft.event_deviation(T_ft.Resync(tn)) == \
        R_ft.event_deviation(R_ft.Resync(rn))
    for f in (0.5, 1.0, 3.0):
        rate_r, rate_t = rn.rate.copy(), tn.rate.copy()
        rate_r[1, 2] *= f
        rate_t[1, 2] *= f
        assert T_ft.net_deviation(tn, dataclasses.replace(tn, rate=rate_t)) \
            == R_ft.net_deviation(rn, dataclasses.replace(rn, rate=rate_r))
    assert T_ft.net_deviation(None, tn) == math.inf
    assert T_ft.net_deviation(tn, tn.degraded([1])) == math.inf


def test_resolve_replan_policy_and_validation():
    assert T_ft.resolve_replan_policy(None) is None
    for name in ("eager", "ride_out", "rideout", "hysteresis", "adaptive",
                 "Hysteresis"):
        assert T_ft.resolve_replan_policy(name).name == \
            R_ft.resolve_replan_policy(name).name
    h = T_ft.Hysteresis()
    assert T_ft.resolve_replan_policy(h) is h
    with pytest.raises(ValueError, match="unknown replan policy"):
        T_ft.resolve_replan_policy("debounce")
    with pytest.raises(TypeError):
        T_ft.resolve_replan_policy(object())
    for bad in (lambda: T_ft.Periodic(-1.0), lambda: T_ft.Hysteresis(0.0),
                lambda: T_ft.Hysteresis(0.2, cooldown=-1.0),
                lambda: T_ft.RateLimited(T_ft.Eager(), capacity=0.5),
                lambda: T_ft.RateLimited(T_ft.Eager(), refill_period=0.0),
                lambda: T_ft.CVaRPreSpill(bound=0.0, device=CPU)):
        with pytest.raises(ValueError):
            bad()
    assert [repr(POLICIES[n](T_ft)) for n in ("periodic", "hysteresis",
                                             "rate_limited", "adaptive")] \
        == [repr(POLICIES[n](R_ft)) for n in ("periodic", "hysteresis",
                                             "rate_limited", "adaptive")]


def _zoo(ft):
    return {
        "eager": lambda: None,
        "ride_out": ft.RideOut,
        "periodic_0.5": lambda: ft.Periodic(0.5),
        "hysteresis": lambda: ft.RateLimited(ft.Hysteresis(0.25,
                                                           cooldown=0.3)),
        "named": "hysteresis",
        "adaptive": ft.AdaptiveCadence,
    }


def _same_eval(got, want):
    assert list(got) == list(want)
    for name in want:
        g, w = got[name], want[name]
        assert (g.policy, g.makespans, g.final_objectives, g.replans,
                g.suppressed, g.downtime, g.blocked, g.alpha,
                g.eval_errors) == \
            (w.policy, w.makespans, w.final_objectives, w.replans,
             w.suppressed, w.downtime, w.blocked, w.alpha, w.eval_errors)
        assert g.row() == w.row()


@pytest.mark.parametrize("attribution", [False, True])
def test_evaluate_policies_equals_reference(attribution):
    """``bench_ft_policy.py``'s zoo setup (random_instance(3), flap
    streams, solve_downtime 0.05, remap_penalty 0.01) on the 4 streams of
    ``tests/test_policy.py``'s corpus contract, which it then checks."""
    rp, rn, _, _, B = RS.random_instance(3)
    tp, tn, _, _, _ = TS.random_instance(3)
    rs, ts = _streams(rn, tn, range(1000, 1004), horizon=4.0, max_events=5,
                      allow_failure=False, flap_fraction=0.75)
    want = R_ft.evaluate_policies(rp, rn, B, rs, _zoo(R_ft), alpha=0.9,
                                  remap_penalty=0.01, solve_downtime=0.05,
                                  attribution=attribution)
    got = T_ft.evaluate_policies(tp, tn, B, ts, _zoo(T_ft), alpha=0.9,
                                 remap_penalty=0.01, solve_downtime=0.05,
                                 attribution=attribution, device=CPU)
    _same_eval(got, want)
    eager, ride, hyst = got["eager"], got["ride_out"], got["hysteresis"]
    assert eager.replans > 0
    assert hyst.replans <= 0.25 * eager.replans
    assert hyst.mean <= eager.mean * (1 + 1e-9)
    assert np.mean(hyst.final_objectives) <= \
        np.mean(ride.final_objectives) * (1 + 1e-9)
    assert hyst.replans + hyst.suppressed == eager.replans + eager.suppressed


def test_evaluate_policies_with_pre_spill_equals_reference():
    rp, rn, _, _, B = RS.random_instance(3)
    tp, tn, _, _, _ = TS.random_instance(3)
    rs, ts = _streams(rn, tn, [1000, 1001], horizon=4.0, max_events=4,
                      allow_failure=False, flap_fraction=0.75)
    want = R_ft.evaluate_policies(
        rp, rn, B, rs,
        {"pre_spill": lambda: R_ft.CVaRPreSpill(bound=1.5, n_scenarios=4)},
        remap_penalty=0.01, solve_downtime=0.05)
    got = T_ft.evaluate_policies(
        tp, tn, B, ts,
        {"pre_spill": lambda: T_ft.CVaRPreSpill(bound=1.5, n_scenarios=4,
                                                device=CPU)},
        remap_penalty=0.01, solve_downtime=0.05, device=CPU)
    _same_eval(got, want)


def test_simulate_with_replanning_under_a_policy():
    """Suppressed events do not cut segments; an absorbed rate change still
    cuts with zero downtime; ``"wall"`` charges the measured solve."""
    (rp, rn), (tp, tn) = _small(R), _small(T)
    reps = []
    for C, ft, S, kw in ((R, R_ft, RS, {}), (T, T_ft, TS, {"device": CPU})):
        prof, net = (rp, rn) if C is R else (tp, tn)
        c = ft.Coordinator(prof, net, 128, policy=ft.RideOut(), **kw)
        trigs = [S.ReplanTrigger(0.1, ft.Resync(net)),
                 S.ReplanTrigger(0.2, ft.RateChange(1, 2, 0.5)),
                 S.ReplanTrigger(0.3, ft.Resync(net))]
        reps.append(S.simulate_with_replanning(
            prof, net, 128, trigs, coordinator=c, remap_penalty=0.25,
            solve_downtime=0.5, **kw))
    r, t = reps
    assert (t.num_replans, t.num_suppressed, len(t.segments), t.downtime,
            t.makespan) == (r.num_replans, r.num_suppressed,
                            len(r.segments), r.downtime, r.makespan)
    # three absorbs: two no-op Resyncs ride along the segment, the rate
    # change cuts it (it takes physical effect) with zero downtime
    assert (t.num_suppressed, len(t.suppressed), len(t.segments),
            t.downtime) == (3, 2, 2, 0.0)
    wall = TS.simulate_with_replanning(
        tp, tn, 128, [TS.ReplanTrigger(0.1, T_ft.RateChange(1, 2, 0.5))],
        solve_downtime="wall", device=CPU)
    out = wall.segments[0].outcome
    assert wall.downtime == out.solve_seconds > 0.0


def test_policy_counters_and_span():
    (tp, tn) = _small(T)
    with obs.enabled_scope():
        obs.reset()
        c = T_ft.Coordinator(tp, tn, 128, policy=T_ft.Hysteresis(0.25),
                             device=CPU)
        c.deliver(T_ft.RateChange(1, 2, 0.9), sim_time=0.1)
        c.deliver(T_ft.RateChange(1, 2, 0.5), sim_time=0.2)
        assert obs.counter("ft.policy.decisions[absorb]") == 1
        assert obs.counter("ft.policy.decisions[replan]") == 1
        assert obs.span_summary()["ft.policy.decide"]["count"] == 2
    obs.reset()
