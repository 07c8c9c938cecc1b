"""The port's simulated-time replanning against the reference's.

``simulate_with_replanning`` drives the coordinator from simulated time:
at each trigger the completed micro-batches are banked, the coordinator
replans (the port's through its planner, which launches K1 on the card),
and the remainder resumes under the new plan.  The cases of
``tests/test_sim.py:256-306`` run on both packages (``repro`` with its
own ``ft`` events, ``repro_torch`` with ``device="cpu"`` and its own),
with a float ``solve_downtime`` (``"wall"`` charges measured seconds,
which differ between runs).  Every segment's plan is equal (``==`` on
cuts, placement and b), and so are its banked micro-batches, cutoff and
outcome; completion times and makespans are within 1e-12.
"""

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

CPU = "cpu"
RTOL = 1e-12


@pytest.fixture(scope="module")
def paper():
    """The reference's ``paper_plan`` in both packages, with the base run's
    L_t (the trigger times are fractions of it)."""
    out = []
    for C, S, kw in ((R, RS, {}), (T, TS, {"device": CPU})):
        prof = C.vgg16_profile(work_units="bytes")
        net = C.make_edge_network(num_servers=4, num_clients=4, seed=1,
                                  kappa=1 / 32.0)
        plan = C.ours(prof, net, B=64, b0=8, **kw)
        base = S.simulate_plan(prof, net, plan.solution, plan.b, B=plan.B,
                               **kw)
        out.append((prof, net, plan, base.L_t))
    assert out[0][3] == out[1][3]
    return out


def _segments(rep):
    return [(s.plan.solution.cuts, s.plan.solution.placement, s.plan.b,
             s.completed, s.cutoff,
             None if s.outcome is None else s.outcome.action,
             None if s.trigger is None else s.trigger.time)
            for s in rep.segments]


def _assert_same_run(r, t):
    assert _segments(t) == _segments(r)
    assert t.num_replans == r.num_replans
    assert t.num_suppressed == r.num_suppressed
    assert t.downtime == r.downtime
    assert t.makespan == pytest.approx(r.makespan, rel=RTOL)
    for rs, ts in zip(r.segments, t.segments):
        want = np.asarray(rs.report.mb_complete)
        got = ts.report.mb_complete
        assert isinstance(got, torch.Tensor)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    assert [o.sim_time for o in t.outcomes] == [o.sim_time for o in
                                                r.outcomes]


def _triggers(S, ft, node, L):
    return [S.ReplanTrigger(0.4 * L, ft.Straggler(node, 6.0)),
            S.ReplanTrigger(0.9 * L, ft.RateChange(0, node, 0.5))]


@pytest.mark.parametrize("engine", ["event", "vectorized"])
@pytest.mark.parametrize("policy", ["fifo", "1f1b"])
def test_replanning_matches_reference(paper, engine, policy):
    reps = []
    for (prof, net, plan, L), S, ft, kw in zip(
            paper, (RS, TS), (R_ft, T_ft), ({}, {"device": CPU})):
        node = plan.solution.placement[1]
        rep = S.simulate_with_replanning(prof, net, plan.B,
                                         _triggers(S, ft, node, L),
                                         policy=policy, engine=engine,
                                         solve_downtime=0.25 * L,
                                         remap_penalty=0.1 * L, **kw)
        assert rep.num_replans == 2
        assert np.isfinite(rep.makespan)
        if policy == "fifo":
            assert rep.makespan >= L - 1e-9
        assert sum(s.completed * s.plan.b for s in rep.segments) >= plan.B
        assert all(s.outcome.action in ("replan", "microbatch")
                   for s in rep.segments if s.outcome is not None)
        reps.append(rep)
    _assert_same_run(*reps)
    assert reps[1].downtime == pytest.approx(2 * 0.35 * paper[0][3])


def test_replanning_consumes_scenario_triggers(paper):
    reps = []
    for (prof, net, plan, L), S, ft, kw in zip(
            paper, (RS, TS), (R_ft, T_ft), ({}, {"device": CPU})):
        node = plan.solution.placement[1]
        scen = S.NetworkScenario().with_replan(0.5 * L, ft.Straggler(node,
                                                                     6.0))
        rep = S.simulate_with_replanning(prof, net, plan.B, scenario=scen,
                                         **kw)
        assert rep.num_replans == 1
        reps.append(rep)
    _assert_same_run(*reps)


def test_replanning_under_a_scenario_with_triggers(paper):
    """A Gauss-Markov scenario plus two triggers, on the vectorized engine:
    the segments run the segmented trace scans."""
    reps = []
    for (prof, net, plan, L), S, ft, kw in zip(
            paper, (RS, TS), (R_ft, T_ft), ({}, {"device": CPU})):
        node = plan.solution.placement[1]
        scen = S.gauss_markov_scenario(net, 0.3, np.random.default_rng(0),
                                       dt=L / 16, horizon=8 * L)
        rep = S.simulate_with_replanning(prof, net, plan.B,
                                         _triggers(S, ft, node, L),
                                         scenario=scen, engine="vectorized",
                                         **kw)
        reps.append(rep)
    _assert_same_run(*reps)
    assert "trace" in reps[1].segments[0].report.engine_reason


def test_replanning_rejects_node_failure_with_scenario(paper):
    msgs = []
    for (prof, net, plan, _), S, ft, kw in zip(
            paper, (RS, TS), (R_ft, T_ft), ({}, {"device": CPU})):
        scen = S.NetworkScenario().with_straggler(1, 0.0, 1.0, 2.0)
        with pytest.raises(ValueError, match="NodeFailure") as err:
            S.simulate_with_replanning(
                prof, net, plan.B, [S.ReplanTrigger(0.01,
                                                    ft.NodeFailure(2))],
                scenario=scen, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_replanning_through_a_node_failure(paper):
    reps = []
    for (prof, net, plan, L), S, ft, kw in zip(
            paper, (RS, TS), (R_ft, T_ft), ({}, {"device": CPU})):
        node = plan.solution.placement[1]
        rep = S.simulate_with_replanning(
            prof, net, plan.B, [S.ReplanTrigger(0.3 * L,
                                                ft.NodeFailure(node))],
            solve_downtime=0.05 * L, **kw)
        assert rep.num_replans == 1
        reps.append(rep)
    _assert_same_run(*reps)


def test_replanning_no_triggers_matches_plain_sim(paper):
    prof, net, plan, _ = paper[1]
    rep = TS.simulate_with_replanning(prof, net, plan.B, [], device=CPU)
    plain = TS.simulate_plan(prof, net, rep.coordinator.plan.solution,
                             rep.coordinator.plan.b, B=plan.B, device=CPU)
    assert rep.makespan == pytest.approx(plain.L_t, rel=1e-9)
    assert rep.num_replans == 0 and rep.outcomes == []


def test_trigger_after_the_drain_ends_the_run(paper):
    reps = []
    for (prof, net, plan, L), S, ft, kw in zip(
            paper, (RS, TS), (R_ft, T_ft), ({}, {"device": CPU})):
        node = plan.solution.placement[1]
        rep = S.simulate_with_replanning(
            prof, net, plan.B, [S.ReplanTrigger(10.0 * L,
                                                ft.Straggler(node, 6.0))],
            **kw)
        assert rep.num_replans == 0 and rep.segments[0].trigger is None
        reps.append(rep)
    _assert_same_run(*reps)


def test_prebuilt_coordinator_and_named_replan_policy(paper):
    """A replan policy reaches ``simulate_with_replanning`` through a
    pre-built coordinator (``policy=`` there is the admission policy), as
    an instance or by name; both runs equal the reference's (a small rate
    change is absorbed: the segment is cut with no downtime)."""
    prof, net, plan, _ = paper[1]
    coord = T_ft.Coordinator(prof, net, plan.B, device=CPU)
    rep = TS.simulate_with_replanning(prof, net, plan.B, [],
                                      coordinator=coord, device=CPU)
    assert rep.coordinator is coord
    assert math.isfinite(rep.makespan)
    for named in (False, True):
        reps = []
        for (prof, net, plan, L), S, ft, kw in zip(
                paper, (RS, TS), (R_ft, T_ft), ({}, {"device": CPU})):
            node = plan.solution.placement[1]
            trigs = [S.ReplanTrigger(0.3 * L, ft.RateChange(0, node, 0.9)),
                     S.ReplanTrigger(0.6 * L, ft.Straggler(node, 6.0))]
            c = ft.Coordinator(prof, net, plan.B,
                               policy="hysteresis" if named
                               else ft.Hysteresis(0.25), **kw)
            reps.append(S.simulate_with_replanning(
                prof, net, plan.B, trigs, coordinator=c,
                remap_penalty=0.001, solve_downtime=0.002, **kw))
        _assert_same_run(*reps)
        assert [o.decision.reason for o in reps[1].outcomes] == \
            [o.decision.reason for o in reps[0].outcomes]
        assert (reps[1].num_suppressed, reps[1].num_replans) == (1, 1)