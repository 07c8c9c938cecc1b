"""Tail-risk scoring in the port against the reference.

The same numpy-seeded instances (``random_instance`` at the reference's
benchmark seeds and at the parity grid's fixed seeds ``101 * s + 13``, the
quickstart, and ``bench_adaptive.py``'s memory-starved instances) go
through ``repro.sim.robustness`` and ``repro_torch.sim.robustness``
(``device="cpu"``).  Every result is equal (``==``): CVaR (plain and
weighted), the weighted quantile, both scenario distributions (weights
included), ``score_plan`` / ``score_plans`` reports (blocked-time
attribution included), ``memory_occupancy_overflow``,
``RobustMakespan.evaluate_many`` and ``bcd_solve`` under it, and
``DegradedTail.from_scenarios`` on fuzzed memory-pressure scenarios.  The
statistics are host numpy float64 in the reference's order.  The one
tolerance is the reference's own: looped ``RobustMakespan.evaluate``
within rel 1e-12 of a batched ``evaluate_many`` (a batch reassociates the
stacked fixpoint's sums); each is still ``==`` the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro.sim as RS
from repro.sim import fuzz as RF
from repro.sim import robustness as RR

import repro_torch.core as T
import repro_torch.sim as TS
from repro_torch.sim import fuzz as TF
from repro_torch.sim import robustness as TR

CPU = "cpu"
INSTANCE_SEEDS = [3, 5, 9, 12]
GRID_SEEDS = [101 * s + 13 for s in range(6)]

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: the simulator's many
    small CPU ops gain nothing from a thread pool, and parallel test
    workers each spinning a full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _pair(seed):
    return RS.random_instance(seed), TS.random_instance(seed)


def _rsol(sol):
    return R.SplitSolution(sol.cuts, sol.placement)


def _same_report(got, want):
    assert got.makespans == want.makespans
    assert (got.nominal, got.alpha, got.weights) == \
        (want.nominal, want.alpha, want.weights)
    assert got.blocked == want.blocked
    assert (got.mean, got.p95, got.cvar, got.worst, got.tail_inflation) == \
        (want.mean, want.p95, want.cvar, want.worst, want.tail_inflation)
    assert got.top_blocked(3) == want.top_blocked(3)


# ---------------------------------------------------------------------------
# CVaR arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.0, 0.5, 0.75, 0.9, 0.95, 0.99])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cvar_equals_reference(seed, alpha):
    rng = np.random.default_rng(seed)
    vals = rng.lognormal(size=int(rng.integers(1, 40)))
    w = rng.uniform(0.0, 3.0, size=vals.size)
    w[0] += 0.1
    assert TR.cvar(vals, alpha) == RR.cvar(vals, alpha)
    assert TR.cvar(vals, alpha, w) == RR.cvar(vals, alpha, w)
    assert TR.cvar(list(vals), alpha, np.ones(vals.size)) == \
        RR.cvar(list(vals), alpha, np.ones(vals.size))
    for q in (0.05, 0.5, 0.95, 1.0):
        assert TR._weighted_quantile(vals, w, q) == \
            RR._weighted_quantile(vals, w, q)


def test_cvar_definition_and_errors():
    assert TR.cvar([1.0, 2.0, 3.0, 10.0], alpha=0.75) == 10.0
    assert TR.cvar([1.0, 2.0, 3.0, 10.0], alpha=0.5) == 6.5
    for bad in (dict(values=[], alpha=0.9), dict(values=[1.0], alpha=1.0),
                dict(values=[1.0, 2.0], alpha=0.5, weights=[1.0]),
                dict(values=[1.0, 2.0], alpha=0.5, weights=[-1.0, 2.0]),
                dict(values=[1.0, 2.0], alpha=0.5, weights=[0.0, 0.0])):
        with pytest.raises(ValueError):
            TR.cvar(**bad)


# ---------------------------------------------------------------------------
# Scenario distributions
# ---------------------------------------------------------------------------

def _dicts(scens):
    return [TF.scenario_to_dict(s) for s in scens]


@pytest.mark.parametrize("planful", [False, True])
@pytest.mark.parametrize("seed", INSTANCE_SEEDS)
def test_scenario_distribution_equals_reference(seed, planful):
    (rp, rn, rs, rb, _), (tp, tn, ts, tb, _) = _pair(seed)
    rkw = dict(profile=rp, sol=rs, b=rb) if planful else {}
    tkw = dict(profile=tp, sol=ts, b=tb) if planful else {}
    want = RR.scenario_distribution(rn, 8, seed=seed, **rkw)
    got = TR.scenario_distribution(tn, 8, seed=seed, **tkw)
    assert _dicts(got) == [RF.scenario_to_dict(s) for s in want]


@pytest.mark.parametrize("tilts", [
    dict(tilt=3.0), dict(tilt=1.0),
    dict(tilt=2.0, kind_tilt={"outage": 4.0}, severity_tilt=2.5)])
@pytest.mark.parametrize("seed", INSTANCE_SEEDS[:2])
def test_importance_distribution_equals_reference(seed, tilts):
    (rp, rn, rs, rb, _), (tp, tn, ts, tb, _) = _pair(seed)
    ws, ww = RR.importance_scenario_distribution(
        rn, 10, seed=seed, profile=rp, sol=rs, b=rb, **tilts)
    gs, gw = TR.importance_scenario_distribution(
        tn, 10, seed=seed, profile=tp, sol=ts, b=tb, **tilts)
    assert _dicts(gs) == [RF.scenario_to_dict(s) for s in ws]
    assert gw == ww
    with pytest.raises(ValueError, match="tilt"):
        TR.importance_scenario_distribution(tn, 2, tilt=0.0)


# ---------------------------------------------------------------------------
# score_plan / score_plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["fifo", "memory"])
@pytest.mark.parametrize("seed", INSTANCE_SEEDS)
def test_score_plan_equals_reference(seed, policy):
    (rp, rn, rs, rb, B), (tp, tn, ts, tb, _) = _pair(seed)
    rsc = RR.scenario_distribution(rn, 6, seed=1, profile=rp, sol=rs, b=rb)
    tsc = TR.scenario_distribution(tn, 6, seed=1, profile=tp, sol=ts, b=tb)
    try:
        want = RR.score_plan(rp, rn, rs, rb, B=B, scenarios=rsc,
                             policy=policy)
    except ValueError as e:
        with pytest.raises(ValueError, match="memory-infeasible"):
            TR.score_plan(tp, tn, ts, tb, B=B, scenarios=tsc, policy=policy,
                          device=CPU)
        assert "memory-infeasible" in str(e)
        return
    got = TR.score_plan(tp, tn, ts, tb, B=B, scenarios=tsc, policy=policy,
                        device=CPU)
    _same_report(got, want)
    w = tuple(np.linspace(0.5, 2.0, len(tsc)))
    _same_report(
        TR.score_plan(tp, tn, ts, tb, B=B, scenarios=tsc, weights=w,
                      policy=policy, attribution=False, device=CPU),
        RR.score_plan(rp, rn, rs, rb, B=B, scenarios=rsc, weights=w,
                      policy=policy, attribution=False))


def test_blocked_attribution_names_the_outaged_link():
    (rp, rn, rs, rb, B), (tp, tn, ts, tb, _) = _pair(5)
    a, c = ts.placement[0], ts.placement[1]
    width = max(TS.simulate_plan(tp, tn, ts, tb, B=B, device=CPU).L_t, 1e-3)
    scens = []
    for S, sol in ((RS, rs), (TS, ts)):
        scens.append(S.NetworkScenario().with_outage(
            a, c, 0.0, 0.5 * width, both_directions=True))
    want = RR.score_plan(rp, rn, rs, rb, B=B, scenarios=[scens[0]])
    got = TR.score_plan(tp, tn, ts, tb, B=B, scenarios=[scens[1]],
                        device=CPU)
    _same_report(got, want)
    top = got.top_blocked()
    assert any(res[0] in ("fwd", "bwd") and (res[1], res[2]) in
               ((a, c), (c, a)) for res, _t in top), top


@pytest.mark.parametrize("seed", INSTANCE_SEEDS[:3])
def test_score_plans_equals_reference_and_score_plan(seed):
    (rp, rn, rs, rb, B), (tp, tn, ts, tb, _) = _pair(seed)
    tc = [(ts, bb) for bb in sorted({1, max(1, tb // 2), tb})]
    rc = [(rs, bb) for _, bb in tc]
    rsc = RR.scenario_distribution(rn, 5, seed=4)
    tsc = TR.scenario_distribution(tn, 5, seed=4)
    want = RR.score_plans(rp, rn, rc, B=B, scenarios=rsc)
    got = TR.score_plans(tp, tn, tc, B=B, scenarios=tsc, device=CPU)
    for g, w, (s, bb) in zip(got, want, tc):
        _same_report(g, w)
        one = TR.score_plan(tp, tn, s, bb, B=B, scenarios=tsc,
                            attribution=False, device=CPU)
        assert one.makespans == g.makespans and one.nominal == g.nominal
    with pytest.raises(ValueError, match="at least one"):
        TR.score_plans(tp, tn, tc, B=B, scenarios=(), device=CPU)


# ---------------------------------------------------------------------------
# Memory pressure: overflow and DegradedTail on fuzzed scenarios
# ---------------------------------------------------------------------------

def _starved(C, seed):
    """``bench_adaptive.py``'s memory-starved 2-server instance."""
    rng = np.random.default_rng(seed)
    prof = C.random_profile(rng, 14)
    net = C.make_edge_network(num_servers=2, num_clients=2, seed=seed,
                              bw_range_hz=(200e6, 400e6),
                              mem_range=(192 * 2**20, 2**28),
                              f_range=(1e12, 20e12))
    return prof, net


@pytest.mark.parametrize("seed", [38, 23])
def test_memory_overflow_and_degraded_tail_equal_reference(seed):
    (rp, rn), (tp, tn) = _starved(R, seed), _starved(T, seed)
    rplan = R.bcd_solve(rp, rn, B=32, b0=4, K=7,
                        cost_model=R.SimMakespan(policy="memory"))
    tplan = T.bcd_solve(tp, tn, B=32, b0=4, K=7,
                        cost_model=T.SimMakespan(policy="memory",
                                                 device=CPU), device=CPU)
    assert (tplan.solution.cuts, tplan.solution.placement, tplan.b,
            tplan.objective) == (rplan.solution.cuts,
                                 rplan.solution.placement, rplan.b,
                                 rplan.objective)
    rcfg = RF.FuzzConfig(families=("mem_pressure",), min_events=1,
                         max_events=2)
    tcfg = TF.FuzzConfig(families=("mem_pressure",), min_events=1,
                         max_events=2)
    rr, tr = np.random.default_rng(500), np.random.default_rng(500)
    rsc = [RF.fuzz_scenario(rr, rn, rcfg, profile=rp, sol=rplan.solution,
                            b=rplan.b) for _ in range(8)]
    tsc = [TF.fuzz_scenario(tr, tn, tcfg, profile=tp, sol=tplan.solution,
                            b=tplan.b) for _ in range(8)]
    assert _dicts(tsc) == [RF.scenario_to_dict(s) for s in rsc]
    assert all(s.mem_mult for s in tsc)
    for alpha in (0.5, 0.9, 0.95):
        want = R.DegradedTail.from_scenarios(rn, rsc, alpha)
        got = T.DegradedTail.from_scenarios(tn, tsc, alpha)
        assert (got.mem, got.alpha, repr(got)) == \
            (want.mem, want.alpha, repr(want))
        assert all(m <= n.mem for m, n in zip(got.mem, tn.nodes))
    overflowed = 0
    for policy in ("fifo", "memory"):
        for r_s, t_s in zip(rsc, tsc):
            rrep = RS.simulate_plan(rp, rn, rplan.solution, rplan.b, B=32,
                                    scenario=r_s, policy=policy,
                                    engine="event")
            trep = TS.simulate_plan(tp, tn, tplan.solution, tplan.b, B=32,
                                    scenario=t_s, policy=policy,
                                    engine="event", device=CPU)
            want = RR.memory_occupancy_overflow(rp, rn, rplan.solution,
                                                rplan.b, rrep, r_s)
            got = TR.memory_occupancy_overflow(tp, tn, tplan.solution,
                                               tplan.b, trep, t_s)
            assert got == want
            overflowed += bool(got)
        assert TR.memory_occupancy_overflow(
            tp, tn, tplan.solution, tplan.b,
            TS.simulate_plan(tp, tn, tplan.solution, tplan.b, B=32,
                             policy=policy, engine="event", device=CPU)) \
            == RR.memory_occupancy_overflow(
                rp, rn, rplan.solution, rplan.b,
                RS.simulate_plan(rp, rn, rplan.solution, rplan.b, B=32,
                                 policy=policy, engine="event"))
    # seed 38's unwindowed (fifo) runs overflow under the pressure draws
    assert overflowed > 0 or seed != 38


# ---------------------------------------------------------------------------
# RobustMakespan through the cost-model seam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("risk", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("seed", INSTANCE_SEEDS)
def test_robust_makespan_evaluate_many_equals_reference(seed, risk):
    (rp, rn, rs, rb, B), (tp, tn, ts, tb, _) = _pair(seed)
    tc = [(ts, bb) for bb in sorted({1, 2, max(1, tb // 2), tb, B + 1})]
    rc = [(rs, bb) for _, bb in tc]
    rm = RR.RobustMakespan(n_scenarios=5, seed=seed, risk_aversion=risk)
    tm = TR.RobustMakespan(n_scenarios=5, seed=seed, risk_aversion=risk,
                           device=CPU)
    got = tm.evaluate_many(tp, tn, tc, B)
    assert got == rm.evaluate_many(rp, rn, rc, B)
    looped = [tm.evaluate(tp, tn, s, bb, B) for s, bb in tc]
    assert looped == [rm.evaluate(rp, rn, s, bb, B) for s, bb in rc]
    # a batch groups same-structure trace runs through the stacked
    # fixpoint, which reassociates float sums: the reference's own
    # evaluate-vs-many tolerance, rel 1e-12
    assert looped == pytest.approx(got, rel=1e-12)
    assert _dicts(tm.distribution(tp, tn)) == \
        [RF.scenario_to_dict(s) for s in rm.distribution(rp, rn)]
    _same_report(tm.report(tp, tn, ts, tb, B), rm.report(rp, rn, rs, rb, B))
    assert repr(tm) == repr(rm)


def test_robust_makespan_distribution_is_cached_per_network_object():
    (_, _, _, _, B), (tp, tn, ts, tb, _) = _pair(3)
    cm = TR.RobustMakespan(n_scenarios=3, seed=0, device=CPU)
    d1 = cm.distribution(tp, tn, ts, tb, B)
    assert cm.distribution(tp, tn, ts, tb, B) is d1
    other = dataclasses.replace(tn, rate=tn.rate.copy())
    assert cm.distribution(tp, other, ts, tb, B) is not d1
    fixed = TR.RobustMakespan(scenarios=d1, device=CPU)
    assert fixed.distribution(tp, other) is d1
    with pytest.raises(ValueError, match="risk_aversion"):
        TR.RobustMakespan(risk_aversion=1.5, device=CPU)


@pytest.mark.parametrize("seed", GRID_SEEDS[:2] + [5])
def test_bcd_under_robust_makespan_equals_reference(seed):
    (rp, rn, _, _, B), (tp, tn, _, _, _) = _pair(seed)
    r = R.bcd_solve(rp, rn, B, cost_model=RR.RobustMakespan(n_scenarios=4,
                                                            seed=1))
    p = T.bcd_solve(tp, tn, B, cost_model=TR.RobustMakespan(
        n_scenarios=4, seed=1, device=CPU), device=CPU)
    assert (p.solution.cuts, p.solution.placement, p.b, p.T_f, p.T_i, p.L_t,
            p.objective, p.history, p.iterations, p.cost_model) == \
        (r.solution.cuts, r.solution.placement, r.b, r.T_f, r.T_i, r.L_t,
         r.objective, r.history, r.iterations, r.cost_model)
    assert p.cost_model == "robust_makespan"


def test_bcd_under_robust_makespan_on_the_quickstart():
    """The reference's value: objective 0.82546 (n_scenarios=12)."""
    rp = R.vgg16_profile(work_units="bytes")
    rn = R.make_edge_network(6, 4, seed=1, kappa=1 / 32.0)
    tp = T.vgg16_profile(work_units="bytes")
    tn = T.make_edge_network(6, 4, seed=1, kappa=1 / 32.0)
    r = R.bcd_solve(rp, rn, 512, cost_model=RR.RobustMakespan(
        n_scenarios=12))
    p = T.bcd_solve(tp, tn, 512, cost_model=TR.RobustMakespan(
        n_scenarios=12, device=CPU), device=CPU)
    assert (p.solution.cuts, p.solution.placement, p.b, p.objective,
            p.history, p.iterations) == \
        (r.solution.cuts, r.solution.placement, r.b, r.objective,
         r.history, r.iterations)
    assert round(p.objective, 5) == 0.82546
