"""The port's simulator engines against the reference's.

The cases of ``tests/test_sim.py`` (task construction, event semantics,
admission policies, the vectorized engine, the parity grid,
``simulate_plans``, zero and single micro-batch runs, activation
high-water marks, scenario injection) and of ``tests/test_obs.py``'s idle
accounting, run on ``repro.sim`` and on ``repro_torch.sim`` with
``device="cpu"`` from the same numpy-seeded instances:

* the heap engine's records and completion times are equal (``==``): both
  packages run Python floats in the same order;
* the vectorized engine's ``mb_complete``, ``starts`` and ``ends`` are
  within ``VEC_RTOL`` = 1e-12 of the reference's (on the CPU the port's
  torch scans add in numpy's order, so the gap measured is 0), with the
  same ``engine_reason``;
* ``simulate_plans`` equals looped ``simulate_plan`` (``==``) and the
  reference within ``VEC_RTOL``;
* utilization reports equal the reference's field by field.

The parity grid uses the fixed seeds ``101 * s + 13`` (s = 0..5) of the
reference's ``test_engine_parity_grid``, on which its two engines agree;
hypothesis draws are not used.  One ``cuda``-marked case holds the
vectorized engine on the card to the CPU; it skips without a GPU.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.core as R
import repro.sim as RS

import repro_torch.core as T
import repro_torch.sim as TS
from repro_torch import obs
from repro_torch.core.cost_model import (budget_feasible,
                                         node_budget_windows,
                                         stage_memory_claims)
from repro_torch.core.profiles import ModelProfile as TModelProfile
from repro_torch.pipeline.schedule import memory_highwater

CPU = "cpu"
VEC_RTOL = 1e-12
GRID_SEEDS = [101 * s + 13 for s in range(6)]
POLICIES = ["fifo", "1f1b", "memory"]
TRACES = [(0.0, "piecewise"), (0.3, "piecewise"), (0.3, "gauss_markov")]


@pytest.fixture(scope="module")
def paper_plans():
    """The reference's ``paper_plan`` fixture in both packages: VGG-16
    (bytes), 4 servers + 4 clients, seed 1, kappa 1/32, ours(B=64, b0=8)."""
    out = []
    for C in (R, T):
        prof = C.vgg16_profile(work_units="bytes")
        net = C.make_edge_network(num_servers=4, num_clients=4, seed=1,
                                  kappa=1 / 32.0)
        kw = {} if C is R else {"device": CPU}
        out.append((prof, net, C.ours(prof, net, B=64, b0=8, **kw)))
    (_, _, rp), (_, _, tp) = out
    assert (rp.solution.cuts, rp.solution.placement, rp.b) == \
        (tp.solution.cuts, tp.solution.placement, tp.b)
    return out


def _grid_instance(C, S, seed, reentrant, cv, model):
    """The reference's ``_grid_instance`` (tests/test_sim.py) in package
    ``C`` / ``S``."""
    rng = np.random.default_rng(seed)
    prof = C.random_profile(rng, int(rng.integers(5, 11)))
    net = C.make_edge_network(num_servers=int(rng.integers(2, 5)),
                              num_clients=int(rng.integers(1, 4)), seed=seed)
    sol = (S.random_reentrant_solution if reentrant
           else S.random_chain_solution)(rng, prof, net)
    b = int(rng.integers(1, 9))
    Q = int(rng.integers(2, 14))
    scen = None
    if cv > 0:
        maker = (S.piecewise_cv_scenario if model == "piecewise"
                 else S.gauss_markov_scenario)
        scen = maker(net, cv, rng, dt=0.02, horizon=5.0)
    return prof, net, sol, b, Q, scen


def _both(make, *args):
    r = make(R, RS, *args)
    t = make(T, TS, *args)
    assert (r[2].cuts, r[2].placement) == (t[2].cuts, t[2].placement)
    return r, t


def _random_instance(seed):
    r = RS.random_instance(seed)
    t = TS.random_instance(seed)
    assert (r[2].cuts, r[2].placement, r[3], r[4]) == \
        (t[2].cuts, t[2].placement, t[3], t[4])
    return r, t


def _rec(rec):
    return (rec.microbatch, rec.stage, rec.kind, rec.resource, rec.start,
            rec.end)


def _rel_gap(want, got) -> float:
    want = np.asarray(want, dtype=float)
    got = np.asarray(got, dtype=float)
    if want.size == 0:
        return 0.0
    return float(np.max(np.abs(want - got)
                        / np.maximum(np.abs(want), 1e-30)))


def _assert_same_report(r, t, exact: bool):
    """Port report ``t`` against reference report ``r``."""
    assert (t.engine, t.engine_reason, t.policy, t.num_microbatches, t.b) \
        == (r.engine, r.engine_reason, r.policy, r.num_microbatches, r.b)
    assert isinstance(t.mb_complete, torch.Tensor)
    assert t.mb_complete.dtype == torch.float64
    if exact:
        assert np.array_equal(t.mb_complete.numpy(), r.mb_complete)
        assert [_rec(x) for x in t.records] == [_rec(x) for x in r.records]
    else:
        assert _rel_gap(r.mb_complete, t.mb_complete.numpy()) <= VEC_RTOL
    if r.timeline is not None:
        for name in ("starts", "ends"):
            assert _rel_gap(getattr(r.timeline, name),
                            getattr(t.timeline, name).numpy()) <= VEC_RTOL
    assert set(t.resource_busy) == set(r.resource_busy)
    for res, frac in r.resource_busy.items():
        assert t.resource_busy[res] == pytest.approx(frac, rel=VEC_RTOL,
                                                     abs=1e-15)


def _same_utilization(ru, tu) -> bool:
    return ((ru.t_start, ru.makespan) == (tu.t_start, tu.makespan)
            and {k: dataclasses.astuple(v) for k, v in ru.resources.items()}
            == {k: dataclasses.astuple(v) for k, v in tu.resources.items()})


# ---------------------------------------------------------------------------
# Task construction (tests/test_sim.py:320-330)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 5, 9])
def test_build_tasks_and_visit_table_equal(seed):
    (rp, rn, rs, b, _), (tp, tn, ts, _, _) = _random_instance(seed)
    rt = RS.build_visit_table(rp, rn, rs, b)
    tt = TS.build_visit_table(tp, tn, ts, b)
    for name in ("kinds", "stages", "resources"):
        assert getattr(tt, name) == getattr(rt, name)
    for name in ("work", "fixed", "fp_visit", "bp_visit"):
        assert np.array_equal(getattr(tt, name), getattr(rt, name))
    assert tt.resource_visits() == rt.resource_visits()
    assert tt.is_reentrant() == rt.is_reentrant()
    assert [dataclasses.astuple(x) for x in TS.build_tasks(tp, tn, ts, b, 3)] \
        == [dataclasses.astuple(x) for x in RS.build_tasks(rp, rn, rs, b, 3)]


def test_build_tasks_chain_shape():
    _, (prof, net, sol, b, _) = _random_instance(9)
    tasks = TS.build_tasks(prof, net, sol, b, 3)
    K = len(list(sol.segments()))
    assert len(tasks) == 3 * (2 * K + 2 * (K - 1))
    roots = [t for t in tasks if t.dep is None]
    assert len(roots) == 3
    assert all(t.resource == ("fp", 0) for t in roots)
    with pytest.raises(ValueError, match="unknown task kind"):
        TS.Task(0, 0, 0, "xx", ("fp", 0), 1.0)


# ---------------------------------------------------------------------------
# The parity grid: both engines against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cv,model", TRACES)
@pytest.mark.parametrize("reentrant", [False, True],
                         ids=["distinct", "reentrant"])
@pytest.mark.parametrize("engine", ["event", "vectorized", "auto"])
def test_engines_match_reference_on_the_parity_grid(engine, reentrant, cv,
                                                    model):
    hits = 0
    for seed in GRID_SEEDS:
        (rp, rn, rs, b, Q, rsc), (tp, tn, ts, _, _, tsc) = _both(
            _grid_instance, seed, reentrant, cv, model)
        for pol in POLICIES:
            try:
                r = RS.simulate_plan(rp, rn, rs, b, num_microbatches=Q,
                                     scenario=rsc, policy=pol, engine=engine)
            except ValueError as err:       # memory-infeasible budget
                with pytest.raises(ValueError) as got:
                    TS.simulate_plan(tp, tn, ts, b, num_microbatches=Q,
                                     scenario=tsc, policy=pol, engine=engine,
                                     device=CPU)
                assert str(got.value) == str(err)
                continue
            t = TS.simulate_plan(tp, tn, ts, b, num_microbatches=Q,
                                 scenario=tsc, policy=pol, engine=engine,
                                 device=CPU)
            _assert_same_report(r, t, exact=(r.engine == "event"))
            hits += 1
    assert hits >= 10


@pytest.mark.parametrize("cv,model", TRACES)
@pytest.mark.parametrize("reentrant", [False, True],
                         ids=["distinct", "reentrant"])
def test_compare_engines_on_the_parity_grid(reentrant, cv, model):
    """The port's own engine-parity check on the grid (the reference's
    ``test_engine_parity_grid``; both engines' runs are held to the
    reference's in the test above)."""
    hits = 0
    for seed in GRID_SEEDS:
        tp, tn, ts, b, Q, tsc = _grid_instance(T, TS, seed, reentrant, cv,
                                               model)
        for pol in POLICIES:
            try:
                got = TS.compare_engines(tp, tn, ts, b, Q, policy=pol,
                                         scenario=tsc, device=CPU)
            except ValueError:
                continue          # memory-infeasible under the budget
            assert got < 1e-9, (seed, pol, got)
            hits += 1
    assert hits >= 10


def test_engines_agree_under_both_policies():
    hits = 0
    for seed in range(12):
        _, (prof, net, sol, b, B) = _random_instance(31 * seed + 2)
        if not TS.vectorizable(prof, net, sol, b):
            continue
        hits += 1
        Q = 1 + math.ceil((B - b) / b)
        for pol in ("fifo", "1f1b"):
            assert TS.compare_engines(prof, net, sol, b, Q, policy=pol,
                                      device=CPU) < 1e-9
    assert hits >= 8


# ---------------------------------------------------------------------------
# Event ordering and contention (tests/test_sim.py:59-131)
# ---------------------------------------------------------------------------

def test_event_ordering_and_fifo():
    _, (prof, net, sol, b, B) = _random_instance(5)
    rep = TS.simulate_plan(prof, net, sol, b, B=B, device=CPU)
    by_res = {}
    for r in rep.records:
        by_res.setdefault(r.resource, []).append(r)
    for recs in by_res.values():
        recs = sorted(recs, key=lambda r: r.start)
        for a, c in zip(recs, recs[1:]):
            assert c.start >= a.end - 1e-12
        assert [r.microbatch for r in recs] == sorted(
            r.microbatch for r in recs)
    for m in range(rep.num_microbatches):
        chain = sorted((r for r in rep.records if r.microbatch == m),
                       key=lambda r: (r.start, r.end))
        for a, c in zip(chain, chain[1:]):
            assert c.start >= a.end - 1e-12


def test_colocated_stages_contend():
    out = []
    for C, S in ((R, RS), (T, TS)):
        prof = C.uniform_profile(8, fp=1.0, bp=2.0, act=1.0)
        net = C.make_edge_network(num_servers=3, num_clients=1, seed=0)
        sol = C.SplitSolution(cuts=(2, 4, 6, 8), placement=(0, 1, 2, 1))
        kw = {} if S is RS else {"device": CPU}
        solo = S.simulate_plan(prof, net, sol, 4, num_microbatches=1, **kw)
        assert solo.L_t == pytest.approx(C.fill_latency(prof, net, sol, 4),
                                         rel=1e-9)
        rep = S.simulate_plan(prof, net, sol, 4, B=32, **kw)
        assert rep.T_f >= solo.L_t - 1e-12
        fp1 = sorted((r for r in rep.records if r.resource == ("fp", 1)),
                     key=lambda r: r.start)
        assert {r.stage for r in fp1} == {1, 3}
        for a, c in zip(fp1, fp1[1:]):
            assert c.start >= a.end - 1e-12
        assert rep.L_t == pytest.approx(
            C.total_latency(prof, net, sol, 4, 32), rel=0.25)
        out.append(rep)
    assert [_rec(x) for x in out[1].records] == [_rec(x) for x in
                                                 out[0].records]


def test_fifo_policy_adds_no_edges_and_is_the_default():
    _, (prof, net, sol, b, B) = _random_instance(7)
    tasks = TS.build_tasks(prof, net, sol, b, 4)
    assert TS.FIFO().extra_dependencies(tasks) == []
    rep = TS.simulate_plan(prof, net, sol, b, B=B, device=CPU)
    assert rep.engine == "event" and rep.policy == "fifo"
    explicit = TS.simulate_plan(prof, net, sol, b, B=B, policy="fifo",
                                engine="event", device=CPU)
    assert [_rec(r) for r in rep.records] == \
        [_rec(r) for r in explicit.records]


def test_policy_windows_become_the_reference_edges():
    (rp, rn, rs, b, _), (tp, tn, ts, _, _) = _random_instance(7)
    for pol in ("1f1b", "memory"):
        r = RS.resolve_policy(pol).bind(rp, rn, rs, b)
        t = TS.resolve_policy(pol).bind(tp, tn, ts, b)
        S = len(list(ts.segments()))
        assert [t.window(S, j) for j in range(S)] == \
            [r.window(S, j) for j in range(S)]
        assert t.extra_dependencies(TS.build_tasks(tp, tn, ts, b, 6)) == \
            r.extra_dependencies(RS.build_tasks(rp, rn, rs, b, 6))


def test_vectorized_engine_covers_reentrant_and_traces():
    prof = T.uniform_profile(8, fp=1.0, bp=2.0, act=1.0)
    net = T.make_edge_network(num_servers=3, num_clients=1, seed=0)
    colocated = T.SplitSolution(cuts=(2, 4, 6, 8), placement=(0, 1, 2, 1))
    assert TS.vectorizable(prof, net, colocated, 4)
    rep = TS.simulate_plan(prof, net, colocated, 4, B=16,
                           engine="vectorized", device=CPU)
    assert rep.engine == "vectorized" and "fixpoint" in rep.engine_reason
    assert TS.compare_engines(prof, net, colocated, 4, 8, device=CPU) < 1e-9
    solo = TS.simulate_plan(prof, net, colocated, 4, num_microbatches=1,
                            engine="vectorized", device=CPU)
    assert solo.L_t == pytest.approx(T.fill_latency(prof, net, colocated, 4),
                                     rel=1e-9)
    distinct = T.SplitSolution(cuts=(2, 4, 8), placement=(0, 1, 2))
    scen = TS.NetworkScenario().with_straggler(1, 0.0, 1.0, 2.0)
    rep = TS.simulate_plan(prof, net, distinct, 4, num_microbatches=2,
                           scenario=scen, engine="auto", device=CPU)
    assert rep.engine == "vectorized" and "trace" in rep.engine_reason
    assert TS.compare_engines(prof, net, distinct, 4, 6, scenario=scen,
                              device=CPU) < 1e-9
    rep = TS.simulate_plan(prof, net, distinct, 4, num_microbatches=2,
                           scenario=TS.NetworkScenario(), engine="auto",
                           device=CPU)
    assert "constant-capacity" in rep.engine_reason


def test_vectorized_raises_with_violated_precondition():
    """No quiet fallback under engine='vectorized': the error names the
    violated precondition, as the reference's does; engine='auto' records
    why the event engine ran."""
    msgs = []
    for C, S in ((R, RS), (T, TS)):
        kw = {} if S is RS else {"device": CPU}
        prof = C.uniform_profile(4, fp=1.0, bp=1.0, act=1.0)
        nodes = [C.Node("c", f=1.0, t0=0.0, t1=0.0, b_th=0, is_client=True),
                 C.Node("s", f=1.0, t0=0.0, t1=0.0, b_th=0)]
        net = C.EdgeNetwork(nodes=nodes, rate=np.zeros((2, 2)),
                            num_clients=1)
        sol = C.SplitSolution(cuts=(2, 4), placement=(0, 1))
        assert not S.vectorizable(prof, net, sol, 1)
        with pytest.raises(ValueError, match="cannot finish its work") as e1:
            S.simulate_plan(prof, net, sol, 1, num_microbatches=2,
                            engine="vectorized", **kw)
        rep = S.simulate_plan(prof, net, sol, 1, num_microbatches=1,
                              engine="auto", **kw)
        assert rep.engine == "event"
        net2 = C.EdgeNetwork(nodes=nodes, rate=np.full((2, 2), 10.0),
                             num_clients=1)
        dead = S.NetworkScenario(link_mult={(0, 1): S.constant(0.0)})
        assert not S.vectorizable(prof, net2, sol, 1, scenario=dead)
        with pytest.raises(ValueError, match="zero trailing capacity") as e2:
            S.simulate_plan(prof, net2, sol, 1, num_microbatches=2,
                            scenario=dead, engine="vectorized", **kw)
        msgs.append((str(e1.value), rep.engine_reason, str(e2.value),
                     float(rep.mb_complete[0])))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="unknown engine"):
        TS.simulate_plan(prof, net2, sol, 1, num_microbatches=2,
                         engine="heap", device=CPU)


def test_engine_reasons_and_counters():
    _, (prof, net, sol, b, B) = _random_instance(5)
    assert TS.simulate_plan(prof, net, sol, b, B=B,
                            device=CPU).engine_reason == "event: requested"
    assert "column scans" in TS.simulate_plan(
        prof, net, sol, b, B=B, engine="auto", device=CPU).engine_reason
    assert "windowed scan" in TS.simulate_plan(
        prof, net, sol, b, B=B, engine="auto", policy="1f1b",
        device=CPU).engine_reason
    re_prof = T.uniform_profile(8, fp=1.0, bp=2.0, act=1.0)
    re_net = T.make_edge_network(num_servers=3, num_clients=1, seed=0)
    re_sol = T.SplitSolution(cuts=(2, 4, 6, 8), placement=(0, 1, 2, 1))
    obs.reset()
    with obs.enabled_scope():
        TS.simulate_plan(prof, net, sol, b, B=B, device=CPU)
        TS.simulate_plan(prof, net, sol, b, B=B, engine="auto", device=CPU)
        rep = TS.simulate_plan(re_prof, re_net, re_sol, 4, B=16,
                               engine="vectorized", device=CPU)
        TS.simulate_plans(prof, net, [(sol, b), (sol, b + 1)], B=B,
                          device=CPU)
    sweeps = int(rep.engine_reason.split("(")[1].split()[0])
    assert obs.counter("sim.dispatch.event") == 1
    assert obs.counter("sim.dispatch.vectorized") == 4
    assert obs.counter("sim.engine_reason[event: requested]") == 1
    assert obs.counter("sim.engine_reason[vectorized: constant-capacity "
                       "column scans]") == 1
    assert obs.counter("sim.engine_reason[vectorized: reentrant "
                       "merged-scan fixpoint]") == 1
    assert obs.counter("sim.fixpoint_runs") == 1
    assert obs.counter("sim.fixpoint_sweeps") == sweeps
    spans = obs.span_summary()
    assert spans["sim.simulate_plan"]["count"] == 3
    assert spans["sim.simulate_plans"]["count"] == 1
    obs.reset()


# ---------------------------------------------------------------------------
# simulate_plans (tests/test_sim.py:522-583)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("placement", [(0, 1, 2), (0, 1, 2, 1)],
                         ids=["chain", "reentrant"])
@pytest.mark.parametrize("traced", [False, True], ids=["const", "traced"])
def test_simulate_plans_matches_looped_and_reference(policy, placement,
                                                     traced):
    out = []
    for C, S in ((R, RS), (T, TS)):
        kw = {} if S is RS else {"device": CPU}
        prof = C.uniform_profile(8, fp=1.0, bp=2.0, act=1.0)
        nodes = [C.Node("c", f=1.0, t0=0.0, t1=0.0, b_th=0, is_client=True,
                        mem=1e3)]
        nodes += [C.Node(f"s{i}", f=1.0 + 0.5 * i, t0=0.0, t1=0.0, b_th=0,
                         mem=60.0) for i in (1, 2)]
        rate = np.full((3, 3), 10.0)
        np.fill_diagonal(rate, 0.0)
        net = C.EdgeNetwork(nodes=nodes, rate=rate, num_clients=1)
        cuts = (2, 4, 8) if len(placement) == 3 else (2, 4, 6, 8)
        sol = C.SplitSolution(cuts=cuts, placement=placement)
        scen = None
        if traced:
            scen = S.gauss_markov_scenario(net, 0.3, np.random.default_rng(3),
                                           dt=0.5, horizon=400.0)
        plans = [(sol, b) for b in (1, 2, 3, 4)]
        bat = S.simulate_plans(prof, net, plans, B=12, policy=policy,
                               scenario=scen, **kw)
        loop = [S.simulate_plan(prof, net, s, b, B=12, policy=policy,
                                scenario=scen, engine="auto", **kw)
                for s, b in plans]
        for lr, br in zip(loop, bat):
            if traced:
                # a traced chain under windows stacks into the merged-scan
                # fixpoint, whose work-space scans add in another order
                # than the looped scalar pass (the reference's own gap)
                assert _rel_gap(lr.mb_complete, br.mb_complete) <= VEC_RTOL
            else:
                assert np.array_equal(np.asarray(lr.mb_complete),
                                      np.asarray(br.mb_complete))
        out.append(bat)
    for r, t in zip(*out):
        assert t.engine_reason == r.engine_reason
        assert _rel_gap(r.mb_complete, t.mb_complete.numpy()) <= VEC_RTOL


def test_simulate_plans_mixed_kind_reentrant_group_exact():
    out = []
    for C, S in ((R, RS), (T, TS)):
        kw = {} if S is RS else {"device": CPU}
        prof = C.uniform_profile(8, fp=1.0, bp=2.0, act=1.0)
        fp = np.ones(8)
        fp[6:] = 0.0
        prof = dataclasses.replace(prof, fp_work=fp)
        nodes = [C.Node("c", f=1.0, t0=0.0, t1=0.0, b_th=0, is_client=True)]
        nodes += [C.Node(f"s{i}", f=1.0, t0=0.0, t1=0.0, b_th=0)
                  for i in (1, 2)]
        rate = np.full((3, 3), 10.0)
        np.fill_diagonal(rate, 0.0)
        net = C.EdgeNetwork(nodes=nodes, rate=rate, num_clients=1)
        sol = C.SplitSolution(cuts=(2, 4, 6, 8), placement=(0, 1, 2, 1))
        # the reference's case at a 200-s horizon (4,000 breakpoints a
        # trace, not 10,000; the last value holds past it)
        scen = S.gauss_markov_scenario(net, 0.4, np.random.default_rng(7),
                                       dt=0.05, horizon=200.0)
        plans = [(sol, b) for b in (1, 2, 3)]
        bat = S.simulate_plans(prof, net, plans, B=9, scenario=scen,
                               engine="auto", **kw)
        out.append(bat)
        if S is RS:
            continue                # the reference's own test checks it
        loop = [S.simulate_plan(prof, net, s, b, B=9, scenario=scen,
                                engine="auto", **kw) for s, b in plans]
        ev = [S.simulate_plan(prof, net, s, b, B=9, scenario=scen,
                              engine="event", **kw) for s, b in plans]
        for lr, br, er in zip(loop, bat, ev):
            assert torch.equal(lr.mb_complete, br.mb_complete)
            assert _rel_gap(er.mb_complete, br.mb_complete) < 1e-9
    for r, t in zip(*out):
        assert _rel_gap(r.mb_complete, t.mb_complete.numpy()) <= VEC_RTOL


def test_stacked_report_carries_completion_times_only():
    _, (prof, net, sol, b, _) = _random_instance(1)
    reps = TS.simulate_plans(prof, net, [(sol, b), (sol, max(1, b - 1))],
                             num_microbatches=[5, 5], engine="auto",
                             device=CPU)
    stacked = [r for r in reps if r.timeline is None and r._records is None]
    assert stacked, [r.engine_reason for r in reps]
    with pytest.raises(ValueError, match="stacked"):
        stacked[0].utilization()
    with pytest.raises(ValueError, match="align"):
        TS.simulate_plans(prof, net, [(sol, b)], num_microbatches=[1, 2],
                          device=CPU)


# ---------------------------------------------------------------------------
# Zero and single micro-batch runs; dense timelines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["fifo", "1f1b"])
@pytest.mark.parametrize("engine", ["event", "vectorized"])
def test_zero_microbatches_empty_report(policy, engine):
    _, (prof, net, sol, b, _) = _random_instance(3)
    rep = TS.simulate_plan(prof, net, sol, b, num_microbatches=0,
                           policy=policy, engine=engine, device=CPU)
    assert rep.num_microbatches == 0
    assert len(rep.mb_complete) == 0 and rep.records == []
    assert rep.L_t == 0.0 and rep.resource_busy == {}
    assert rep.T_i == 0.0


@pytest.mark.parametrize("policy", ["fifo", "1f1b", "memory"])
@pytest.mark.parametrize("engine", ["event", "auto"])
def test_single_microbatch_is_the_fill(policy, engine):
    (rp, rn, rs, b, _), (prof, net, sol, _, _) = _random_instance(3)
    want = T.fill_latency(prof, net, sol, b)
    assert want == R.fill_latency(rp, rn, rs, b)
    rep = TS.simulate_plan(prof, net, sol, b, B=b, policy=policy,
                           engine=engine, device=CPU)
    ref = RS.simulate_plan(rp, rn, rs, b, B=b, policy=policy, engine=engine)
    assert rep.num_microbatches == 1 and rep.T_i == 0.0
    assert rep.L_t == pytest.approx(want, rel=1e-9)
    assert rep.L_t == ref.L_t


def test_vectorized_report_timeline_and_lazy_records():
    (rp, rn, rs, b, B), (prof, net, sol, _, _) = _random_instance(5)
    rep = TS.simulate_plan(prof, net, sol, b, B=B, engine="vectorized",
                           device=CPU)
    assert rep.engine == "vectorized" and rep.timeline is not None
    Q, R_ = rep.timeline.starts.shape
    assert Q == rep.num_microbatches == rep.timeline.num_microbatches
    assert len(rep.records) == Q * R_
    assert rep.records is rep.records
    assert torch.all(rep.timeline.ends >= rep.timeline.starts - 1e-12)
    assert torch.all(torch.diff(rep.timeline.ends, dim=1) >= -1e-12)
    ref = RS.simulate_plan(rp, rn, rs, b, B=B, engine="vectorized")
    assert [_rec(x) for x in rep.records] == [_rec(x) for x in ref.records]
    assert np.array_equal(rep.intervals().numpy(), ref.intervals())


# ---------------------------------------------------------------------------
# Activation high-water marks against pipeline.schedule's claims
# ---------------------------------------------------------------------------

def _saturating_instance(S=4, Q=12):
    fp = np.full(S, 1e-3)
    bp = np.full(S, 1e-3)
    bp[-1] = 10.0
    prof = TModelProfile(name="sat", fp_work=fp, bp_work=bp,
                         act_bytes=np.full(S, 1.0),
                         grad_bytes=np.full(S, 1.0),
                         param_bytes=np.zeros(S), opt_bytes=np.zeros(S))
    nodes = [T.Node("c", f=1.0, t0=0.0, t1=0.0, b_th=0, is_client=True)]
    nodes += [T.Node(f"s{i}", f=1.0, t0=0.0, t1=0.0, b_th=0)
              for i in range(1, S)]
    rate = np.full((S, S), 1e6)
    np.fill_diagonal(rate, 0.0)
    net = T.EdgeNetwork(nodes=nodes, rate=rate, num_clients=1)
    sol = T.SplitSolution(cuts=tuple(range(1, S + 1)),
                          placement=tuple(range(S)))
    return prof, net, sol, Q


@pytest.mark.parametrize("seed", [1, 5, 9])
def test_highwater_never_exceeds_schedule_claims(seed):
    _, (prof, net, sol, b, B) = _random_instance(seed)
    Q = 1 + math.ceil((B - b) / b)
    S = len(list(sol.segments()))
    for pol in ("fifo", "1f1b"):
        claims = memory_highwater(S, Q, pol)
        for eng in ("event", "auto"):
            rep = TS.simulate_plan(prof, net, sol, b, num_microbatches=Q,
                                   policy=pol, engine=eng, device=CPU)
            occ = TS.activation_occupancy(rep.records)
            assert set(occ) == set(claims)
            for j, series in occ.items():
                assert all(level <= claims[j] for _, level in series)


def test_1f1b_highwater_matches_schedule_claims_exactly():
    prof, net, sol, Q = _saturating_instance(S=4, Q=12)
    for pol in ("fifo", "1f1b"):
        rep = TS.simulate_plan(prof, net, sol, 1, num_microbatches=Q,
                               policy=pol, engine="event", device=CPU)
        assert TS.stage_activation_highwater(rep.records) == \
            memory_highwater(4, Q, pol)
    small = TS.simulate_plan(prof, net, sol, 1, num_microbatches=2,
                             policy="1f1b", engine="event", device=CPU)
    assert TS.stage_activation_highwater(small.records) == \
        memory_highwater(4, 2, "1f1b")
    fifo = TS.simulate_plan(prof, net, sol, 1, num_microbatches=Q,
                            policy="fifo", device=CPU)
    one = TS.simulate_plan(prof, net, sol, 1, num_microbatches=Q,
                           policy="1f1b", device=CPU)
    assert one.L_t >= fifo.L_t - 1e-9
    hw_f = TS.stage_activation_highwater(fifo.records)
    hw_1 = TS.stage_activation_highwater(one.records)
    assert all(hw_1[j] <= hw_f[j] for j in hw_f) and hw_1[0] < hw_f[0]


def _budget_instance(mem_server=14.0, S=4):
    """The reference's hand-built budget chain (tests/test_cost_model.py):
    static 2/layer, act+grad 2/layer per live micro-batch at b = 1."""
    prof = T.uniform_profile(S, fp=1.0, bp=1.0, act=1.0, param=1.0)
    nodes = [T.Node("c", f=1.0, t0=0.0, t1=0.0, b_th=0, is_client=True,
                    mem=1000.0)]
    nodes += [T.Node(f"s{i}", f=1.0, t0=0.0, t1=0.0, b_th=0, mem=mem_server)
              for i in range(1, S)]
    rate = np.full((S, S), 1e6)
    np.fill_diagonal(rate, 0.0)
    net = T.EdgeNetwork(nodes=nodes, rate=rate, num_clients=1)
    sol = T.SplitSolution(cuts=tuple(range(1, S + 1)),
                          placement=tuple(range(S)))
    return prof, net, sol


def test_memory_budgeted_windows_and_claims():
    prof, net, sol = _budget_instance(mem_server=14.0)
    claims = stage_memory_claims(prof, net, sol, b=1)
    assert [c.static_bytes for c in claims] == [2.0] * 4
    ws = node_budget_windows(prof, net, sol, b=1)
    assert ws == [499, 6, 6, 6]
    pol = TS.MemoryBudgeted().bind(prof, net, sol, 1)
    assert [pol.window(4, j) for j in range(4)] == ws
    assert pol.stage_capacity(4, 20) == {0: 20, 1: 6, 2: 6, 3: 6}
    assert memory_highwater(4, 9, "memory", bind=(prof, net, sol, 1)) == \
        pol.stage_capacity(4, 9)
    assert [p._windows for p in TS.MemoryBudgeted().bind_many(
        prof, net, [(sol, 1), (sol, 2)])] == \
        [tuple(ws), tuple(node_budget_windows(prof, net, sol, 2))]
    with pytest.raises(RuntimeError, match="bind"):
        TS.MemoryBudgeted().window(4, 0)
    with pytest.raises(ValueError, match="bound for 4 stages"):
        pol.window(3, 0)


def test_memory_budget_claims_hold_event_by_event():
    prof, net, sol = _budget_instance(mem_server=8.0)    # window 3
    slow = dataclasses.replace(prof, bp_work=np.array([0.001] * 3 + [10.0]))
    Q = 12
    claims = TS.MemoryBudgeted().bind(slow, net, sol, 1).stage_capacity(4, Q)
    for engine in ("event", "vectorized"):
        rep = TS.simulate_plan(slow, net, sol, 1, num_microbatches=Q,
                               policy=TS.MemoryBudgeted(), engine=engine,
                               device=CPU)
        occ = TS.activation_occupancy(rep.records)
        for j, series in occ.items():
            assert all(level <= claims[j] for _, level in series)
        assert TS.stage_activation_highwater(rep.records)[2] == 3
    small = _budget_instance(mem_server=3.0)
    assert not budget_feasible(*small, 1)
    with pytest.raises(ValueError, match="memory-infeasible"):
        TS.simulate_plan(*small, 1, num_microbatches=4, policy="memory",
                         device=CPU)
    with pytest.raises(ValueError, match="memory-infeasible"):
        TS.simulate_plans(small[0], small[1], [(small[2], 1)],
                          num_microbatches=[4], policy="memory", device=CPU)


# ---------------------------------------------------------------------------
# Idle accounting (tests/test_obs.py:49-215)
# ---------------------------------------------------------------------------

def _chain(C):
    prof = C.uniform_profile(4, fp=1.0, bp=0.5, act=1.0)
    nodes = [C.Node("c", f=0.5, t0=0.0, t1=0.0, b_th=0, is_client=True),
             C.Node("s", f=2.0, t0=0.0, t1=0.0, b_th=0)]
    net = C.EdgeNetwork(nodes=nodes,
                        rate=np.array([[0.0, 10.0], [10.0, 0.0]]),
                        num_clients=1)
    return prof, net, C.SplitSolution(cuts=(2, 4), placement=(0, 1))


@pytest.mark.parametrize("engine", ["event", "vectorized"])
def test_bubble_identity_closed_form(engine):
    prof, net, sol = _chain(T)
    b, Q = 2, 8
    rep = TS.simulate_plan(prof, net, sol, b, num_microbatches=Q,
                           engine=engine, device=CPU)
    u = rep.utilization()
    T_i = T.pipeline_interval(prof, net, sol, b)
    assert rep.T_f == pytest.approx(T.fill_latency(prof, net, sol, b),
                                    rel=1e-12)
    assert rep.T_i == pytest.approx(T_i, rel=1e-12)
    assert rep.L_t == pytest.approx(T.total_latency(prof, net, sol, b,
                                                    b * Q), rel=1e-12)
    d = {res: ru.service / Q for res, ru in u.resources.items()}
    assert d[("fp", 0)] == pytest.approx(T_i, rel=1e-12)
    for res, ru in u.resources.items():
        assert ru.bubble == pytest.approx((Q - 1) * (T_i - d[res]),
                                          rel=1e-9, abs=1e-12), res
        assert ru.idle == pytest.approx(rep.L_t - Q * d[res], rel=1e-12)
        assert ru.blocked == 0.0
    assert u.resources[("fp", 0)].bubble == 0.0
    assert u.idle_fraction_total == pytest.approx(
        u.bubble_fraction + u.fill_drain_fraction, rel=1e-12)
    rp, rn, rs = _chain(R)
    ref = RS.simulate_plan(rp, rn, rs, b, num_microbatches=Q, engine=engine)
    assert _same_utilization(ref.utilization(), u)
    assert u.node_idle_fraction() == ref.utilization().node_idle_fraction()
    assert u.link_idle_fraction() == ref.utilization().link_idle_fraction()
    assert u.service_fractions() == ref.utilization().service_fractions()


def test_blocked_time_under_outage():
    reps = []
    for C, S in ((R, RS), (T, TS)):
        kw = {} if S is RS else {"device": CPU}
        prof, net, sol = _chain(C)
        scen = S.NetworkScenario().with_outage(0, 1, 8.05, 9.0)
        rep = S.simulate_plan(prof, net, sol, 2, num_microbatches=4,
                              scenario=scen, engine="event", **kw)
        reps.append(rep.utilization(net=net, scenario=scen))
    u = reps[1]
    ru = u.resources[("fwd", 0, 1)]
    assert ru.blocked > 0.0 and ru.busy > 0.0
    assert ru.service == pytest.approx(ru.busy + ru.blocked, rel=1e-12)
    assert u.resources[("fp", 0)].blocked == 0.0
    assert _same_utilization(reps[0], u)
    assert u.blocked_by_resource() == reps[0].blocked_by_resource()
    assert u.blocked_fraction_total == reps[0].blocked_fraction_total


@pytest.mark.parametrize("traced", [False, True], ids=["const", "traced"])
@pytest.mark.parametrize("reentrant", [False, True],
                         ids=["distinct", "reentrant"])
def test_utilization_parity_grid(reentrant, traced):
    """Event- and timeline-built reports agree (the port's
    ``compare_utilization``), and each equals the reference's report."""
    hits = 0
    # seeds whose reentrant draw is a valid co-location (others raise)
    for seed in ([8, 15, 16, 17, 22, 31] if reentrant else range(6)):
        for pol in ("fifo", "1f1b"):
            cases = []
            for C, S in ((R, RS), (T, TS)):
                kw = {} if S is RS else {"device": CPU}
                prof, net, sol, b, _B = S.random_instance(seed)
                scen = None
                if traced:
                    scen = S.gauss_markov_scenario(
                        net, 0.4, np.random.default_rng(seed), dt=0.37,
                        horizon=60.0)
                try:
                    if reentrant:       # may draw an invalid co-location
                        sol = S.random_reentrant_solution(
                            np.random.default_rng(seed), prof, net)
                    gap = S.compare_utilization(prof, net, sol, b, 6,
                                                policy=pol, scenario=scen,
                                                **kw)
                except ValueError:
                    cases.append(None)
                    continue
                reps = [S.simulate_plan(prof, net, sol, b,
                                        num_microbatches=6, policy=pol,
                                        scenario=scen, engine=eng, **kw)
                        .utilization(net=net, scenario=scen)
                        for eng in ("event", "vectorized")]
                cases.append((gap, reps))
            if cases[0] is None:
                assert cases[1] is None
                continue
            assert cases[1][0] < 1e-9
            for ru, tu in zip(cases[0][1], cases[1][1]):
                assert _same_utilization(ru, tu)
            hits += 1
    assert hits >= 6


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_resource_busy_unified_across_engines_trace_scaled(seed):
    _, (prof, net, sol, b, _B) = _random_instance(seed)
    scen = TS.gauss_markov_scenario(net, 0.5, np.random.default_rng(seed),
                                    dt=0.31, horizon=80.0)
    ev = TS.simulate_plan(prof, net, sol, b, num_microbatches=6,
                          scenario=scen, engine="event", device=CPU)
    vec = TS.simulate_plan(prof, net, sol, b, num_microbatches=6,
                           scenario=scen, engine="vectorized", device=CPU)
    assert set(ev.resource_busy) == set(vec.resource_busy)
    for res in ev.resource_busy:
        assert ev.resource_busy[res] == pytest.approx(
            vec.resource_busy[res], rel=1e-12, abs=1e-12)
    for rep in (ev, vec):
        frac = rep.utilization().service_fractions()
        for res in rep.resource_busy:
            assert frac[res] == pytest.approx(rep.resource_busy[res],
                                              rel=1e-12, abs=1e-12)


# ---------------------------------------------------------------------------
# Scenario injection on the paper's plan (tests/test_sim.py:186-219,
# 649-720): the port's makespans equal the reference's
# ---------------------------------------------------------------------------

def _paper_scenarios(S, plan, L):
    node = plan.solution.placement[1]
    a = plan.solution.placement[0]
    t_mid = 0.5 * L
    return {
        "straggler": S.NetworkScenario().with_straggler(node, 0.0, L, 8.0),
        "outage": S.NetworkScenario().with_outage(a, node, 0.0, 5.0 * L),
        "zero-length": S.NetworkScenario().with_straggler(
            node, 2.0, 2.0, 8.0).with_outage(a, node, 1.0, 1.0),
        "overlap": S.NetworkScenario().with_straggler(
            node, 0.0, t_mid, 6.0).with_outage(a, node, 0.25 * L, t_mid),
    }


@pytest.mark.parametrize("name", ["straggler", "outage", "zero-length",
                                  "overlap"])
@pytest.mark.parametrize("policy", ["fifo", "1f1b"])
def test_scenarios_on_the_paper_plan_match_reference(paper_plans, name,
                                                     policy):
    (rp, rn, rplan), (tp, tn, tplan) = paper_plans
    base = RS.simulate_plan(rp, rn, rplan.solution, rplan.b, B=rplan.B)
    t_base = TS.simulate_plan(tp, tn, tplan.solution, tplan.b, B=tplan.B,
                              device=CPU)
    assert t_base.L_t == base.L_t
    rsc = _paper_scenarios(RS, rplan, base.L_t)[name]
    tsc = _paper_scenarios(TS, tplan, base.L_t)[name]
    for engine in ("event", "auto"):
        r = RS.simulate_plan(rp, rn, rplan.solution, rplan.b, B=rplan.B,
                             scenario=rsc, policy=policy, engine=engine)
        t = TS.simulate_plan(tp, tn, tplan.solution, tplan.b, B=tplan.B,
                             scenario=tsc, policy=policy, engine=engine,
                             device=CPU)
        _assert_same_report(r, t, exact=(engine == "event"))
        assert np.isfinite(t.L_t)
    if name == "straggler":
        assert t.L_t > t_base.L_t
    if name == "outage":
        assert t.T_f >= 5.0 * base.L_t
    if name == "zero-length" and policy == "fifo":
        assert t.L_t == pytest.approx(t_base.L_t, rel=1e-12)


@pytest.mark.parametrize("maker", ["piecewise_cv_scenario",
                                   "gauss_markov_scenario"])
def test_time_varying_scenarios_on_the_paper_plan(paper_plans, maker):
    (rp, rn, rplan), (tp, tn, tplan) = paper_plans
    base = RS.simulate_plan(rp, rn, rplan.solution, rplan.b, B=rplan.B)
    rsc = getattr(RS, maker)(rn, 0.3, np.random.default_rng(1),
                             dt=base.L_t / 16, horizon=4 * base.L_t)
    tsc = getattr(TS, maker)(tn, 0.3, np.random.default_rng(1),
                             dt=base.L_t / 16, horizon=4 * base.L_t)
    for pol in POLICIES:
        for engine in ("event", "vectorized"):
            r = RS.simulate_plan(rp, rn, rplan.solution, rplan.b, B=rplan.B,
                                 scenario=rsc, policy=pol, engine=engine)
            t = TS.simulate_plan(tp, tn, tplan.solution, tplan.b,
                                 B=tplan.B, scenario=tsc, policy=pol,
                                 engine=engine, device=CPU)
            _assert_same_report(r, t, exact=(engine == "event"))
            assert torch.all(torch.diff(t.mb_complete) > -1e-12)


def test_write_chrome_trace_waits_for_item_6(paper_plans, tmp_path):
    """Chrome-trace export is ported: the paper plan's trace (event and
    vectorized runs, counter tracks and flow events) equals the
    reference's JSON and validates."""
    import json
    (rp, rn, rplan), (tp, tn, tplan) = paper_plans
    for engine in ("event", "vectorized"):
        r = RS.simulate_plan(rp, rn, rplan.solution, rplan.b, B=rplan.B,
                             engine=engine)
        t = TS.simulate_plan(tp, tn, tplan.solution, tplan.b, B=tplan.B,
                             engine=engine, device=CPU)
        kw = dict(counter_tracks=True, flow_events=True)
        rpath = RS.write_chrome_trace(r.records, str(tmp_path / "r.json"),
                                      **kw)
        tpath = TS.write_chrome_trace(t.records, str(tmp_path / "t.json"),
                                      **kw)
        with open(rpath) as f, open(tpath) as g:
            want, got = json.load(f), json.load(g)
        assert got == want
        assert obs.validate_chrome_trace(got) == []


# ---------------------------------------------------------------------------
# On the card: the vectorized engine on cuda against the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("no GPU visible: the cuda run of the engine needs the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cv,model", TRACES)
@pytest.mark.parametrize("reentrant", [False, True],
                         ids=["distinct", "reentrant"])
def test_vectorized_engine_on_cuda_matches_cpu(gpu, reentrant, cv, model):
    for seed in GRID_SEEDS:
        prof, net, sol, b, Q, scen = _grid_instance(T, TS, seed, reentrant,
                                                    cv, model)
        for pol in POLICIES:
            try:
                want = TS.simulate_plan(prof, net, sol, b,
                                        num_microbatches=Q, scenario=scen,
                                        policy=pol, engine="vectorized",
                                        device=CPU)
            except ValueError:
                continue
            got = TS.simulate_plan(prof, net, sol, b, num_microbatches=Q,
                                   scenario=scen, policy=pol,
                                   engine="vectorized", device=gpu)
            assert got.mb_complete.device.type == "cuda"
            assert got.engine_reason.split(" (")[0] == \
                want.engine_reason.split(" (")[0]
            for g, w in ((got.mb_complete, want.mb_complete),
                         (got.timeline.starts, want.timeline.starts),
                         (got.timeline.ends, want.timeline.ends)):
                torch.testing.assert_close(g.cpu(), w, rtol=VEC_RTOL,
                                           atol=0)
