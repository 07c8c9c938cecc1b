"""The port's Eq.-(14) cross-validation, solution checks and Eq.-(11)
memory claims against the reference.

The same numpy-seeded instances go through ``repro`` and ``repro_torch``
(``device="cpu"``): every ``CrossCheck`` of ``cross_validate_many`` is
equal (``==``, field by field) and ``ok`` at rtol 1e-6; ``validate_solution``
raises the reference's ``ValueError`` messages; ``no_pipeline_latency``,
``stage_of_layer``, ``stage_memory_claims``, ``node_budget_windows(_many)``,
``budget_feasible`` and ``DegradedTail`` budgets are equal.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro.core.cost_model as R_cm
import repro.core.latency as R_lat
import repro.sim as RS

import repro_torch.core as T
import repro_torch.core.cost_model as T_cm
import repro_torch.core.latency as T_lat
import repro_torch.sim as TS

CPU = "cpu"


def _astuples(checks):
    return [dataclasses.astuple(c) for c in checks]


@pytest.mark.parametrize("seed,trials", [(0, 20), (11, 24)])
def test_cross_validate_many_equals_reference(seed, trials):
    want = RS.cross_validate_many(trials, seed=seed, rtol=1e-6)
    got = TS.cross_validate_many(trials, seed=seed, rtol=1e-6, device=CPU)
    assert len(got) == trials
    assert _astuples(got) == _astuples(want)
    for c in got:
        assert c.ok, (c.max_rel_err, c.cuts, c.placement, c.b, c.B)
    assert max(c.max_rel_err for c in got) < 1e-9


def test_cross_validate_on_planner_output():
    """``ours`` (the planner, K1's path on the card) then the Eq. (14)
    check, as the reference's ``test_cross_validation_on_planner_output``."""
    out = []
    for C, S, kw in ((R, RS, {}), (T, TS, {"device": CPU})):
        prof = C.vgg16_profile(work_units="bytes")
        net = C.make_edge_network(num_servers=4, num_clients=4, seed=1,
                                  kappa=1 / 32.0)
        plan = C.ours(prof, net, B=64, b0=8, **kw)
        c = S.cross_validate(prof, net, plan.solution, plan.b, plan.B, **kw)
        assert c.ok
        assert c.L_t_ana == pytest.approx(plan.L_t, rel=1e-9)
        out.append(dataclasses.astuple(c))
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", [0, 4, 9, 17])
def test_random_instances_and_solutions_equal(seed):
    r = RS.random_instance(seed)
    t = TS.random_instance(seed)
    assert (r[2].cuts, r[2].placement, r[3], r[4]) == \
        (t[2].cuts, t[2].placement, t[3], t[4])
    assert np.array_equal(r[1].rate, t[1].rate)
    for fn in ("random_chain_solution", "random_reentrant_solution"):
        try:
            rs = getattr(RS, fn)(np.random.default_rng(seed), r[0], r[1])
        except ValueError as err:
            with pytest.raises(ValueError) as got:
                getattr(TS, fn)(np.random.default_rng(seed), t[0], t[1])
            assert str(got.value) == str(err)
            continue
        ts = getattr(TS, fn)(np.random.default_rng(seed), t[0], t[1])
        assert (rs.cuts, rs.placement) == (ts.cuts, ts.placement)


def test_cross_check_fields():
    _, net, sol, b, B = TS.random_instance(2)
    c = TS.cross_validate(*TS.random_instance(2), device=CPU)
    assert isinstance(c, TS.CrossCheck)
    assert (c.cuts, c.placement, c.b, c.B) == (sol.cuts, sol.placement, b, B)
    assert c.rtol == 1e-6 and c.ok
    tight = dataclasses.replace(c, L_t_sim=c.L_t_ana * (1 + 1e-3))
    assert not tight.ok and tight.max_rel_err == pytest.approx(1e-3)


# ---------------------------------------------------------------------------
# validate_solution, stage_of_layer, no_pipeline_latency
# ---------------------------------------------------------------------------

BAD_SOLUTIONS = {
    "not on the client": ((6,), (1,)),
    "decreasing cuts": ((4, 2, 6), (0, 1, 2)),
    "consecutive same node": ((2, 4, 6), (0, 1, 1)),
    "last cut": ((2, 5), (0, 1)),
    "cut out of range": ((0, 6), (0, 1)),
    "placement out of range": ((2, 6), (0, 9)),
    "server on the client": ((2, 4, 6), (0, 1, 0)),
}


def _small(C, seed=0):
    rng = np.random.default_rng(seed)
    return (C.random_profile(rng, 6),
            C.make_edge_network(num_servers=3, num_clients=2, seed=seed))


@pytest.mark.parametrize("name", sorted(BAD_SOLUTIONS))
def test_validate_solution_raises_the_reference_errors(name):
    cuts, placement = BAD_SOLUTIONS[name]
    rp, rn = _small(R)
    tp, tn = _small(T)
    with pytest.raises(ValueError) as want:
        R_lat.validate_solution(R.SplitSolution(cuts, placement), rp, rn)
    with pytest.raises(ValueError) as got:
        T_lat.validate_solution(T.SplitSolution(cuts, placement), tp, tn)
    assert str(got.value) == str(want.value)


def test_validate_solution_accepts_good_solutions():
    tp, tn = _small(T)
    for cuts, placement in (((6,), (0,)), ((2, 4, 6), (0, 1, 2)),
                            ((1, 2, 4, 6), (0, 1, 2, 1)),
                            ((2, 2, 6), (0, 1, 1))):
        T_lat.validate_solution(T.SplitSolution(cuts, placement), tp, tn)


@pytest.mark.parametrize("seed", [0, 3])
def test_no_pipeline_latency_and_stage_of_layer_equal(seed):
    rp, rn = _small(R, seed)
    tp, tn = _small(T, seed)
    for cuts, placement in (((3, 6), (0, 1)), ((1, 2, 4, 6), (0, 1, 2, 1)),
                            ((2, 2, 6), (0, 3, 2))):
        rs = R.SplitSolution(cuts, placement)
        ts = T.SplitSolution(cuts, placement)
        for B in (1, 16, 128):
            got = T_lat.no_pipeline_latency(tp, tn, ts, B)
            assert got == R_lat.no_pipeline_latency(rp, rn, rs, B)
            assert got == T.fill_latency(tp, tn, ts, B)
        assert [ts.stage_of_layer(i) for i in range(1, 7)] == \
            [rs.stage_of_layer(i) for i in range(1, 7)]
        with pytest.raises(ValueError, match="layer 7 not covered"):
            ts.stage_of_layer(7)


# ---------------------------------------------------------------------------
# The Eq. (11) claims source
# ---------------------------------------------------------------------------

def _claims_case(C, S, seed):
    prof, net, sol, b, B = S.random_instance(seed)
    try:
        sol = S.random_reentrant_solution(np.random.default_rng(seed),
                                          prof, net)
    except ValueError:
        pass                        # keep the distinct chain
    return prof, net, sol, b


@pytest.mark.parametrize("memory_model", ["refined", "paper"])
@pytest.mark.parametrize("seed", [3, 8, 15, 16, 22])
def test_memory_claims_and_windows_equal(seed, memory_model):
    rp, rn, rs, b = _claims_case(R, RS, seed)
    tp, tn, ts, _ = _claims_case(T, TS, seed)
    assert (rs.cuts, rs.placement) == (ts.cuts, ts.placement)
    rc = R_cm.stage_memory_claims(rp, rn, rs, b, memory_model)
    tc = T_cm.stage_memory_claims(tp, tn, ts, b, memory_model)
    assert [dataclasses.astuple(c) for c in tc] == \
        [dataclasses.astuple(c) for c in rc]
    bs = list(range(1, 33))
    want = R_cm.node_budget_windows_many(rp, rn, rs, bs, memory_model)
    got = T_cm.node_budget_windows_many(tp, tn, ts, bs, memory_model)
    assert got == want
    for b_, ws in zip(bs, got):
        assert ws == T_cm.node_budget_windows(tp, tn, ts, b_, memory_model)
        assert T_cm.budget_feasible(tp, tn, ts, b_, memory_model) == \
            R_cm.budget_feasible(rp, rn, rs, b_, memory_model)
    pols = TS.MemoryBudgeted(memory_model).bind_many(
        tp, tn, [(ts, b_) for b_ in bs])
    assert [list(p._windows) for p in pols] == want


def _mem_pressure(S, net, n, seed=0):
    """``n`` seeded memory-pressure scenarios (one or two windows each)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        scen = S.NetworkScenario()
        for _ in range(int(rng.integers(1, 3))):
            node = int(rng.integers(0, len(net.nodes)))
            start = float(rng.uniform(0.0, 5.0))
            scen = scen.with_mem_pressure(node, start,
                                          start + float(rng.uniform(0.1, 3)),
                                          float(rng.uniform(0.2, 0.9)))
        out.append(scen)
    return out


@pytest.mark.parametrize("alpha", [0.5, 0.8, 1.0 - 1.0 / 8 + 1e-9])
def test_degraded_tail_equals_reference(alpha):
    rp, rn, rs, b, _ = RS.random_instance(3)
    tp, tn, ts, _, _ = TS.random_instance(3)
    rtail = R_cm.DegradedTail.from_scenarios(rn, _mem_pressure(RS, rn, 8),
                                             alpha=alpha)
    ttail = T_cm.DegradedTail.from_scenarios(tn, _mem_pressure(TS, tn, 8),
                                             alpha=alpha)
    assert ttail.mem == rtail.mem and repr(ttail) == repr(rtail)
    for i, node in enumerate(tn.nodes):
        assert ttail.node_mem(tn, i) <= node.mem + 1e-9
    nominal = T_cm.node_budget_windows(tp, tn, ts, b)
    tight = T_cm.node_budget_windows(tp, tn, ts, b, tail=ttail)
    assert tight == R_cm.node_budget_windows(rp, rn, rs, b, tail=rtail)
    assert all(tw is None if nw is None else tw <= nw
               for tw, nw in zip(tight, nominal))
    assert T_cm.budget_feasible(tp, tn, ts, b, tail=ttail) == \
        R_cm.budget_feasible(rp, rn, rs, b, tail=rtail)
    pol = TS.MemoryBudgeted(tail=ttail).bind(tp, tn, ts, b)
    assert list(pol._windows) == tight


def test_degraded_tail_arguments():
    _, net, _, _, _ = TS.random_instance(3)
    assert T_cm.DegradedTail(mem=(None,)).node_mem(net, 0) == \
        net.nodes[0].mem
    assert T_cm.DegradedTail(mem=(5.0,)).node_mem(net, 0) == 5.0
    assert "nominal" in repr(T_cm.DegradedTail(mem=(None,)))
    with pytest.raises(ValueError, match="at least one"):
        T_cm.DegradedTail.from_scenarios(net, [], alpha=0.5)
    with pytest.raises(ValueError, match="alpha"):
        T_cm.DegradedTail.from_scenarios(net, [TS.NetworkScenario()],
                                         alpha=1.0)
