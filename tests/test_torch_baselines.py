"""The paper's comparison schemes in the port, against the reference.

The same numpy-seeded instances go through ``repro`` (numpy) and
``repro_torch`` on the CPU; every float64 result must be equal (``==``):
restricted Algorithm 1 (RC+OP's fixed cuts, RP+OC's fixed placement, both
solvers), ``Planner.solve_many`` (the stacked b-sweep), ``exhaustive_joint``
(Fig. 7's optimum), ``rc_op`` / ``rp_oc`` (whose random draws come from a
``numpy.random.Generator`` seeded and called as the reference calls it),
``optimal``, ``sim_refined``, ``evaluate_under_fluctuation`` (Fig. 6, iid
and trace modes) and the per-solve cost-model memo.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import baselines as R_baselines
from conftest import same_msp_result

import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import baselines as T_baselines
from repro_torch.core import shortest_path as T_sp

SEEDS = [0, 3, 11]


def _instances(seed, mem_scale=1.0, num_layers=5):
    """The reference's randomized-restriction instance (tests/test_msp.py):
    ``random_profile(rng, 5)``, 3 servers, server memory scaled by
    ``mem_scale`` (1e-9: no server holds a segment) and a roomy client."""
    kw = dict(num_servers=3, num_clients=2, seed=seed,
              mem_range=(mem_scale * 2 * 2**30, mem_scale * 16 * 2**30),
              client_mem=4 * 2**30)
    return ((R.random_profile(np.random.default_rng(seed), num_layers),
             R.make_edge_network(**kw)),
            (T.random_profile(np.random.default_rng(seed), num_layers),
             T.make_edge_network(**kw)))


def _quickstart():
    return ((R.vgg16_profile(work_units="bytes"),
             R.make_edge_network(6, 4, seed=1, kappa=1 / 32.0)),
            (T.vgg16_profile(work_units="bytes"),
             T.make_edge_network(6, 4, seed=1, kappa=1 / 32.0)))


def _as_ref(res):
    sol = R.SplitSolution(res.solution.cuts, res.solution.placement)
    return dataclasses.replace(res, solution=sol)


def _same(r, p):
    """The reference's ``same_msp_result`` plus the sweep count and the
    true Eq. (13)/(14) numbers."""
    return (same_msp_result(r, _as_ref(p))
            and r.thresholds_scanned == p.thresholds_scanned
            and (r.L_t, r.T_i_true) == (p.L_t, p.T_i_true)
            if r.feasible else not p.feasible)


def _plan_fields(plan):
    return (plan.solution.cuts, plan.solution.placement, plan.b, plan.T_f,
            plan.T_i, plan.L_t, plan.objective, plan.feasible)


def _restriction(kind, seed):
    """The reference test's draws: two sorted inner cuts, or the client and
    two permuted servers; and a placement that revisits server 1."""
    rng = np.random.default_rng(seed)
    if kind == "cuts":
        cuts = tuple(int(c) for c in
                     sorted(rng.choice(np.arange(1, 5), 2, replace=False)))
        return {"restrict_cuts": cuts + (5,)}, 3
    if kind == "placement":
        return {"restrict_placement": (0,) + tuple(
            int(x) for x in rng.permutation([1, 2, 3])[:2])}, 3
    if kind == "revisit":
        return {"restrict_placement": (0, 1, 2, 1)}, 4
    return {"restrict_cuts": (1, 2, 4, 5)}, 4          # "four cuts"


@pytest.mark.parametrize("mem_scale", [1.0, 1e-9])
@pytest.mark.parametrize("kind", ["cuts", "placement", "revisit",
                                  "four cuts"])
@pytest.mark.parametrize("solver", ["batched", "scan"])
@pytest.mark.parametrize("seed", SEEDS)
def test_restricted_solve_matches_reference(seed, solver, kind, mem_scale):
    (rp, rn), (tp, tn) = _instances(seed, mem_scale)
    kw, K = _restriction(kind, seed)
    pl = T.Planner(tp, tn, device="cpu")
    for b in (1, 4, 16, 32):
        r = R.solve_msp(rp, rn, b, 32, K=K, solver=solver, **kw)
        p = T.solve_msp(tp, tn, b, 32, K=K, solver=solver, planner=pl, **kw)
        assert _same(r, p), (b, r, p)
        if p.feasible and "restrict_cuts" in kw:
            assert p.solution.cuts == kw["restrict_cuts"]
        if p.feasible and "restrict_placement" in kw:     # a prefix of it
            fixed = kw["restrict_placement"]
            assert p.solution.placement == fixed[:len(p.solution.placement)]
    if mem_scale == 1e-9 and "restrict_cuts" in kw:  # no client-only path
        assert not p.feasible


def test_restricted_sweeps_stay_off_k1(monkeypatch):
    """A restricted DP's parent-free sweeps run the masked plain sweep,
    chosen by the restriction alone and counted; K1 is never called."""
    (_, _), (tp, tn) = _instances(3)

    def no_k1(*args, **kw):
        raise AssertionError("a restricted solve called K1")

    pl = T.Planner(tp, tn, device="cpu")
    with obs.enabled_scope() as reg:
        reg.reset()
        with monkeypatch.context() as m:
            m.setattr(T_sp, "sweep_minplus", no_k1)
            res = pl.solve(8, 32, K=3, restrict_cuts=(2, 4, 5))
        assert res.feasible
        # min_bottleneck and the window sweep: one masked sweep each
        assert obs.counter("planner.masked_sweeps") == 2
        calls, real = [], T_sp.sweep_minplus
        monkeypatch.setattr(T_sp, "sweep_minplus",
                            lambda *a, **kw: calls.append(kw) or real(*a,
                                                                      **kw))
        pl.solve(8, 32, K=3)                      # unrestricted: K1
        assert [kw.get("mode", "sum") for kw in calls] == ["max", "sum"]
        assert obs.counter("planner.masked_sweeps") == 2
    obs.reset()


@pytest.mark.parametrize("mem_scale", [1.0, 1e-9])
@pytest.mark.parametrize("seed", SEEDS)
def test_solve_many_matches_reference_and_per_b_solve(seed, mem_scale,
                                                      monkeypatch):
    """Every b of the stacked sweep (b >= B included: no pipelining) equals
    the reference's ``solve_many`` and the port's own per-b ``solve``, and
    its parent-free phases are one K1 call each (phases B and C)."""
    (rp, rn), (tp, tn) = _instances(seed, mem_scale)
    B = 32
    bs = list(range(1, B + 1, 3)) + [B, 40]
    calls = []
    real = T_sp.sweep_minplus

    def record(*args, **kw):
        calls.append((args[7].numel(), kw.get("mode", "sum"),
                      kw.get("graph")))
        return real(*args, **kw)

    monkeypatch.setattr(T_sp, "sweep_minplus", record)
    pl = T.Planner(tp, tn, device="cpu")
    with obs.enabled_scope() as reg:
        reg.reset()
        many = pl.solve_many(bs, B)
        assert [s.name for s in obs.wall_spans()] == ["planner.solve_many"]
        assert obs.counter("planner.dp_sweeps") == \
            sum(m.thresholds_scanned for m in many)
    obs.reset()
    k1 = list(calls)                    # the per-b solves below add more
    want = R.Planner(rp, rn).solve_many(bs, B)
    assert len(many) == len(want) == len(bs)
    for b, r, p in zip(bs, want, many):
        assert _same(r, p), (b, r, p)
        assert _same(r, pl.solve(b, B, solver="batched")), b
    if any(m.feasible and m.thresholds_scanned > 1 for m in many):
        assert [mode for _, mode, _ in k1] == ["max", "sum"]
        live = k1[0][2]
        assert k1[0][0] == len(live)           # one threshold per live b
        assert sorted(set(k1[1][2])) == sorted(live)
    else:
        assert k1 == []


@pytest.mark.parametrize("solver", ["batched", "scan"])
@pytest.mark.parametrize("B,b_step", [(48, 1), (64, 1), (48, 5)])
@pytest.mark.parametrize("seed", [0, 4])
def test_exhaustive_joint_matches_reference(seed, B, b_step, solver):
    (rp, rn), (tp, tn) = _instances(seed)
    r = R.exhaustive_joint(rp, rn, B, b_step=b_step, solver=solver)
    p = T.exhaustive_joint(tp, tn, B, b_step=b_step, solver=solver,
                           device="cpu")
    assert _plan_fields(p) == _plan_fields(r)
    assert p.cost_model == r.cost_model == "closed_form"
    o = T.optimal(tp, tn, B, b_step=b_step, solver=solver, device="cpu")
    assert _plan_fields(o) == _plan_fields(r)


def test_exhaustive_joint_infeasible_matches_reference():
    (rp, rn), (tp, tn) = _instances(2, mem_scale=1e-9)
    # a client too small for the whole model: nothing is feasible
    rn = dataclasses.replace(rn, nodes=[dataclasses.replace(
        rn.nodes[0], mem=1.0)] + rn.nodes[1:])
    tn = dataclasses.replace(tn, nodes=[dataclasses.replace(
        tn.nodes[0], mem=1.0)] + tn.nodes[1:])
    r = R.exhaustive_joint(rp, rn, 32)
    p = T.exhaustive_joint(tp, tn, 32, device="cpu")
    assert not r.feasible and not p.feasible
    assert (p.b, p.L_t, p.solution.cuts) == (r.b, r.L_t, r.solution.cuts)


@pytest.mark.parametrize("I,K", [(5, 3), (16, 7), (30, 5), (2, 2), (6, 1)])
def test_random_cuts_draw_the_reference_cuts(I, K):
    rr, tr = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(20):
        assert T_baselines.random_cuts(tr, I, K) == \
            R_baselines.random_cuts(rr, I, K)
    assert tr.random() == rr.random()          # the same number of draws


@pytest.mark.parametrize("scheme", ["rc_op", "rp_oc"])
@pytest.mark.parametrize("draw_seed", [0, 7])
@pytest.mark.parametrize("seed", SEEDS)
def test_random_baselines_match_reference(seed, draw_seed, scheme):
    (rp, rn), (tp, tn) = _instances(seed)
    r = getattr(R, scheme)(rp, rn, 48, seed=draw_seed, b0=8)
    p = getattr(T, scheme)(tp, tn, 48, seed=draw_seed, b0=8, device="cpu")
    assert _plan_fields(p) == _plan_fields(r)


def test_schemes_and_baselines_on_the_quickstart_instance():
    """rc_op / rp_oc(seed=7) on VGG-16 over 6 servers + 4 clients equal the
    reference, and ``ours`` is no worse than either (the reference's
    ``test_ours_beats_random_baselines``); ``SCHEMES`` is the reference's,
    ``sim_refined`` included."""
    (rp, rn), (tp, tn) = _quickstart()
    assert list(T.SCHEMES) == list(R.SCHEMES)
    ours = T.SCHEMES["ours"](tp, tn, B=512, b0=20, device="cpu")
    for scheme in ("rc_op", "rp_oc"):
        r = getattr(R, scheme)(rp, rn, B=512, seed=7)
        p = T.SCHEMES[scheme](tp, tn, B=512, seed=7, device="cpu")
        assert _plan_fields(p) == _plan_fields(r)
        assert ours.L_t <= p.L_t * (1 + 1e-9)
    r = R.SCHEMES["sim_refined"](rp, rn, B=512)
    p = T.SCHEMES["sim_refined"](tp, tn, B=512, device="cpu")
    assert _plan_fields(p) == _plan_fields(r)
    assert (p.solution, p.b) == (ours.solution, ours.b)


@pytest.mark.parametrize("cv", [0.0, 0.1, 0.3])
@pytest.mark.parametrize("seed", [0, 5])
def test_fluctuation_iid_matches_reference(seed, cv):
    (rp, rn), (tp, tn) = _instances(seed)
    r_plan = R.ours(rp, rn, 48, b0=8)
    p_plan = T.ours(tp, tn, 48, b0=8, device="cpu")
    assert _plan_fields(p_plan) == _plan_fields(r_plan)
    want = R.evaluate_under_fluctuation(rp, rn, r_plan, cv, draws=16,
                                        seed=seed)
    got = T.evaluate_under_fluctuation(tp, tn, p_plan, cv, draws=16,
                                       seed=seed)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()
    noisy_r = rn.with_fluctuation(np.random.default_rng(seed), cv)
    noisy_t = tn.with_fluctuation(np.random.default_rng(seed), cv)
    assert np.array_equal(noisy_t.rate, noisy_r.rate)
    assert [n.f for n in noisy_t.nodes] == [n.f for n in noisy_r.nodes]


def test_fluctuation_trace_mode_waits_for_the_simulator():
    """Trace mode runs the plan in the simulator under sampled traces and
    equals the reference (both trace models); an unknown mode still
    raises."""
    (rp, rn), (tp, tn) = _instances(0)
    r_plan = R.ours(rp, rn, 48, b0=8)
    plan = T.ours(tp, tn, 48, b0=8, device="cpu")
    for trace_model in ("piecewise", "gauss_markov"):
        want = R.evaluate_under_fluctuation(rp, rn, r_plan, 0.2, draws=8,
                                            mode="trace",
                                            trace_model=trace_model)
        got = T.evaluate_under_fluctuation(tp, tn, plan, 0.2, draws=8,
                                           mode="trace",
                                           trace_model=trace_model,
                                           device="cpu")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError, match="unknown mode"):
        T.evaluate_under_fluctuation(tp, tn, plan, 0.2, mode="nope")


class _Counting(T.CostModel):
    """A cost model that counts its calls (ClosedForm's numbers)."""
    name = "counting"

    def __init__(self):
        self.inner, self.calls = T.ClosedForm(), 0

    def evaluate(self, profile, net, sol, b, B):
        self.calls += 1
        return self.inner.evaluate(profile, net, sol, b, B)

    def memory_feasible(self, profile, net, sol, b):
        self.calls += 1
        return self.inner.memory_feasible(profile, net, sol, b)


def test_memoized_cost_model_equals_its_inner_model():
    (rp, rn), (tp, tn) = _instances(1)
    cf = T.ClosedForm()
    assert T.memoized_cost_model(cf) is cf
    inner = _Counting()
    memo = T.memoized_cost_model(inner)
    assert T.memoized_cost_model(memo) is memo and memo.name == "counting"
    sols = [T.SplitSolution((2, 5), (0, 1)), T.SplitSolution((5,), (0,)),
            T.SplitSolution((1, 3, 5), (0, 2, 1))]
    rsols = [R.SplitSolution(s.cuts, s.placement) for s in sols]
    cands = [(s, b) for s in sols for b in (1, 4, 16)]
    want = [R.ClosedForm().evaluate(rp, rn, R.SplitSolution(s.cuts,
                                                            s.placement),
                                    b, 32) for s, b in cands]
    assert memo.evaluate_many(tp, tn, cands, 32) == want
    calls = inner.calls
    assert [memo.evaluate(tp, tn, s, b, 32) for s, b in cands] == want
    assert memo.evaluate_many(tp, tn, cands, 32) == want
    assert inner.calls == calls                  # every key was cached
    for s, rs in zip(sols, rsols):
        got = memo.memory_feasible_many(tp, tn, s, [1, 8, 64])
        assert got == [R.ClosedForm().memory_feasible(rp, rn, rs, b)
                       for b in (1, 8, 64)]
        assert [memo.memory_feasible(tp, tn, s, b) for b in (1, 8, 64)] \
            == got
    assert inner.calls == calls + 9


def test_new_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, _), (tp, tn) = _instances(0)
    for call in (lambda: T.rc_op(tp, tn, 16),
                 lambda: T.rp_oc(tp, tn, 16),
                 lambda: T.optimal(tp, tn, 16),
                 lambda: T.exhaustive_joint(tp, tn, 16),
                 lambda: T.exhaustive_joint(tp, tn, 16, solver="scan")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert math.isfinite(T.optimal(tp, tn, 16, device="cpu").L_t)
