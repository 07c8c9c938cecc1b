"""The port's planner against the reference: bit for bit.

The same numpy-seeded instances go through ``repro`` (numpy) and
``repro_torch`` on the CPU; the graph tensors, the candidate thresholds,
the argmin parents, Algorithm 1 (batched and scan), Algorithm 2's
``ours``/``no_pipeline`` and the Eq. (14) event simulation must all agree
exactly (``==``, no tolerance): every operation is an exactly rounded
float64 op in the same order, and every argmin takes the first minimum.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.latency as R_latency
from repro.core import shortest_path as R_sp
from repro.pipeline import simulate_from_breakdown as r_simulate
from conftest import same_msp_result

import repro_torch.core as T
from repro_torch.core import shortest_path as T_sp
from repro_torch.pipeline import memory_highwater, simulate_from_breakdown

B = 64


def _instances(seed, num_layers=6, num_servers=3, num_clients=2):
    """The conftest ``small_instance`` built in both packages."""
    ref = (R.random_profile(np.random.default_rng(seed), num_layers),
           R.make_edge_network(num_servers=num_servers,
                               num_clients=num_clients, seed=seed))
    port = (T.random_profile(np.random.default_rng(seed), num_layers),
            T.make_edge_network(num_servers=num_servers,
                                num_clients=num_clients, seed=seed))
    return ref, port


def _as_ref(res):
    """A port MSPResult with the reference's SplitSolution type, so the
    reference's own ``same_msp_result`` contract applies."""
    sol = R.SplitSolution(res.solution.cuts, res.solution.placement)
    return dataclasses.replace(res, solution=sol)


def _quickstart():
    ref = (R.vgg16_profile(work_units="bytes"),
           R.make_edge_network(6, 4, seed=1, kappa=1 / 32.0))
    port = (T.vgg16_profile(work_units="bytes"),
            T.make_edge_network(6, 4, seed=1, kappa=1 / 32.0))
    return ref, port


@pytest.mark.parametrize("memory_model", ["paper", "refined"])
@pytest.mark.parametrize("b", [1, 7, 40])
def test_graph_tensors_equal_reference(memory_model, b):
    (rp, rn), (tp, tn) = _instances(4, num_layers=8, num_servers=4)
    want = R.GraphFactory(rp, rn, memory_model).graph(b)
    got = T.GraphFactory(tp, tn, memory_model, device="cpu").graph(b)
    for name in ("seg_cost", "seg_beta", "comm_cost", "comm_beta",
                 "src_cost", "src_beta"):
        assert np.array_equal(getattr(got, name).numpy(),
                              getattr(want, name)), name


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("solver", ["batched", "scan"])
def test_planner_solve_matches_reference(seed, solver):
    (rp, rn), (tp, tn) = _instances(seed)
    ref_pl, port_pl = R.Planner(rp, rn), T.Planner(tp, tn, device="cpu")
    for b in (1, 3, 8, 24, B):
        r = ref_pl.solve(b, B, solver=solver)
        p = port_pl.solve(b, B, solver=solver)
        assert same_msp_result(r, _as_ref(p)), (seed, solver, b)
        assert r.thresholds_scanned == p.thresholds_scanned


def test_solve_msp_and_brute_force_match_reference():
    (rp, rn), (tp, tn) = _instances(6, num_layers=5)
    for b in (2, 16):
        r = R.solve_msp(rp, rn, b, 32)
        p = T.solve_msp(tp, tn, b, 32, device="cpu")
        assert same_msp_result(r, _as_ref(p))
        for objective in ("paper", "true"):
            rv, rs = R.brute_force_msp(rp, rn, b, 32, 3, objective=objective)
            pv, ps = T.brute_force_msp(tp, tn, b, 32, 3, objective=objective,
                                       device="cpu")
            assert rv == pv
            assert (rs.cuts, rs.placement) == (ps.cuts, ps.placement)


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_betas_window_is_exact(seed):
    (rp, rn), (tp, tn) = _instances(seed)
    rdp = R_sp._LayeredDP(R.build_graph(rp, rn, 8), 4)
    tdp = T_sp._LayeredDP(T.build_graph(tp, tn, 8, device="cpu"), 4)
    all_r = rdp.all_betas()
    assert np.array_equal(tdp.all_betas().numpy(), all_r)
    for lo, hi in [(all_r[3], all_r[-4]), (all_r[0], all_r[0]),
                   (all_r[-1] + 1.0, math.inf), (-math.inf, all_r[5])]:
        assert np.array_equal(tdp.betas_window(lo, hi).numpy(),
                              rdp.betas_window(lo, hi))


@pytest.mark.parametrize("seed", [0, 2])
def test_argmin_parents_break_ties_like_numpy(seed):
    """Parents of the parent-tracking sweep equal numpy's first-minimum
    argmin, including all-inf columns (index 0) below beta* and the many
    exact ties of a uniform profile."""
    for which in ("random", "uniform"):
        if which == "random":
            (rp, rn), (tp, tn) = _instances(seed)
        else:
            rn = R.make_edge_network(3, 2, seed=seed)
            tn = T.make_edge_network(3, 2, seed=seed)
            rp, tp = R.uniform_profile(6), T.uniform_profile(6)
        rdp = R_sp._LayeredDP(R.build_graph(rp, rn, 4), 4)
        tdp = T_sp._LayeredDP(T.build_graph(tp, tn, 4, device="cpu"), 4)
        betas = rdp.all_betas()
        ts = np.concatenate([betas[:3] * 0.5, betas[::4], [math.inf]])
        want = R_sp._sweep(rdp._Ccom, rdp._Bcom, rdp._Sseg, rdp._Bseg,
                           rdp._src_cost, rdp._src_beta, 4, ts,
                           want_parents=True)
        got = tdp.sweep(ts)
        assert np.array_equal(got.best_val, want.best_val)
        assert np.array_equal(got.best_k, want.best_k)
        assert np.array_equal(got.best_m, want.best_m)
        assert len(got.parents) == len(want.parents)
        for (ga, gs), (wa, ws) in zip(got.parents, want.parents):
            assert np.array_equal(ga, wa) and np.array_equal(gs, ws)
    # all-inf reductions give index 0, as numpy's argmin does
    col = torch.full((4, 3), math.inf, dtype=torch.float64)
    assert torch.min(col, dim=0).indices.tolist() == [0, 0, 0]


def test_ours_and_no_pipeline_on_quickstart_instance():
    (rp, rn), (tp, tn) = _quickstart()
    r = R.ours(rp, rn, B=512, b0=20)
    p = T.ours(tp, tn, B=512, b0=20, device="cpu")
    assert (p.solution.cuts, p.solution.placement) == (r.solution.cuts,
                                                       r.solution.placement)
    assert (p.b, p.T_f, p.T_i, p.L_t, p.objective, p.iterations) == \
        (r.b, r.T_f, r.T_i, r.L_t, r.objective, r.iterations)
    rn_plan = R.no_pipeline(rp, rn, B=512)
    pn_plan = T.no_pipeline(tp, tn, B=512, device="cpu")
    assert (pn_plan.solution.cuts, pn_plan.solution.placement,
            pn_plan.b, pn_plan.L_t) == (rn_plan.solution.cuts,
                                        rn_plan.solution.placement,
                                        rn_plan.b, rn_plan.L_t)

    # Eq. (14) against the event simulation, on the planned solution
    q = T.num_fills(512, p.b) + 1
    got = simulate_from_breakdown(T.breakdown(tp, tn, p.solution, p.b), q)
    want = r_simulate(R.breakdown(rp, rn, r.solution, r.b), q)
    assert (got.makespan, got.analytic) == (want.makespan, want.analytic)
    assert got.memory_factor == want.memory_factor
    assert memory_highwater(3, 12, "1f1b") == {0: 3, 1: 2, 2: 1}


@pytest.mark.parametrize("seed", [1, 5])
def test_bcd_and_microbatch_match_reference(seed):
    (rp, rn), (tp, tn) = _instances(seed, num_layers=7, num_servers=4)
    for refine_b in (True, False):
        r = R.bcd_solve(rp, rn, 48, b0=6, refine_b=refine_b)
        p = T.bcd_solve(tp, tn, 48, b0=6, refine_b=refine_b, device="cpu")
        assert (p.solution.cuts, p.solution.placement, p.b, p.L_t,
                p.history) == (r.solution.cuts, r.solution.placement, r.b,
                               r.L_t, r.history)
    rsol = r.solution
    psol = T.path_to_solution(list(zip(rsol.placement, rsol.cuts)))
    assert (psol.cuts, psol.placement) == (rsol.cuts, rsol.placement)
    for model in ("paper", "refined"):
        assert T.max_feasible_microbatch(tp, tn, psol, 4096, model) == \
            R_latency.max_feasible_microbatch(rp, rn, rsol, 4096, model)
        assert T.memory_split(tp, tn, 0, rsol.cuts[0], 0, 8, model) == \
            R_latency.memory_split(rp, rn, 0, rsol.cuts[0], 0, 8, model)
    T_1 = R.pipeline_interval(rp, rn, rsol, 4)
    rm = R.optimal_microbatch(rp, rn, rsol, 48, T_1)
    pm = T.optimal_microbatch(tp, tn, psol, 48, T_1)
    assert (pm.b, pm.objective, pm.case, pm.b_v) == (rm.b, rm.objective,
                                                     rm.case, rm.b_v)
    assert T.exhaustive_microbatch(tp, tn, psol, 48) == \
        R.exhaustive_microbatch(rp, rn, rsol, 48)


def test_planner_memoizes_and_counts_sweeps():
    from repro_torch import obs
    (_, _), (tp, tn) = _instances(3)
    pl = T.Planner(tp, tn, device="cpu")
    with obs.enabled_scope() as reg:
        reg.reset()
        first = pl.solve(8, B)
        assert pl.solve(8, B) is first
        assert obs.counter("planner.solve_memo_hit") == 1
        assert obs.counter("planner.dp_sweeps") == first.thresholds_scanned
        assert [s.name for s in obs.wall_spans()] == ["planner.solve"]
    obs.reset()
