"""Planning scored by the simulator, in the port against the reference.

The same numpy-seeded instances go through ``repro`` and ``repro_torch``
(``device="cpu"``): random instances of the reference's ``random_instance``
(seeds 3, 5, 9, 12), the parity grid's fixed seeds ``101 * s + 13`` and the
quickstart (VGG-16, 6 servers + 4 clients, B = 512).  Every result is equal
(``==``): ``SimMakespan.evaluate`` / ``evaluate_many`` (and
``evaluate_many`` equals looped ``evaluate``), ``bcd_solve`` and
``exhaustive_joint`` under ``SimMakespan`` (cuts, placement, b, the
closed-form numbers, objective, history, iterations), ``sim_refined``,
``SCHEMES``, and the trace-mode fluctuation report for both trace models.
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
from repro_torch.sim.policies import MemoryBudgeted

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



def _plan_fields(plan):
    return (plan.solution.cuts, plan.solution.placement, plan.b, plan.B,
            plan.T_f, plan.T_i, plan.L_t, plan.objective, plan.iterations,
            plan.history, plan.feasible, plan.cost_model)


def _random_instances(seed):
    return RS.random_instance(seed), TS.random_instance(seed)


@pytest.fixture(scope="module")
def quickstart():
    return ((R.vgg16_profile(work_units="bytes"),
             R.make_edge_network(6, 4, seed=1, kappa=1 / 32.0)),
            (T.vgg16_profile(work_units="bytes"),
             T.make_edge_network(6, 4, seed=1, kappa=1 / 32.0)))


def _grid_cands(RC, S, seed):
    """The parity grid's instance and a few (sol, b) candidates on it:
    chain and reentrant placements at several b."""
    rng = np.random.default_rng(seed)
    prof = RC.random_profile(rng, int(rng.integers(5, 11)))
    net = RC.make_edge_network(num_servers=int(rng.integers(2, 5)),
                               num_clients=int(rng.integers(1, 4)), seed=seed)
    sols = [S.random_chain_solution(rng, prof, net)]
    try:
        sols.append(S.random_reentrant_solution(rng, prof, net))
    except ValueError:
        pass
    return prof, net, [(s, b) for s in sols for b in (1, 2, 3, 5, 8)]


@pytest.mark.parametrize("policy", ["memory", "fifo", "1f1b"])
@pytest.mark.parametrize("seed", GRID_SEEDS)
def test_sim_makespan_scores_equal_the_reference(seed, policy):
    rp, rn, rc = _grid_cands(R, RS, seed)
    tp, tn, tc = _grid_cands(T, TS, seed)
    assert [(s.cuts, s.placement, b) for s, b in rc] == \
        [(s.cuts, s.placement, b) for s, b in tc]
    rm = R.SimMakespan(policy=policy)
    tm = T.SimMakespan(policy=policy, device=CPU)
    want = rm.evaluate_many(rp, rn, rc, 48)
    got = tm.evaluate_many(tp, tn, tc, 48)
    assert got == want
    assert got == [tm.evaluate(tp, tn, s, b, 48) for s, b in tc]
    for s, _ in tc[:1]:
        bs = list(range(1, 49))
        assert tm.memory_feasible_many(tp, tn, s, bs) == \
            rm.memory_feasible_many(rp, rn, R.SplitSolution(s.cuts,
                                                           s.placement), bs)


def test_sim_makespan_policy_plumbing():
    """A "memory" name builds MemoryBudgeted with the model's memory model
    and tail; a pre-built one donates its own (the reference's rule)."""
    tail = T.DegradedTail(mem=(None, 1e9))
    m = T.SimMakespan(memory_model="paper", tail=tail, device=CPU)
    assert isinstance(m.policy, MemoryBudgeted)
    assert (m.policy.memory_model, m.policy.tail) == ("paper", tail)
    d = T.SimMakespan(policy=MemoryBudgeted("paper", tail=tail), device=CPU)
    assert (d.memory_model, d.tail) == ("paper", tail)
    assert repr(d) == repr(R.SimMakespan(
        policy=RS.MemoryBudgeted("paper", tail=R.DegradedTail(
            mem=(None, 1e9)))))
    assert T.SimMakespan(policy="fifo", device=CPU).name == "sim_makespan"


@pytest.mark.parametrize("policy", ["memory", "fifo"])
@pytest.mark.parametrize("seed", INSTANCE_SEEDS)
def test_bcd_under_sim_makespan_equals_reference(seed, policy):
    (rp, rn, _, _, B), (tp, tn, _, _, _) = _random_instances(seed)
    r = R.bcd_solve(rp, rn, B, cost_model=R.SimMakespan(policy=policy))
    p = T.bcd_solve(tp, tn, B, cost_model=T.SimMakespan(policy=policy,
                                                        device=CPU),
                    device=CPU)
    assert _plan_fields(p) == _plan_fields(r)
    assert p.cost_model == "sim_makespan"


@pytest.mark.parametrize("seed", INSTANCE_SEEDS[:2])
def test_exhaustive_joint_under_sim_makespan_equals_reference(seed):
    (rp, rn, _, _, B), (tp, tn, _, _, _) = _random_instances(seed)
    r = R.exhaustive_joint(rp, rn, B, cost_model=R.SimMakespan())
    p = T.exhaustive_joint(tp, tn, B, cost_model=T.SimMakespan(device=CPU),
                           device=CPU)
    assert _plan_fields(p) == _plan_fields(r)


def test_sim_refined_on_the_quickstart(quickstart):
    """The reference's values: the plan of ``ours`` (cuts (1, 16),
    placement (0, 6), b = 4) with L_t 0.52786 s."""
    (rp, rn), (tp, tn) = quickstart
    r = R.sim_refined(rp, rn, 512)
    p = T.sim_refined(tp, tn, 512, device=CPU)
    assert _plan_fields(p) == _plan_fields(r)
    assert (p.solution.cuts, p.solution.placement, p.b) == \
        ((1, 16), (0, 6), 4)
    ours = T.ours(tp, tn, 512, device=CPU)
    assert (ours.solution, ours.b) == (p.solution, p.b)
    cm = T.SimMakespan(device=CPU)
    bs = [b for b, ok in zip(range(1, 513), cm.memory_feasible_many(
        tp, tn, p.solution, range(1, 513))) if ok]
    cands = [(p.solution, b) for b in bs]
    got = cm.evaluate_many(tp, tn, cands, 512)
    assert got == R.SimMakespan().evaluate_many(
        rp, rn, [(R.SplitSolution(s.cuts, s.placement), b)
                 for s, b in cands], 512)
    assert got == [cm.evaluate(tp, tn, s, b, 512) for s, b in cands]


@pytest.mark.parametrize("seed", INSTANCE_SEEDS)
def test_sim_refined_with_restarts_equals_reference(seed):
    (rp, rn, _, _, B), (tp, tn, _, _, _) = _random_instances(seed)
    r = R.sim_refined(rp, rn, B, restarts=True, b0=8)
    p = T.sim_refined(tp, tn, B, restarts=True, b0=8, device=CPU)
    assert _plan_fields(p) == _plan_fields(r)


def test_schemes_are_the_references():
    assert list(T.SCHEMES) == list(R.SCHEMES)


@pytest.mark.parametrize("trace_model", ["piecewise", "gauss_markov"])
@pytest.mark.parametrize("cv", [0.0, 0.2])
def test_fluctuation_trace_mode_equals_reference(quickstart, cv,
                                                 trace_model):
    (rp, rn), (tp, tn) = quickstart
    r_plan = R.ours(rp, rn, 512)
    p_plan = T.ours(tp, tn, 512, device=CPU)
    want = R.evaluate_under_fluctuation(rp, rn, r_plan, cv, draws=8,
                                        seed=3, mode="trace",
                                        trace_model=trace_model)
    got = T.evaluate_under_fluctuation(tp, tn, p_plan, cv, draws=8, seed=3,
                                       mode="trace", trace_model=trace_model,
                                       device=CPU)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_fluctuation_trace_mode_argument_errors(quickstart):
    _, (tp, tn) = quickstart
    plan = T.ours(tp, tn, 64, device=CPU)
    with pytest.raises(ValueError, match="unknown trace_model"):
        T.evaluate_under_fluctuation(tp, tn, plan, 0.2, draws=1,
                                     mode="trace", trace_model="nope",
                                     device=CPU)
    with pytest.raises(ValueError, match="positive"):
        T.evaluate_under_fluctuation(tp, tn, plan, 0.2, mode="trace",
                                     dt=-1.0, device=CPU)
    assert math.isfinite(T.evaluate_under_fluctuation(
        tp, tn, plan, 0.2, draws=2, mode="trace", device=CPU).mean_latency)
