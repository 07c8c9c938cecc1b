"""The port's elastic coordinator against the reference's.

The event cases of ``tests/test_ft.py`` and of
``tests/test_planner_update.py``'s coordinator section, run on both
coordinators (``repro.ft`` and ``repro_torch.ft`` with ``device="cpu"``)
from the same numpy-seeded instance: after every event the plans are equal
(``==`` on the solution, b, L_t and the objective), and so are the
outcome's action and the mutated network.  Also the port's own rules:
``preview_cached`` memoisation and invalidation, the ride-out remap across
a failure, and a named replan policy routed through ``deliver``.
"""

import math

import numpy as np
import pytest

import repro.core as R
import repro.ft as R_ft

import repro_torch.core as T
import repro_torch.ft as T_ft
from repro_torch import obs

B = 128


def _instance(seed=5, num_layers=6, num_servers=4, num_clients=2):
    ref = (R.random_profile(np.random.default_rng(seed), num_layers),
           R.make_edge_network(num_servers=num_servers,
                               num_clients=num_clients, seed=seed))
    port = (T.random_profile(np.random.default_rng(seed), num_layers),
            T.make_edge_network(num_servers=num_servers,
                                num_clients=num_clients, seed=seed))
    return ref, port


def _coords(seed=5, **kw):
    (rp, rn), (tp, tn) = _instance(seed)
    ref = R_ft.Coordinator(rp, rn, B=B, **kw)
    port = T_ft.Coordinator(tp, tn, B=B, device="cpu", **kw)
    assert _same_plan(ref.plan, port.plan)
    return ref, port


def _plan_key(plan):
    return (plan.solution.cuts, plan.solution.placement, plan.b, plan.L_t,
            plan.objective, plan.feasible)


def _same_plan(a, b):
    return _plan_key(a) == _plan_key(b)


def _same_net(rnet, tnet):
    return (np.array_equal(rnet.rate, tnet.rate)
            and [n.f for n in rnet.nodes] == [n.f for n in tnet.nodes])


def _event(kind, *args):
    """The same event in both packages."""
    return getattr(R_ft, kind)(*args), getattr(T_ft, kind)(*args)


def _apply_both(ref, port, kind, *args, absorb=False):
    re, te = _event(kind, *args)
    ro = ref.absorb(re) if absorb else ref.apply(re)
    to = port.absorb(te) if absorb else port.apply(te)
    assert _same_plan(ref.plan, port.plan), (kind, args, ref.plan, port.plan)
    assert _same_net(ref.net, port.net)
    assert (ro.action, ro.remapped_stages, ro.ride_out_latency,
            ro.old_latency, ro.restore_seconds) == \
        (to.action, to.remapped_stages, to.ride_out_latency,
         to.old_latency, to.restore_seconds)
    assert port.net is port.planner.net
    return ro, to


# -- the event cases of tests/test_ft.py --------------------------------------


def test_node_failure_replans_feasible():
    ref, port = _coords()
    failed = port.plan.solution.placement[-1]
    _, out = _apply_both(ref, port, "NodeFailure", failed)
    assert out.action == "replan" and port.plan.feasible
    assert all(p < len(port.net.nodes) for p in port.plan.solution.placement)
    assert len(port.net.nodes) == len(ref.net.nodes)


@pytest.mark.parametrize("slowdown", [1.01, 1.5, 50.0])
def test_straggler_on_the_last_stage(slowdown):
    ref, port = _coords()
    sol_before = port.plan.solution
    node = port.plan.solution.placement[-1]
    _, out = _apply_both(ref, port, "Straggler", node, slowdown)
    assert out.action in ("microbatch", "replan")
    if out.action == "microbatch":
        assert port.plan.solution == sol_before        # no weight movement
    assert math.isfinite(port.plan.L_t)
    assert port.plan.L_t == T.total_latency(
        port.profile, port.net, port.plan.solution, port.plan.b, B)


@pytest.mark.parametrize("factor", [0.05, 0.5, 2.0])
def test_rate_change_replans(factor):
    ref, port = _coords()
    _, out = _apply_both(ref, port, "RateChange", 1, 2, factor)
    assert out.action == "replan" and port.plan.feasible


def test_replan_latency_not_worse_than_fresh():
    ref, port = _coords()
    _apply_both(ref, port, "NodeFailure", 1)
    fresh = T.bcd_solve(port.profile, port.net, B, device="cpu")
    assert port.plan.L_t <= fresh.L_t * 1.05 + 1e-9


def test_event_sequence_and_log():
    ref, port = _coords()
    _apply_both(ref, port, "Straggler", 1, 2.0)
    _apply_both(ref, port, "RateChange", 1, 2, 0.5)
    _apply_both(ref, port, "NodeFailure", 2)
    _apply_both(ref, port, "RateChange", 0, 1, 4.0)
    assert len(port.events) == len(ref.events) == 4
    assert [o.log_record()["action"] for o in port.events] == \
        [o.log_record()["action"] for o in ref.events]


def test_mild_straggler_skips_full_solve():
    ref, port = _coords()
    node = port.plan.solution.placement[-1]
    obs.reset()
    with obs.enabled_scope():
        _, out = _apply_both(ref, port, "Straggler", node, 1.01)
        assert out.action == "microbatch"
        assert obs.counter("ft.full_solve_saved") == 1
        assert obs.counter("ft.full_solves") == 0
        assert obs.counter("ft.replans") == 1
    obs.reset()


def test_severe_client_straggler_pays_full_solve():
    ref, port = _coords()
    node = port.plan.solution.placement[0]
    obs.reset()
    with obs.enabled_scope():
        _apply_both(ref, port, "Straggler", node, 50.0)
        assert obs.counter("ft.full_solves") == 1
    obs.reset()


class _BrokenModel:
    """Cost-model stub whose evaluate raises a chosen exception type."""
    name = "broken"

    def __init__(self, exc):
        self.exc = exc

    def evaluate(self, *a, **k):
        raise self.exc("boom")

    def memory_feasible(self, *a, **k):
        return True


def test_eval_errors_counted_and_programming_errors_raised():
    _, port = _coords()
    port.cost_model = _BrokenModel(ValueError)
    obs.reset()
    with obs.enabled_scope():
        assert port._current_latency() == math.inf
        assert port._evaluate_candidate(port.net, port.plan.solution,
                                        port.plan.b) == math.inf
        assert obs.counter("ft.eval_errors") == 2
    obs.reset()
    assert port.eval_errors == 2
    port.cost_model = _BrokenModel(RuntimeError)
    with pytest.raises(RuntimeError):
        port._current_latency()
    port.cost_model = _BrokenModel(TypeError)
    with pytest.raises(TypeError):
        port._evaluate_candidate(port.net, port.plan.solution, port.plan.b)


@pytest.mark.parametrize("seed", [0, 7, 23])
def test_remap_across_failure(seed):
    """The remapped placement names the same physical nodes on the
    degraded network, indices above the failed server shift down by one,
    and the closed-form ride-out objective is unchanged — as the
    reference's remap does it."""
    (_, _), (tp, tn) = _instance(seed, num_servers=5)
    sol = T.SplitSolution((1, 3, 6), (0, 2, 4))
    for server in range(1, len(tn.nodes)):
        remapped = T_ft.Coordinator._remap_across_failure(sol, server)
        want = R_ft.Coordinator._remap_across_failure(
            R.SplitSolution(sol.cuts, sol.placement), server)
        if server in sol.placement:
            assert remapped is None and want is None
            continue
        assert remapped.placement == want.placement
        degraded = tn.degraded([server])
        assert [degraded.nodes[p] for p in remapped.placement] == \
            [tn.nodes[p] for p in sol.placement]
        assert T.total_latency(tp, degraded, remapped, 4, 64) == \
            pytest.approx(T.total_latency(tp, tn, sol, 4, 64), rel=1e-12)


def test_absorbed_failure_keeps_plan_when_not_hosting():
    ref, port = _coords()
    spare = next(s for s in range(1, len(port.net.nodes))
                 if s not in port.plan.solution.placement)
    L_before = port.plan.objective
    _, out = _apply_both(ref, port, "NodeFailure", spare, absorb=True)
    assert out.action == "absorb" and out.restore_seconds == 0.0
    assert port.plan.objective == pytest.approx(L_before, rel=1e-12)


def test_absorbed_failure_escalates_when_hosting():
    ref, port = _coords(restore_cost=0.25)
    hosting = port.plan.solution.placement[-1]
    obs.reset()
    with obs.enabled_scope():
        _, out = _apply_both(ref, port, "NodeFailure", hosting, absorb=True)
        assert obs.counter("ft.absorb_escalated") == 1
    obs.reset()
    assert out.action == "replan" and out.restore_seconds == 0.25
    assert out.ride_out_latency == math.inf


def test_resync_solves_on_the_snapshot_and_keeps_the_net():
    ref, port = _coords()
    rsnap, _ = R_ft.Coordinator.preview(ref.net, None,
                                        R_ft.RateChange(1, 3, 0.3))
    tsnap, _ = T_ft.Coordinator.preview(port.net, None,
                                        T_ft.RateChange(1, 3, 0.3))
    net_before = port.net
    ro, to = ref.apply(R_ft.Resync(rsnap)), port.apply(T_ft.Resync(tsnap))
    assert _same_plan(ref.plan, port.plan)
    assert to.net_changed is False and port.net is net_before
    assert (ro.action, ro.ride_out_latency) == (to.action,
                                                to.ride_out_latency)
    assert port.absorb(T_ft.Resync(tsnap)).action == "absorb"


# -- the coordinator section of tests/test_planner_update.py ---------------


@pytest.mark.parametrize("kind,args", [("RateChange", (1, 2, 0.2)),
                                       ("Straggler", (1, 2.0)),
                                       ("NodeFailure", (1,))])
def test_apply_routes_through_planner_update(kind, args):
    """apply() mutates the network through the shared planner; the plan
    equals the reference's and a fresh coordinator's on the mutated
    network."""
    ref, port = _coords()
    obs.reset()
    with obs.enabled_scope():
        _, out = _apply_both(ref, port, kind, *args)
        if out.action == "replan" and kind != "NodeFailure":
            # the BCD solve after a patch starts from the surviving hints
            assert obs.counter("planner.incremental_hits") >= 1
    obs.reset()
    fresh = T_ft.Coordinator(port.profile, port.net, B=B, device="cpu")
    assert fresh.plan.feasible == port.plan.feasible
    if port.plan.feasible:
        assert port.plan.L_t == pytest.approx(fresh.plan.L_t, rel=1e-9)


def test_absorb_keeps_planner_in_sync():
    ref, port = _coords(6)
    node = port.plan.solution.placement[-1]
    _apply_both(ref, port, "Straggler", node, 1.2, absorb=True)
    _apply_both(ref, port, "RateChange", 1, 2, 0.5)
    assert port.plan.feasible


def test_preview_cached_memoizes_per_event():
    _, port = _coords(7)
    ev = T_ft.RateChange(n_from=1, n_to=2, factor=0.5)
    obs.reset()
    with obs.enabled_scope():
        net1, sol1, pl1 = port.preview_cached(port.plan.solution, ev)
        net2, sol2, pl2 = port.preview_cached(port.plan.solution, ev)
        assert obs.counter("ft.preview_planner_hit") >= 1
    obs.reset()
    assert net1 is net2 and pl1 is pl2
    assert sol1 == sol2 == port.plan.solution
    assert pl1.device == port.device
    # coordinator state untouched by previews
    assert port.net is port.planner.net and port.planner is not pl1
    rnet, _, _ = R_ft.Coordinator(*_instance(7)[0], B=B).preview_cached(
        R.SplitSolution(sol1.cuts, sol1.placement),
        R_ft.RateChange(n_from=1, n_to=2, factor=0.5))
    assert np.array_equal(rnet.rate, net1.rate)


def test_preview_cache_invalidated_by_mutation_and_bounded():
    _, port = _coords(8, preview_cache_size=2)
    ev = T_ft.Straggler(node=1, slowdown=2.0)
    _, _, pl1 = port.preview_cached(port.plan.solution, ev)
    port.apply(T_ft.RateChange(n_from=1, n_to=2, factor=0.5))
    _, _, pl2 = port.preview_cached(port.plan.solution, ev)
    assert pl1 is not pl2            # the old preview was for the old net
    for f in (1.1, 1.2, 1.3):
        port.preview_cached(port.plan.solution, T_ft.Straggler(2, f))
    assert len(port._preview_planners) <= 2
    failed_sol = port.preview_cached(port.plan.solution,
                                     T_ft.NodeFailure(server=1))[1]
    assert failed_sol == T_ft.Coordinator._remap_across_failure(
        port.plan.solution, 1)


def test_deliver_is_apply_and_named_policies_raise():
    """Without a policy ``deliver`` is ``apply``; a named policy resolves
    as the reference's and makes the reference's decisions; a bad name, a
    non-policy and a zero preview cache still raise."""
    ref, port = _coords()
    re, te = _event("RateChange", 1, 2, 0.5)
    ro, to = ref.deliver(re), port.deliver(te)
    assert _same_plan(ref.plan, port.plan) and ro.action == to.action
    assert to.decision is None and to.log_record()["reason"] is None
    for policy in ("hysteresis", "eager", "ride_out", "adaptive"):
        rc, tc = _coords(policy=policy)
        assert tc.policy.name == rc.policy.name
        for ev in (("RateChange", 1, 2, 0.9), ("RateChange", 1, 2, 0.5),
                   ("Straggler", 2, 3.0), ("NodeFailure", 3)):
            re, te = _event(*ev)
            ro = rc.deliver(re, sim_time=1.0)
            to = tc.deliver(te, sim_time=1.0)
            assert (to.decision.replan, to.decision.reason, to.action) == \
                (ro.decision.replan, ro.decision.reason, ro.action)
            assert _same_plan(rc.plan, tc.plan)
    (_, _), (tp, tn) = _instance()
    with pytest.raises(ValueError, match="unknown replan policy"):
        T_ft.Coordinator(tp, tn, B=B, policy="debounce", device="cpu")
    with pytest.raises(TypeError, match="ReplanPolicy"):
        T_ft.Coordinator(tp, tn, B=B, policy=object(), device="cpu")
    with pytest.raises(ValueError, match="preview_cache_size"):
        T_ft.Coordinator(tp, tn, B=B, preview_cache_size=0, device="cpu")
    with pytest.raises(TypeError):
        port.apply(object())
    assert set(to.log_record()) >= {"event", "action", "old_latency",
                                    "new_latency", "ride_out_latency",
                                    "reason"}