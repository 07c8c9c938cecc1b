"""The port's warm replans (``Planner.update``) against the reference.

The port of ``tests/test_planner_update.py``: the same numpy-seeded
instances go through ``repro`` and ``repro_torch`` (``device="cpu"``), and
the two contracts that make an in-place update safe hold bit for bit:

  1. **Patched graphs** — after an update every cached graph tensor is
     ``==`` the *reference's* fresh ``GraphFactory`` assembly on the
     mutated network (and the port's own).
  2. **Warm == cold == reference** — the warm solve after an update is
     ``same_msp_result``-identical to a cold solve on a fresh port
     ``Planner`` and to the reference's warm solve.

Every value is an exactly rounded float64 op in the reference's order, so
nothing here has a tolerance.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro.ft as R_ft
from repro.core import profiles as R_profiles
from conftest import same_msp_result

import repro_torch.core as T
import repro_torch.ft as T_ft
from repro_torch import obs

B = 64
SEEDS = [0, 1, 2, 3, 7, 11]
GRAPH_FIELDS = ("comm_cost", "comm_beta", "seg_cost", "seg_beta",
                "src_cost", "src_beta")


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
    """A port MSPResult with the reference's SplitSolution type."""
    sol = R.SplitSolution(res.solution.cuts, res.solution.placement)
    return dataclasses.replace(res, solution=sol)


def _deltas(ft, n):
    """The reference test's four deltas, as events of package ``ft``."""
    return [ft.RateChange(n_from=1, n_to=2, factor=0.25),
            ft.RateChange(n_from=0, n_to=1, factor=4.0),
            ft.Straggler(node=n - 1, slowdown=3.0),
            ft.Straggler(node=0, slowdown=2.0)]      # client node: src row


def _all_deltas(ft, n):
    return _deltas(ft, n) + [ft.NodeFailure(server=1)]


def _warm(planner, bs=(4, 12)):
    """A planner with populated graph/DP caches and warm hints."""
    for b in bs:
        planner.solve(b, B, solver="batched")
    return planner


def _pair(seed, bs=(4, 12), **kw):
    (rp, rn), (tp, tn) = _instances(seed, **kw)
    return (_warm(R.Planner(rp, rn), bs),
            _warm(T.Planner(tp, tn, device="cpu"), bs), tp)


def _same_net(rnet, tnet):
    return (np.array_equal(rnet.rate, tnet.rate)
            and [n.f for n in rnet.nodes] == [n.f for n in tnet.nodes]
            and len(rnet.nodes) == len(tnet.nodes))


# -- contract 1: patched graphs == the reference's fresh assembly ----------


@pytest.mark.parametrize("which", range(4))
@pytest.mark.parametrize("seed", SEEDS)
def test_patched_graphs_bitwise_equal_reference_assembly(seed, which):
    ref_pl, pl, tp = _pair(seed)
    n = len(pl.net.nodes)
    ref_pl.update(_deltas(R_ft, n)[which])
    pl.update(_deltas(T_ft, n)[which])
    assert _same_net(ref_pl.net, pl.net)
    want_ref = R.GraphFactory(ref_pl.profile, ref_pl.net)
    want_port = T.GraphFactory(tp, pl.net, device="cpu")
    assert set(pl._graphs) == {4, 12}
    for b, g in pl._graphs.items():
        r, p = want_ref.graph(b), want_port.graph(b)
        for f in GRAPH_FIELDS:
            got = getattr(g, f).numpy()
            assert np.array_equal(got, getattr(r, f)), (which, b, f)
            assert np.array_equal(got, getattr(p, f).numpy()), (which, b, f)


# -- contract 2: warm update == cold solve == the reference's warm solve ---


@pytest.mark.parametrize("which", range(5))
@pytest.mark.parametrize("seed", SEEDS)
def test_update_matches_cold_and_reference(seed, which):
    ref_pl, pl, tp = _pair(seed)
    n = len(pl.net.nodes)
    ref_pl.update(_all_deltas(R_ft, n)[which])
    pl.update(_all_deltas(T_ft, n)[which])
    assert _same_net(ref_pl.net, pl.net)
    for b in (4, 12):
        warm = pl.solve(b, B, solver="batched")
        cold = T.Planner(tp, pl.net, device="cpu").solve(b, B,
                                                         solver="batched")
        ref = ref_pl.solve(b, B, solver="batched")
        assert same_msp_result(ref, _as_ref(warm)), (which, b, ref, warm)
        assert same_msp_result(_as_ref(cold), _as_ref(warm)), (which, b)
        assert warm.thresholds_scanned == ref.thresholds_scanned


@pytest.mark.parametrize("seed", [0, 4, 9])
def test_update_sequence_matches_cold_and_reference(seed):
    """Compounded deltas: each update scales the surviving hints' lower
    bounds by its r_min, so the warm window stays valid across a
    sequence."""
    ref_pl, pl, tp = _pair(seed)
    n = len(pl.net.nodes)
    for rd, td in zip(_deltas(R_ft, n), _deltas(T_ft, n)):
        ref_pl.update(rd)
        pl.update(td)
        warm = pl.solve(4, B, solver="batched")
        cold = T.Planner(tp, pl.net, device="cpu").solve(4, B,
                                                         solver="batched")
        assert same_msp_result(_as_ref(cold), _as_ref(warm)), (td, warm)
        assert same_msp_result(ref_pl.solve(4, B, solver="batched"),
                               _as_ref(warm)), td


def test_node_failure_renumbers_and_matches_cold():
    """NodeFailure is a rebuild on ``net.degraded``: the port's
    renumbering is the reference's, and the solve equals a cold one."""
    ref_pl, pl, tp = _pair(3, num_servers=4)
    n_before = len(pl.net.nodes)
    ref_pl.update(R_ft.NodeFailure(server=2))
    pl.update(T_ft.NodeFailure(server=2))
    assert len(pl.net.nodes) == n_before - 1
    assert _same_net(ref_pl.net, pl.net)
    assert [n.name for n in pl.net.nodes] == \
        [n.name for n in ref_pl.net.nodes]
    r = pl.solve(4, B, solver="batched")
    cold = T.Planner(tp, pl.net, device="cpu").solve(4, B, solver="batched")
    assert same_msp_result(_as_ref(r), _as_ref(cold))
    assert same_msp_result(ref_pl.solve(4, B, solver="batched"), _as_ref(r))
    if r.feasible:
        assert all(p < len(pl.net.nodes) for p in r.solution.placement)


@pytest.mark.parametrize("failed", [[1], [2, 4], [3]])
def test_degraded_network_equals_reference(failed):
    (_, rn), (_, tn) = _instances(6, num_servers=5)
    r, t = rn.degraded(failed), tn.degraded(failed)
    assert np.array_equal(r.rate, t.rate)
    assert [dataclasses.astuple(n) for n in r.nodes] == \
        [dataclasses.astuple(n) for n in t.nodes]
    assert (r.num_clients, r.topology) == (t.num_clients, t.topology)
    with pytest.raises(ValueError):
        tn.degraded([0])


def test_update_accepts_reference_events():
    """``update`` is duck-typed: the reference's events patch the port's
    planner exactly as the port's own do."""
    _, pl_a, _ = _pair(2)
    _, pl_b, _ = _pair(2)
    n = len(pl_a.net.nodes)
    for ra, ta in zip(_all_deltas(R_ft, n), _all_deltas(T_ft, n)):
        pl_a.update(ra)
        pl_b.update(ta)
        assert _same_net(pl_a.net, pl_b.net)
        ra_res, ta_res = pl_a.solve(4, B), pl_b.solve(4, B)
        assert same_msp_result(_as_ref(ra_res), _as_ref(ta_res))


def test_resync_rebuilds_on_the_snapshot():
    _, pl, tp = _pair(1)
    snap, _ = T_ft.Coordinator.preview(
        pl.net, None, T_ft.RateChange(n_from=2, n_to=3, factor=0.5))
    obs.reset()
    with obs.enabled_scope():
        pl.update(T_ft.Resync(net=snap))
        assert obs.counter("planner.updates[rebuild]") == 1
        r = pl.solve(4, B)
        assert obs.counter("planner.cold_solves") == 1
    obs.reset()
    assert pl.net is snap and pl._hints.keys() == {(4, B, pl.default_K(None))}
    cold = T.Planner(tp, snap, device="cpu").solve(4, B)
    assert same_msp_result(_as_ref(r), _as_ref(cold))


def test_update_rejects_unknown_delta():
    """An unknown delta type raises instead of silently no-oping."""
    (_, _), (tp, tn) = _instances(0)
    pl = T.Planner(tp, tn, device="cpu")
    with pytest.raises(TypeError):
        pl.update(object())


# -- counters and the warm path's two branches ------------------------------


def test_incremental_hit_and_cold_counters():
    _, pl, _ = _pair(1, bs=(4,))
    obs.reset()
    with obs.enabled_scope():
        pl.update(T_ft.RateChange(n_from=1, n_to=2, factor=0.5))
        pl.solve(4, B, solver="batched")         # warm: hint survives
        pl.solve(12, B, solver="batched")        # cold: no hint for b=12
        assert obs.counter("planner.incremental_hits") == 1
        assert obs.counter("planner.cold_solves") == 1
        assert obs.counter("planner.updates[rate]") == 1
        pl.update(T_ft.Straggler(node=1, slowdown=1.5))
        assert obs.counter("planner.updates[speed]") == 1
    obs.reset()


def test_warm_solve_scans_no_more_thresholds_than_cold():
    ref_pl, pl, _ = _pair(2, bs=(8,))
    cold = pl.solve(8, B, solver="batched")      # memoized pre-update
    pl.update(T_ft.Straggler(node=1, slowdown=1.5))
    ref_pl.update(R_ft.Straggler(node=1, slowdown=1.5))
    warm = pl.solve(8, B, solver="batched")
    assert warm.thresholds_scanned == \
        ref_pl.solve(8, B, solver="batched").thresholds_scanned
    if warm.feasible and cold.feasible:
        assert warm.thresholds_scanned <= cold.thresholds_scanned


@pytest.mark.parametrize("seed", [1, 5])
def test_wide_warm_window_goes_through_k1(seed, monkeypatch):
    """A hint whose bounds are loose (zero) still bounds the optimum, but
    its window passes 32 thresholds: the warm path then sweeps it with K1
    (``dp.dist_at``) and runs one single-threshold stack sweep — two
    sweeps, and the cold solve's result."""
    (_, _), (tp, tn) = _instances(seed, num_layers=10, num_servers=5)
    pl = _warm(T.Planner(tp, tn, device="cpu"), bs=(6,))
    pl.update(T_ft.RateChange(n_from=1, n_to=2, factor=0.5))
    key = (6, B, pl.default_K(None))
    pl._hints[key]["lb_dist"] = 0.0
    pl._hints[key]["lb_beta"] = 0.0
    widths = []
    real = T.shortest_path._LayeredDP.dist_at

    def dist_at(dp, ts):
        widths.append(len(ts))
        return real(dp, ts)

    monkeypatch.setattr(T.shortest_path._LayeredDP, "dist_at", dist_at)
    warm = pl.solve(6, B, solver="batched")
    cold = T.Planner(tp, pl.net, device="cpu").solve(6, B, solver="batched")
    assert widths and widths[0] > 32
    assert warm.thresholds_scanned == 2
    assert same_msp_result(_as_ref(cold), _as_ref(warm))


# -- the fleet instance's profile --------------------------------------------


def test_transformer_profile_equals_reference():
    kw = dict(num_layers=4, d_model=64, n_heads=4, n_kv=2, d_ff=128,
              vocab=1000, seq_len=16)
    r = R.transformer_profile("t", **kw)
    t = T.transformer_profile("t", **kw)
    for f in ("fp_work", "bp_work", "act_bytes", "grad_bytes",
              "param_bytes", "opt_bytes"):
        assert np.array_equal(getattr(r, f), getattr(t, f)), f
    assert T.flops_summary(t) == R_profiles.flops_summary(r)
    moe = dict(kw, moe_experts=4, moe_top_k=2)
    assert T.transformer_layer_flops(64, 4, 2, 128, 16, moe_experts=4,
                                     moe_top_k=2) == \
        R_profiles.transformer_layer_flops(64, 4, 2, 128, 16,
                                           moe_experts=4, moe_top_k=2)
    assert np.array_equal(R.transformer_profile("m", **moe).param_bytes,
                          T.transformer_profile("m", **moe).param_bytes)
