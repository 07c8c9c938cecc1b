"""The port's capacity traces and network scenarios against the reference.

The cases of ``tests/test_sim.py``'s trace section and of
``tests/test_scenario_props.py``, run on both packages (``repro.sim`` and
``repro_torch.sim``) on fixed seeds instead of hypothesis draws.  Traces
and scenarios built from the same numbers or the same numpy seed are equal
(``==`` on breakpoints and values), and the segmented-scan primitives
``work_done_many`` / ``finish_many`` on tensors equal the reference's numpy
arrays, breakpoint ties included (``searchsorted``'s sides).
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

PACKAGES = [pytest.param(RS, id="reference"), pytest.param(TS, id="port")]


def _same_trace(r, t) -> bool:
    return r.times == t.times and r.values == t.values


def _same_scenario(r, t) -> bool:
    return (all(set(getattr(r, f)) == set(getattr(t, f))
                and all(_same_trace(getattr(r, f)[k], getattr(t, f)[k])
                        for k in getattr(r, f))
                for f in ("node_mult", "link_mult", "mem_mult"))
            and [tr.time for tr in r.replan_triggers]
            == [tr.time for tr in t.replan_triggers])


def _random_trace(seed, S, min_value=0.0, trailing=None):
    """Both packages' trace from one seeded draw: up to 6 segments, values
    in [min_value, 8), breakpoints on a 0.25 grid (so query times land on
    them) or drawn."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 7))
    if seed % 2:
        dts = rng.integers(1, 12, n - 1) * 0.25
    else:
        dts = rng.uniform(0.01, 5.0, n - 1)
    times = tuple(float(x) for x in np.concatenate([[0.0], np.cumsum(dts)]))
    values = [float(v) for v in rng.uniform(min_value, 8.0, n)]
    if trailing is not None:
        values[-1] = trailing
    return (S.PiecewiseTrace(times, tuple(values)), rng)


# ---------------------------------------------------------------------------
# tests/test_sim.py:133-181 on both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", PACKAGES)
def test_trace_integration_across_breakpoints(S):
    tr = S.piecewise((0.0, 1.0, 3.0), (2.0, 0.5, 4.0))
    assert tr.time_to_complete(0.0, 1.0) == pytest.approx(0.5)
    assert tr.time_to_complete(0.0, 2.0) == pytest.approx(1.0)
    assert tr.time_to_complete(0.0, 2.5) == pytest.approx(2.0)
    assert tr.time_to_complete(0.5, 1.0) == pytest.approx(0.5)
    assert tr.value_at(2.9) == 0.5 and tr.value_at(3.0) == 4.0
    # the vectorized coordinates on the breakpoints themselves
    t = torch.tensor([0.0, 1.0, 3.0, 2.0, 5.0], dtype=torch.float64)
    want = RS.piecewise((0.0, 1.0, 3.0), (2.0, 0.5, 4.0)).work_done_many(
        t.numpy())
    got = tr.work_done_many(t if S is TS else t.numpy())
    assert np.array_equal(np.asarray(got), want)


@pytest.mark.parametrize("S", PACKAGES)
def test_trace_zero_segment_stalls_and_trailing_zero_is_inf(S):
    tr = S.piecewise((0.0, 1.0, 2.0), (1.0, 0.0, 1.0))
    assert tr.time_to_complete(0.0, 1.5) == pytest.approx(2.5)
    dead = S.piecewise((0.0, 1.0), (1.0, 0.0))
    assert math.isinf(dead.time_to_complete(0.5, 1.0))
    assert not dead.drains() and tr.drains()


def test_trace_product_merges_breakpoints():
    for S in (RS, TS):
        a = S.piecewise((0.0, 2.0), (1.0, 3.0))
        b = S.piecewise((0.0, 1.0), (2.0, 0.5))
        p = a * b
        for t in (0.0, 0.5, 1.0, 1.5, 2.0, 5.0):
            assert p.value_at(t) == pytest.approx(a.value_at(t)
                                                  * b.value_at(t))
    assert _same_trace(RS.piecewise((0.0, 2.0), (1.0, 3.0))
                       * RS.piecewise((0.0, 1.0), (2.0, 0.5)),
                       TS.piecewise((0.0, 2.0), (1.0, 3.0))
                       * TS.piecewise((0.0, 1.0), (2.0, 0.5)))


@pytest.mark.parametrize("maker", ["gauss_markov", "iid_piecewise"])
def test_seeded_traces_are_the_reference_draw_for_draw(maker):
    kw = dict(cv=0.2, dt=1.0, horizon=2000.0)
    if maker == "gauss_markov":
        kw["corr"] = 0.9
    r = getattr(RS, maker)(np.random.default_rng(0), **kw)
    t = getattr(TS, maker)(np.random.default_rng(0), **kw)
    assert _same_trace(r, t)


def test_gauss_markov_stationary_stats():
    rng = np.random.default_rng(0)
    tr = TS.gauss_markov(rng, cv=0.2, dt=1.0, horizon=20000.0, corr=0.9)
    vals = np.asarray(tr.values)
    assert vals.mean() == pytest.approx(1.0, abs=0.03)
    assert vals.std() == pytest.approx(0.2, abs=0.03)
    v = vals - vals.mean()
    rho = (v[:-1] * v[1:]).mean() / (v.var() + 1e-12)
    assert rho == pytest.approx(0.9, abs=0.05)


def test_cv_zero_scenarios_are_constant():
    rng = np.random.default_rng(0)
    assert TS.iid_piecewise(rng, 0.0, dt=1.0, horizon=10.0).is_constant()
    assert TS.gauss_markov(rng, 0.0, dt=1.0, horizon=10.0).is_constant()
    assert TS.constant(2.0) is TS.constant(2.0)        # cached


# ---------------------------------------------------------------------------
# The segmented-scan primitives on tensors (test_scenario_props.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(12))
def test_work_done_many_matches_reference(seed):
    rt, rng = _random_trace(seed, RS)
    tt, _ = _random_trace(seed, TS)
    assert _same_trace(rt, tt)
    # random times plus every breakpoint (searchsorted side="right" ties)
    t = np.sort(np.concatenate([rng.uniform(0.0, 60.0, 10),
                                np.asarray(rt.times)]))
    got = tt.work_done_many(torch.as_tensor(t))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert np.array_equal(got.numpy(), rt.work_done_many(t))
    assert np.all(np.diff(got.numpy()) >= -1e-12)       # monotone
    for ti, wi in zip(t, got.tolist()):
        assert wi == pytest.approx(tt.work_done(float(ti)), rel=1e-12,
                                   abs=1e-12)


@pytest.mark.parametrize("seed", range(12))
def test_finish_many_matches_reference_and_inverts(seed):
    rt, rng = _random_trace(seed, RS, min_value=0.05)
    tt, _ = _random_trace(seed, TS, min_value=0.05)
    # targets: random, non-positive, and every cumulative-work breakpoint
    # (searchsorted side="left" ties)
    target = np.concatenate([rng.uniform(-1.0, 100.0, 8), [0.0, -2.0],
                             rt.cumwork])
    got = tt.finish_many(torch.as_tensor(target))
    assert np.array_equal(got.numpy(), rt.finish_many(target))
    back = tt.work_done_many(got).numpy()
    np.testing.assert_allclose(back, np.maximum(target, 0.0), rtol=1e-9,
                               atol=1e-9)
    for wi, ti in zip(target, got.tolist()):
        assert ti == pytest.approx(tt.finish_time(float(wi)) if wi > 0
                                   else 0.0, rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_scalar_coordinates_match_reference(seed):
    rt, rng = _random_trace(seed, RS, trailing=0.0 if seed % 3 == 0
                            else None)
    tt, _ = _random_trace(seed, TS, trailing=0.0 if seed % 3 == 0 else None)
    for t in list(rng.uniform(0.0, 40.0, 6)) + list(rt.times) + [math.inf]:
        assert tt.work_done(t) == rt.work_done(t)
        assert tt.value_at(t) == rt.value_at(t)
    for w in rng.uniform(0.0, 50.0, 6):
        assert tt.finish_time(w) == rt.finish_time(w)
        assert tt.time_to_complete(1.0, w) == rt.time_to_complete(1.0, w)
    assert tt.drains() == rt.drains()


def test_segmented_scans_stay_on_the_input_device():
    tr = TS.piecewise((0.0, 1.0), (2.0, 0.5))
    t = torch.tensor([0.5, 1.0, 4.0], dtype=torch.float64)
    assert tr.work_done_many(t).device == t.device
    assert tr.finish_many(t).device == t.device
    assert tr.work_done_many(torch.tensor([0.5, 1.0])).tolist() == [1.0, 2.0]
    assert set(tr._on_device) == {"cpu"}       # moved once, cached


# ---------------------------------------------------------------------------
# Trace algebra and constructors (test_scenario_props.py, fixed seeds)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_product_commutes_associates_and_has_a_unit(seed):
    a, _ = _random_trace(3 * seed, TS)
    b, _ = _random_trace(3 * seed + 1, TS)
    c, _ = _random_trace(3 * seed + 2, TS)
    assert a * b == b * a
    left, right = (a * b) * c, a * (b * c)
    assert left.times == right.times
    np.testing.assert_allclose(left.values, right.values, rtol=1e-9,
                               atol=1e-12)
    assert a * TS.constant(1.0) == a
    ra, _ = _random_trace(3 * seed, RS)
    rb, _ = _random_trace(3 * seed + 1, RS)
    rc, _ = _random_trace(3 * seed + 2, RS)
    assert _same_trace((ra * rb) * rc, left)


@pytest.mark.parametrize("seed", range(4))
def test_piecewise_coalesces_duplicates_last_wins(seed):
    tr, _ = _random_trace(seed, TS)
    i = seed % len(tr.times)
    times = tr.times[:i + 1] + (tr.times[i],) + tr.times[i + 1:]
    values = tr.values[:i + 1] + (99.0,) + tr.values[i + 1:]
    out = TS.piecewise(times, values)
    assert out.times == tr.times
    assert out.value_at(tr.times[i]) == 99.0
    assert _same_trace(out, RS.piecewise(times, values))
    with pytest.raises(ValueError, match="strictly increasing"):
        TS.PiecewiseTrace((0.0, 1.0, 1.0), (1.0, 2.0, 3.0))


@pytest.mark.parametrize("start,periods,period,duty,low", [
    (0.0, 1, 0.25, 0.25, 0.0), (0.5, 3, 0.5, 0.5, 0.2),
    (1.7, 5, 1.0, 0.75, 0.0), (3.2, 2, 0.25, 0.5, 0.2)])
def test_square_wave_matches_reference(start, periods, period, duty, low):
    end = start + periods * period
    tr = TS.square_wave(start, end, period=period, duty=duty, low=low)
    assert _same_trace(tr, RS.square_wave(start, end, period=period,
                                          duty=duty, low=low))
    assert tr.drains() and tr.value_at(end + 0.1) == 1.0
    work = tr.work_done(end) - tr.work_done(start)
    want = periods * period * (duty * 1.0 + (1 - duty) * low)
    assert work == pytest.approx(want, rel=1e-9, abs=1e-12)


def _composed(S, net):
    scen = (S.NetworkScenario()
            .with_straggler(1, 0.5, 3.0, 4.0)
            .with_outage(0, 1, 1.0, 2.0)
            .with_flapping(1, 2, 0.25, 2.25, period=0.5, duty=0.5)
            .with_mem_pressure(2, 0.0, 5.0, 0.5)
            .with_region_degradation([1, 2], [(0, 1), (1, 2)], 1.5, 4.0,
                                     0.3)
            .with_straggler(2, 2.0, 2.0, 8.0))          # zero-length
    return scen


def test_with_star_compositions_match_reference():
    rnet = R.make_edge_network(num_servers=3, num_clients=2, seed=4)
    tnet = T.make_edge_network(num_servers=3, num_clients=2, seed=4)
    r, t = _composed(RS, rnet), _composed(TS, tnet)
    assert _same_scenario(r, t)
    assert t.drains() == r.drains()
    for n in range(len(tnet.nodes)):
        assert _same_trace(r.node_trace(rnet, n), t.node_trace(tnet, n))
        assert _same_trace(r.mem_trace(rnet, n), t.mem_trace(tnet, n))
    assert _same_trace(r.link_trace(rnet, 0, 1), t.link_trace(tnet, 0, 1))
    assert t.node_mult[1].value_at(2.0) == pytest.approx(0.25 * 0.3)
    with pytest.raises(ValueError):
        TS.NetworkScenario().with_region_degradation([1], [], 0.0, 1.0, 0.0)
    with pytest.raises(ValueError):
        TS.NetworkScenario().with_mem_pressure(1, 0.0, 1.0, -0.5)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("maker", ["piecewise_cv_scenario",
                                   "gauss_markov_scenario"])
def test_seeded_scenarios_are_the_reference_draw_for_draw(seed, maker):
    rnet = R.make_edge_network(num_servers=3, num_clients=2, seed=seed)
    tnet = T.make_edge_network(num_servers=3, num_clients=2, seed=seed)
    r = getattr(RS, maker)(rnet, 0.3, np.random.default_rng(seed), dt=0.2,
                           horizon=6.0)
    t = getattr(TS, maker)(tnet, 0.3, np.random.default_rng(seed), dt=0.2,
                           horizon=6.0)
    assert _same_scenario(r, t)


@pytest.mark.parametrize("t_probe", [0.0, 1.25, 2.0, 7.5])
def test_sampled_network_matches_reference(t_probe):
    rnet = R.make_edge_network(num_servers=3, num_clients=2, seed=4)
    tnet = T.make_edge_network(num_servers=3, num_clients=2, seed=4)
    r = RS.sampled_network(rnet, _composed(RS, rnet), t_probe)
    t = TS.sampled_network(tnet, _composed(TS, tnet), t_probe)
    assert np.array_equal(r.rate, t.rate)
    assert [(n.f, n.mem) for n in r.nodes] == [(n.f, n.mem) for n in t.nodes]
    assert np.array_equal(tnet.rate, rnet.rate)        # base untouched


def test_periodic_resync_triggers_match_reference():
    rnet = R.make_edge_network(num_servers=3, num_clients=2, seed=4)
    tnet = T.make_edge_network(num_servers=3, num_clients=2, seed=4)
    r = RS.periodic_resync_triggers(rnet, _composed(RS, rnet), cadence=0.7,
                                    horizon=4.0)
    t = TS.periodic_resync_triggers(tnet, _composed(TS, tnet), cadence=0.7,
                                    horizon=4.0)
    assert [x.time for x in r] == [x.time for x in t]
    assert all(isinstance(x.event, T_ft.Resync) for x in t)
    assert all(isinstance(x.event, R_ft.Resync) for x in r)
    for a, b in zip(r, t):
        assert np.array_equal(a.event.net.rate, b.event.net.rate)
        assert [n.f for n in a.event.net.nodes] == \
            [n.f for n in b.event.net.nodes]
    with pytest.raises(ValueError, match="cadence"):
        TS.periodic_resync_triggers(tnet, TS.NetworkScenario(), cadence=0.0,
                                    horizon=1.0)


def test_with_replan_sorts_triggers():
    s = (TS.NetworkScenario().with_replan(2.0, T_ft.Straggler(1, 2.0))
         .with_replan(0.5, T_ft.RateChange(0, 1, 0.5)))
    assert [tr.time for tr in s.replan_triggers] == [0.5, 2.0]
    assert isinstance(s.replan_triggers[0], TS.ReplanTrigger)
