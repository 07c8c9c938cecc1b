"""The adaptive replan cadence and the policy tuner in the port against the
reference.

The same level sequences go through both ``DriftEstimator``s and both
``AdaptiveCadence`` policies (rates, cadences and decisions ``==``);
``network_signature`` gives the same digest strings for the same networks;
``tune_policies`` on the same fuzzed stream corpus (``random_instance(3)``,
streams from seeds 300..305) gives an equal ``TuneResult`` after
``clear_tune_cache()`` in both packages, with the port's own cache hits.
Runs on the CPU (``device="cpu"``).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.core as R
import repro.sim as RS
from repro.ft import adaptive as RA

import repro_torch.core as T
import repro_torch.ft as T_ft
import repro_torch.sim as TS
from repro_torch import obs
from repro_torch.ft import adaptive as TA

CPU = "cpu"

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: the simulator's many
    small CPU ops gain nothing from a thread pool, and parallel test
    workers each spinning a full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _levels(kind, n=24, seed=0):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.05, 0.6, n))
    if kind == "ramp":
        lv = 0.2 * t
    elif kind == "down":
        lv = -0.3 * t + rng.normal(0, 0.01, n)
    elif kind == "flap":
        lv = 0.3 * (np.arange(n) % 2)
    elif kind == "noise":
        lv = rng.normal(0, 0.2, n)
    else:                                   # steps with a failure's inf
        lv = np.where(np.arange(n) > n // 2, 0.5, 0.0)
        lv[n // 3] = math.inf
    return list(zip(lv.tolist(), t.tolist()))


@pytest.mark.parametrize("kw", [dict(), dict(halflife=0.5, z=1.0),
                                dict(halflife=2.0, initial_rate=0.1,
                                     min_samples=1)])
@pytest.mark.parametrize("kind", ["ramp", "down", "flap", "noise", "steps"])
def test_drift_estimator_equals_reference(kind, kw):
    r, t = RA.DriftEstimator(**kw), TA.DriftEstimator(**kw)
    for i, (lv, ts) in enumerate(_levels(kind)):
        assert t.observe(lv, ts) == r.observe(lv, ts)
        if i == 10:
            r.rebase()
            t.rebase()
        assert (t.rate, t._mean, t._var, t._w2, t._n) == \
            (r.rate, r._mean, r._var, r._w2, r._n)
    assert repr(t) == repr(r)
    t.reset()
    assert (t.rate, t._mean, t._n) == (0.0, t.initial_rate, 0)


def test_drift_estimator_validation():
    for bad in (dict(halflife=0.0), dict(z=-1.0), dict(initial_rate=-1.0),
                dict(min_samples=0)):
        with pytest.raises(ValueError):
            TA.DriftEstimator(**bad)
    for bad in (dict(solve_cost=0.0), dict(staleness_weight=0.0),
                dict(min_cadence=2.0, max_cadence=1.0)):
        with pytest.raises(ValueError):
            TA.AdaptiveCadence(**bad)


def test_cadence_follows_the_square_root_rule():
    p = TA.AdaptiveCadence(solve_cost=0.05, staleness_weight=1.0)
    assert p.cadence == math.inf
    for t in range(8):
        p.estimator.observe(0.2 * t, float(t))
    assert p.cadence == math.sqrt(2 * 0.05 / (1.0 * p.estimator.rate))
    q = RA.AdaptiveCadence(solve_cost=0.05, staleness_weight=1.0)
    for t in range(8):
        q.estimator.observe(0.2 * t, float(t))
    assert p.cadence == q.cadence
    clamped = TA.AdaptiveCadence(min_cadence=5.0, max_cadence=6.0)
    clamped.estimator = p.estimator
    assert clamped.cadence == 5.0


def test_signed_net_deviations_equal_reference():
    rp, rn, _, _, _ = RS.random_instance(3)
    tp, tn, _, _, _ = TS.random_instance(3)
    rs = RS.gauss_markov_scenario(rn, 0.3, np.random.default_rng(1), dt=0.1,
                                  horizon=2.0)
    ts = TS.gauss_markov_scenario(tn, 0.3, np.random.default_rng(1), dt=0.1,
                                  horizon=2.0)
    for t in (0.0, 0.35, 1.2):
        got = TA._signed_net_deviations(tn, TS.sampled_network(tn, ts, t))
        want = RA._signed_net_deviations(rn, RS.sampled_network(rn, rs, t))
        assert got == want
    assert TA._signed_net_deviations(tn, tn.degraded([1])) == {}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("num_servers", [2, 4, 6])
def test_network_signature_equals_reference(num_servers, seed):
    rn = R.make_edge_network(num_servers=num_servers, seed=seed)
    tn = T.make_edge_network(num_servers=num_servers, seed=seed)
    assert TA.network_signature(tn) == RA.network_signature(rn)
    assert TA.network_signature(tn) != TA.network_signature(
        T.make_edge_network(num_servers=num_servers, seed=seed + 100))
    assert TA.network_signature(tn.degraded([1])) == \
        RA.network_signature(rn.degraded([1]))


def test_default_tuning_grid_equals_reference():
    for sc in (0.05, 0.15):
        got, want = TA.default_tuning_grid(solve_cost=sc), \
            RA.default_tuning_grid(solve_cost=sc)
        assert list(got) == list(want) and len(got) == 10
        assert [repr(f()) for f in got.values()] == \
            [repr(f()) for f in want.values()]


def _tune_setup(S):
    prof, net, _sol, _b, B = S.random_instance(3)
    streams = [S.fuzz_event_stream(np.random.default_rng(s), net,
                                   horizon=4.0, max_events=4,
                                   allow_failure=False, flap_fraction=0.75)
               for s in range(300, 306)]
    return prof, net, B, streams


def test_tune_policies_equals_reference_and_caches():
    rp, rn, B, rs = _tune_setup(RS)
    tp, tn, _, ts = _tune_setup(TS)
    RA.clear_tune_cache()
    TA.clear_tune_cache()
    want = RA.tune_policies(rp, rn, B, rs,
                            configs=RA.default_tuning_grid(solve_cost=0.15),
                            min_streams=2, solve_downtime=0.15)
    with obs.enabled_scope():
        obs.reset()
        got = TA.tune_policies(tp, tn, B, ts,
                               configs=TA.default_tuning_grid(
                                   solve_cost=0.15),
                               min_streams=2, solve_downtime=0.15,
                               device=CPU)
        assert obs.counter("ft.tune.rounds") == len(got.rounds)
        again = TA.tune_policies(tp, tn, B, ts,
                                 configs=TA.default_tuning_grid(
                                     solve_cost=0.15),
                                 min_streams=2, solve_downtime=0.15,
                                 device=CPU)
        assert obs.counter("ft.tune.cache_hits") == 1
    obs.reset()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()
    assert again.from_cache and dataclasses.replace(
        again, from_cache=False) == got
    TA.clear_tune_cache()
    fresh = TA.tune_policies(tp, tn, B, ts,
                             configs=TA.default_tuning_grid(solve_cost=0.15),
                             min_streams=2, solve_downtime=0.15, device=CPU)
    assert not fresh.from_cache and fresh == got
    RA.clear_tune_cache()
    TA.clear_tune_cache()


def test_tune_policies_default_grid_parsimony_and_validation():
    rp, rn, B, rs = _tune_setup(RS)
    tp, tn, _, ts = _tune_setup(TS)
    want = RA.tune_policies(rp, rn, B, rs[:4], min_streams=2,
                            solve_downtime=0.05, cache=False)
    got = TA.tune_policies(tp, tn, B, ts[:4], min_streams=2,
                           solve_downtime=0.05, cache=False, device=CPU)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    tied = TA.tune_policies(tp, tn, B, ts,
                            configs={"eager": T_ft.Eager,
                                     "quiet": T_ft.RideOut},
                            min_streams=2, solve_downtime=0.0, cache=False,
                            device=CPU)
    assert tied.best == "quiet"
    only = {"hand": lambda: T_ft.Hysteresis(0.25, cooldown=0.3)}
    assert TA.tune_policies(tp, tn, B, ts[:3], configs=only, min_streams=2,
                            cache=False, device=CPU).best == "hand"
    for bad in (dict(streams=[]), dict(eta=1), dict(min_streams=0),
                dict(cvar_weight=2.0), dict(configs={})):
        kw = dict(streams=ts, configs=only, cache=False, device=CPU)
        kw.update(bad)
        with pytest.raises(ValueError):
            TA.tune_policies(tp, tn, B, **kw)
