"""The scenario fuzzer in the port against the reference.

Both packages draw from a ``numpy.random.Generator`` seeded alike, in the
same order, so one seed gives the same scenario (compared as
``scenario_to_dict``: ``==``), the same case and the same coordinator event
stream.  The differential oracle (heap engine against the vectorized
engine) gives equal counts and gaps; every gap is within the reference's
1e-9.  ``shrink_case`` reaches the same minimal case under the same forced
predicate, the committed corpus (``tests/corpus/``) loads and replays in
the port, and a case saved by either package loads in the other.  Runs on
the CPU (``device="cpu"``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro.ft as R_ft
import repro.sim as RS
from repro.sim import fuzz as RF

import repro_torch.ft as T_ft
import repro_torch.sim as TS
from repro_torch.sim import fuzz as TF

CPU = "cpu"
PARITY_RTOL = 1e-9
CORPUS_DIR = os.path.join(os.path.dirname(__file__), "corpus")
SEEDS = [0, 1, 2, 3, 7, 11, 17, 23, 1234]
CONFIGS = {
    "default": ({}, {}),
    "all_families": ({"families": RF.ALL_FAMILIES},
                     {"families": TF.ALL_FAMILIES}),
    "dead": ({"allow_dead": True}, {"allow_dead": True}),
    "wide": ({"min_events": 3, "max_events": 6},
             {"min_events": 3, "max_events": 6}),
}

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: the simulator's many
    small CPU ops gain nothing from a thread pool, and parallel test
    workers each spinning a full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _cfg(name):
    r, t = CONFIGS[name]
    return RF.FuzzConfig(**r), TF.FuzzConfig(**t)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_case_equals_reference(seed, config):
    rc, tc = _cfg(config)
    r, t = RF.fuzz_case(seed, rc), TF.fuzz_case(seed, tc)
    assert t.to_dict() == r.to_dict()
    rp, rn, rs = RF.case_instance(r)
    tp, tn, ts = TF.case_instance(t)
    assert (ts.cuts, ts.placement) == (rs.cuts, rs.placement)
    assert np.array_equal(tn.rate, rn.rate)
    if not tc.allow_dead:
        assert t.scenario.drains()


@pytest.mark.parametrize("seed", SEEDS[:5])
def test_fuzz_scenario_with_and_without_a_plan(seed):
    rp, rn, rs, rb, _ = RS.random_instance(seed)
    tp, tn, ts, tb, _ = TS.random_instance(seed)
    rr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(4):
        want = RF.fuzz_scenario(rr, rn, profile=rp, sol=rs, b=rb,
                                num_microbatches=6)
        got = TF.fuzz_scenario(tr, tn, profile=tp, sol=ts, b=tb,
                               num_microbatches=6)
        assert TF.scenario_to_dict(got) == RF.scenario_to_dict(want)
        want = RF.fuzz_scenario(rr, rn)
        got = TF.fuzz_scenario(tr, tn)
        assert TF.scenario_to_dict(got) == RF.scenario_to_dict(want)
    assert tr.random() == rr.random()          # the same number of draws


@pytest.mark.parametrize("tilt", [({}, 1.0), ({"outage": 4.0}, 1.0),
                                  ({}, 3.0), ({"straggler": 2.0,
                                               "drift": 0.5}, 2.0)])
def test_fuzz_scenario_weighted_equals_reference(tilt):
    family_tilt, severity = tilt
    rp, rn, rs, rb, _ = RS.random_instance(5)
    tp, tn, ts, tb, _ = TS.random_instance(5)
    rr, tr = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(6):
        ws, ww = RF.fuzz_scenario_weighted(
            rr, rn, profile=rp, sol=rs, b=rb, family_tilt=family_tilt,
            severity_tilt=severity)
        gs, gw = TF.fuzz_scenario_weighted(
            tr, tn, profile=tp, sol=ts, b=tb, family_tilt=family_tilt,
            severity_tilt=severity)
        assert TF.scenario_to_dict(gs) == RF.scenario_to_dict(ws)
        assert gw == ww


def test_fuzz_scenario_weighted_argument_errors():
    tn = TS.random_instance(5)[1]
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="severity_tilt"):
        TF.fuzz_scenario_weighted(rng, tn, severity_tilt=0.0)
    with pytest.raises(ValueError, match="unknown families"):
        TF.fuzz_scenario_weighted(rng, tn, family_tilt={"meteor": 2.0})
    with pytest.raises(ValueError, match="> 0"):
        TF.fuzz_scenario_weighted(rng, tn, family_tilt={"outage": 0.0})


@pytest.mark.parametrize("kw", [
    dict(horizon=4.0, max_events=5, allow_failure=False, flap_fraction=0.75),
    dict(horizon=2.0, max_events=4),
    dict(horizon=1.0, max_events=6, flap_fraction=0.5, flap_window=0.2),
])
@pytest.mark.parametrize("seed", [3, 9, 1000])
def test_fuzz_event_stream_equals_reference(seed, kw):
    rn = RS.random_instance(seed)[1]
    tn = TS.random_instance(seed)[1]
    want = RF.fuzz_event_stream(np.random.default_rng(seed), rn, **kw)
    got = TF.fuzz_event_stream(np.random.default_rng(seed), tn, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.time == w.time
        assert type(g.event).__name__ == type(w.event).__name__
        assert dataclasses.asdict(g.event) == dataclasses.asdict(w.event)
        assert isinstance(g.event, (T_ft.NodeFailure, T_ft.RateChange,
                                    T_ft.Straggler))
    assert not isinstance(got[0].event, (R_ft.RateChange, R_ft.Straggler,
                                         R_ft.NodeFailure))
    with pytest.raises(ValueError, match="flap_fraction"):
        TF.fuzz_event_stream(np.random.default_rng(0), tn, horizon=1.0,
                             flap_fraction=1.5)


@pytest.mark.parametrize("config", ["default", "dead"])
@pytest.mark.parametrize("seed", [0, 2, 5, 8, 14, 23, 41, 100])
def test_check_parity_equals_reference(seed, config):
    rc, tc = _cfg(config)
    r = RF.check_parity(RF.fuzz_case(seed, rc))
    t = TF.check_parity(TF.fuzz_case(seed, tc), device=CPU)
    assert (t.engine, t.engine_reason, t.finite, t.ok) == \
        (r.engine, r.engine_reason, r.finite, r.ok)
    assert t.gap == r.gap and t.makespan == r.makespan
    assert t.gap <= PARITY_RTOL or not t.finite


def test_run_fuzz_60_equals_reference():
    """The reference's values: 60 vectorized cases, 0 failures, max gap
    2.4e-15."""
    r = RF.run_fuzz(60, seed=0)
    t = TF.run_fuzz(60, seed=0, device=CPU)
    assert (t.trials, t.vectorized, t.event_fallback, t.max_gap) == \
        (r.trials, r.vectorized, r.event_fallback, r.max_gap)
    assert t.ok and not t.failures and t.max_gap <= PARITY_RTOL
    assert (t.vectorized, t.event_fallback) == (60, 0)


def test_run_fuzz_with_dead_links_falls_back():
    rc, tc = _cfg("dead")
    r = RF.run_fuzz(30, seed=2, config=rc)
    t = TF.run_fuzz(30, seed=2, config=tc, device=CPU)
    assert (t.vectorized, t.event_fallback, t.max_gap) == \
        (r.vectorized, r.event_fallback, r.max_gap)
    assert [c.seed for c, _ in t.failures] == [c.seed for c, _ in r.failures]
    assert t.event_fallback > 0


@pytest.mark.parametrize("seed", [23, 5, 17])
def test_shrink_case_equals_reference(seed):
    """Under a forced predicate (the scenario still slows the run) both
    shrinkers reach the same minimal case."""
    def pred(check, case, kw):
        base = check(dataclasses.replace(
            case, scenario=type(case.scenario)()), **kw).makespan
        return lambda c: check(c, **kw).makespan > base * (1 + 1e-12)

    rcase, tcase = RF.fuzz_case(seed), TF.fuzz_case(seed)
    rfail = pred(RF.check_parity, rcase, {})
    tfail = pred(TF.check_parity, tcase, {"device": CPU})
    assert rfail(rcase) == tfail(tcase)
    if not tfail(tcase):
        with pytest.raises(ValueError, match="failing case"):
            TF.shrink_case(tcase, tfail)
        return
    want, got = RF.shrink_case(rcase, rfail), TF.shrink_case(tcase, tfail)
    assert got.to_dict() == want.to_dict()
    assert tfail(got)


def test_shrink_case_always_true_predicate_reaches_the_floor():
    rcase, tcase = RF.fuzz_case(11), TF.fuzz_case(11)
    want = RF.shrink_case(rcase, lambda c: True, max_rounds=64)
    got = TF.shrink_case(tcase, lambda c: True, max_rounds=64)
    assert got.to_dict() == want.to_dict()
    assert (got.b, got.num_microbatches) == (1, 1)


def test_corpus_loads_and_replays_in_the_port():
    corpus = TF.load_corpus(CORPUS_DIR)
    ref = RF.load_corpus(CORPUS_DIR)
    assert corpus and len(corpus) == len(ref)
    for (path, case), (rpath, rcase) in zip(corpus, ref):
        assert path == rpath and case.to_dict() == rcase.to_dict()
        res = TF.check_parity(case, device=CPU)
        want = RF.check_parity(rcase)
        assert (res.engine, res.gap, res.makespan) == \
            (want.engine, want.gap, want.makespan)
        if case.scenario.drains():
            assert res.ok, (path, res)
        else:
            assert res.engine == "event" and res.gap == 0.0, (path, res)


@pytest.mark.parametrize("seed", [11, 29])
def test_a_saved_case_loads_in_the_other_package(tmp_path, seed):
    cfg_r, cfg_t = _cfg("all_families")
    tcase = TF.fuzz_case(seed, cfg_t)
    p = TF.save_case(tcase, str(tmp_path / "port"), note="from the port")
    back = RF.load_case(p)
    assert back.to_dict() == dataclasses.replace(
        tcase, note="from the port").to_dict()
    rcase = RF.fuzz_case(seed, cfg_r)
    q = RF.save_case(rcase, str(tmp_path / "ref"), name="r")
    loaded = TF.load_case(q)
    assert loaded.to_dict() == rcase.to_dict()
    assert loaded.scenario == tcase.scenario
    with open(p) as f, open(RF.save_case(rcase, str(tmp_path / "ref"))) as g:
        assert json.load(f)["scenario"] == json.load(g)["scenario"]
    [(path, again)] = TF.load_corpus(str(tmp_path / "port"))
    assert path == p and again == TF.load_case(p)
    assert TF.load_corpus(str(tmp_path / "missing")) == []


def test_case_format_errors(tmp_path):
    case = TF.fuzz_case(1)
    with pytest.raises(ValueError, match="replan triggers"):
        TF.save_case(dataclasses.replace(
            case, scenario=case.scenario.with_replan(1.0, object())),
            str(tmp_path))
    d = case.to_dict()
    d["format"] = "other/2"
    with pytest.raises(ValueError, match="unknown corpus format"):
        TF.FuzzCase.from_dict(d)
