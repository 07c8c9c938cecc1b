"""Chrome traces, the obs registry and checkpoints in the port against the
reference.

* ``write_chrome_trace`` of the same simulated run (event and vectorized
  engines, with counter tracks, flow events and the same wall spans) gives
  JSON equal to the reference's after ``json.load`` (``==``), and
  ``validate_chrome_trace`` gives the same messages;
* ``Registry.snapshot`` and ``obs.dump`` are equal for the same counter
  sequence (and the same span records);
* a checkpoint written by either package restores in the other with equal
  arrays (bitwise) and keys; ``meta.json`` is equal apart from ``time`` and
  ``write_seconds``, the two clock readings; ``estimate_restore_seconds``
  is equal on one directory;
* the coordinator's ``restore_cost`` callable prices a ``NodeFailure``
  (and nothing else) at ``estimate_restore_seconds`` of the checkpoint.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro.sim as RS
from repro import checkpoint as R_ckpt
from repro import obs as R_obs
from repro.obs.spans import SpanRecord as RSpan

import repro_torch.core as T
import repro_torch.ft as T_ft
import repro_torch.sim as TS
from repro_torch import obs as T_obs
from repro_torch.checkpoint import (CheckpointStore, estimate_restore_seconds,
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.obs.spans import SpanRecord as TSpan

CPU = "cpu"
TIMING_KEYS = ("time", "write_seconds")

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: the simulator's many
    small CPU ops gain nothing from a thread pool, and parallel test
    workers each spinning a full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _paper_runs(engine, policy="fifo"):
    out = []
    for C, S, kw in ((R, RS, {}), (T, TS, {"device": CPU})):
        prof = C.vgg16_profile(work_units="bytes")
        net = C.make_edge_network(num_servers=4, num_clients=4, seed=1,
                                  kappa=1 / 32.0)
        plan = C.ours(prof, net, B=64, b0=8, **kw)
        out.append(S.simulate_plan(prof, net, plan.solution, plan.b, B=64,
                                   engine=engine, policy=policy, **kw))
    return out


def _spans(cls):
    return [cls("bcd.solve", 10.0, 10.5, (("B", 64),)),
            cls("planner.solve", 10.1, 10.2, (("b", 8), ("K", None))),
            cls("sim.simulate_plan", 10.3, 10.25, ())]


@pytest.mark.parametrize("extras", [
    dict(), dict(counter_tracks=True), dict(flow_events=True),
    dict(counter_tracks=True, flow_events=True, spans=True),
    dict(time_scale=1e3, flow_events=True)])
@pytest.mark.parametrize("engine", ["event", "vectorized"])
def test_chrome_trace_equals_reference(tmp_path, engine, extras):
    extras = dict(extras)
    spans = extras.pop("spans", False)
    r, t = _paper_runs(engine)
    rp = RS.write_chrome_trace(r.records, str(tmp_path / "r" / "trace.json"),
                               wall_spans=_spans(RSpan) if spans else None,
                               **extras)
    tp = TS.write_chrome_trace(t.records, str(tmp_path / "t" / "trace.json"),
                               wall_spans=_spans(TSpan) if spans else None,
                               **extras)
    with open(rp) as f, open(tp) as g:
        want, got = json.load(f), json.load(g)
    assert got == want
    assert T_obs.validate_chrome_trace(got) == \
        R_obs.validate_chrome_trace(want) == []
    phases = {e["ph"] for e in got["traceEvents"]}
    if extras.get("flow_events"):
        assert {"s", "f"} <= phases
    if spans:
        assert T_obs.SOLVER_PID in {e["pid"] for e in got["traceEvents"]}


def test_trace_builders_equal_reference():
    r, t = _paper_runs("event", "1f1b")
    label = RS.events.resource_label
    assert T_obs.utilization_counter_events(t.records, label_of=label) == \
        R_obs.utilization_counter_events(r.records, label_of=label)
    tid_of = {res: i for i, res in enumerate(sorted(
        {x.resource for x in r.records}))}
    assert T_obs.microbatch_flow_events(t.records, tid_of) == \
        R_obs.microbatch_flow_events(r.records, tid_of)
    assert T_obs.solver_span_events(_spans(TSpan), t0=9.0) == \
        R_obs.solver_span_events(_spans(RSpan), t0=9.0)
    assert T_obs.solver_span_events([]) == []


@pytest.mark.parametrize("data", [
    [], {"traceEvents": 3}, {"traceEvents": [1, "x"]},
    {"traceEvents": [{"ph": "X", "pid": 0, "tid": "zero", "ts": 1.0,
                      "dur": -2.0, "name": "x"}]},
    {"traceEvents": [{"ph": "XY", "pid": 0, "tid": 0}]},
    {"traceEvents": [{"ph": "s", "pid": 0, "tid": 0, "ts": 0.0},
                     {"ph": "C", "pid": 0.5, "tid": 0, "name": 3}]},
    {"traceEvents": [{"ph": "M", "pid": 0, "tid": 0, "name": "n"},
                     {"ph": "X", "pid": 0, "tid": 0, "ts": 0, "dur": 1,
                      "name": "ok", "args": {}}]}])
def test_validate_chrome_trace_messages_equal_reference(data):
    assert T_obs.validate_chrome_trace(data) == \
        R_obs.validate_chrome_trace(data)


def _drive(obs_mod, span_cls):
    obs_mod.reset()
    with obs_mod.enabled_scope():
        obs_mod.inc("planner.solve_memo_hit", 3)
        obs_mod.inc("sim.engine_reason[vectorized: fifo]")
        obs_mod.inc("planner.solve_memo_hit")
        obs_mod.inc("ft.policy.decisions[absorb]", 2)
        obs_mod.get_registry().spans.extend(_spans(span_cls))
        snap = obs_mod.get_registry().snapshot()
    return snap


def test_registry_snapshot_and_dump_equal_reference(tmp_path):
    want_snap = _drive(R_obs, RSpan)
    want_path = R_obs.dump(str(tmp_path / "r" / "counters.json"))
    got_snap = _drive(T_obs, TSpan)
    got_path = T_obs.dump(str(tmp_path / "t" / "counters.json"))
    assert got_snap == want_snap
    with open(want_path) as f, open(got_path) as g:
        assert json.load(g) == json.load(f)
    snap = T_obs.get_registry().snapshot()
    T_obs.inc("planner.solve_memo_hit")      # disabled: a no-op
    assert T_obs.get_registry().snapshot() == snap
    T_obs.get_registry().reset()
    assert T_obs.get_registry().snapshot() == {} and T_obs.wall_spans() == []
    R_obs.reset()


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _np_tree(seed=0):
    """float32 / int32 leaves: the reference's jax (no x64) keeps them."""
    rng = np.random.default_rng(seed)
    return {"layers": {"w": rng.standard_normal((4, 8)).astype(np.float32),
                       "b": np.arange(8, dtype=np.float32)},
            "stages": [rng.standard_normal(3).astype(np.float32),
                       np.int32(7) * np.ones((2, 2), np.int32)],
            "step_scale": np.float32(0.5)}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _meta(path, step):
    with open(os.path.join(path, f"step_{step:08d}", "meta.json")) as f:
        meta = json.load(f)
    return {k: v for k, v in meta.items() if k not in TIMING_KEYS}, meta


def test_a_checkpoint_restores_in_the_other_package(tmp_path):
    tree = _np_tree()
    save_checkpoint(str(tmp_path / "port"), 3, _torch_tree(tree),
                    meta={"note": "x"})
    R_ckpt.save_checkpoint(str(tmp_path / "ref"), 3,
                           jax.tree.map(jax.numpy.asarray, tree),
                           meta={"note": "x"})
    with np.load(tmp_path / "port" / "step_00000003" / "arrays.npz") as p, \
            np.load(tmp_path / "ref" / "step_00000003" / "arrays.npz") as r:
        assert sorted(p.files) == sorted(r.files) == sorted(_leaves(tree))
        for k in r.files:
            assert p[k].dtype == r[k].dtype
            assert np.array_equal(p[k], r[k])
    mp, full_p = _meta(str(tmp_path / "port"), 3)
    mr, full_r = _meta(str(tmp_path / "ref"), 3)
    assert mp == mr and set(full_p) == set(full_r)
    # the reference's checkpoint restores in the port, the port's in the
    # reference
    got, meta = restore_checkpoint(str(tmp_path / "ref"), 3,
                                   _torch_tree(_np_tree(1)), device=CPU)
    assert meta["note"] == "x"
    got_leaves = _leaves(got)
    for k, v in _leaves(tree).items():
        assert got_leaves[k].dtype == v.dtype
        assert np.array_equal(got_leaves[k], v)
    back, _ = R_ckpt.restore_checkpoint(
        str(tmp_path / "port"), 3, jax.eval_shape(
            lambda: jax.tree.map(jax.numpy.asarray, tree)))
    for k, v in _leaves(tree).items():
        assert np.array_equal(np.asarray(_leaves(back)[k]), v)
    # the reference's restore-cost estimate reads the port's metadata
    assert estimate_restore_seconds(str(tmp_path / "port")) == \
        R_ckpt.estimate_restore_seconds(str(tmp_path / "port")) == \
        full_p["write_seconds"]
    assert estimate_restore_seconds(str(tmp_path / "ref"),
                                    read_bandwidth=1e6) == \
        R_ckpt.estimate_restore_seconds(str(tmp_path / "ref"),
                                        read_bandwidth=1e6) == \
        full_r["bytes"] / 1e6
    assert estimate_restore_seconds(str(tmp_path / "empty")) == 0.0


def test_restore_places_on_the_like_trees_device_and_dtype(tmp_path):
    tree = {"w": torch.randn(3, 5, dtype=torch.float64),
            "h": torch.randn(4).to(torch.bfloat16),
            "n": (torch.arange(6, dtype=torch.int64), None)}
    save_checkpoint(str(tmp_path), 1, tree)
    like = {"w": torch.zeros(3, 5, dtype=torch.float64),
            "h": torch.zeros(4, dtype=torch.bfloat16),
            "n": (torch.zeros(6, dtype=torch.int64), None)}
    got, _ = restore_checkpoint(str(tmp_path), 1, like, device=CPU)
    assert torch.equal(got["w"], tree["w"]) and torch.equal(got["h"],
                                                            tree["h"])
    assert got["h"].dtype == torch.bfloat16 and got["n"][1] is None
    assert torch.equal(got["n"][0], tree["n"][0])
    arrays, _ = restore_checkpoint(str(tmp_path), 1,
                                   {"w": np.zeros((3, 5)),
                                    "h": np.zeros(4, np.float32),
                                    "n": (np.zeros(6, np.int64), None)},
                                   device=CPU)
    assert isinstance(arrays["w"], torch.Tensor)
    assert arrays["w"].device.type == "cpu"
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), 1, {**like, "w": torch.zeros(2)},
                           device=CPU)
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(str(tmp_path), 1, {**like, "x": torch.zeros(1)},
                           device=CPU)
    # a sharded restore takes NamedShardings on a DeviceMesh (the reshard
    # itself runs in spawned ranks: tests/test_torch_spmd.py)
    with pytest.raises(TypeError, match="NamedSharding on a DeviceMesh"):
        restore_checkpoint(str(tmp_path), 1, like, shardings=object(),
                           device=CPU)
    with pytest.raises(TypeError, match=r"shardings\['h'\] is a str"):
        restore_checkpoint(str(tmp_path), 1, like,
                           shardings={"w": "data", "h": "data",
                                      "n": ("data", None)}, device=CPU)


def test_checkpoint_store_async_gc_and_restore_latest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    assert store.restore_latest({"a": torch.zeros(2)}, device=CPU) == \
        (None, None)
    for s in (1, 2, 3, 4):
        store.save(s, _torch_tree(_np_tree(s)), blocking=False)
    store.wait()
    store._gc()
    assert sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)) == \
        [3, 4]
    assert latest_step(str(tmp_path)) == 4
    assert latest_step(str(tmp_path / "none")) is None
    got, meta = store.restore_latest(_torch_tree(_np_tree()), device=CPU)
    assert meta["step"] == 4
    want = _np_tree(4)
    assert np.array_equal(got["layers"]["w"].numpy(), want["layers"]["w"])


def test_restore_cost_is_charged_on_node_failure_only(tmp_path):
    """The reference's ``test_restore_cost_callable_sources_checkpoint_
    metadata``: a ``NodeFailure`` is charged
    ``estimate_restore_seconds`` of the checkpoint, a rate change is not."""
    save_checkpoint(str(tmp_path), 1,
                    {"w": torch.ones(32, 32, dtype=torch.float32)})
    for seed in range(30):
        tp, tn, _sol, _b, B = TS.random_instance(seed)
        if len(tn.nodes) >= 4:
            break
    coord = T_ft.Coordinator(
        tp, tn, B, device=CPU,
        restore_cost=lambda: estimate_restore_seconds(str(tmp_path)))
    out = coord.apply(T_ft.NodeFailure(1))
    assert out.restore_seconds > 0.0
    assert out.restore_seconds == estimate_restore_seconds(str(tmp_path))
    assert out.log_record()["restore_seconds"] == out.restore_seconds
    assert coord.apply(T_ft.RateChange(0, 1, 0.5)).restore_seconds == 0.0
    assert coord.apply(T_ft.Straggler(1, 2.0)).restore_seconds == 0.0
