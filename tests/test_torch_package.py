"""Package rules of the PyTorch port.

* ``src/repro_torch/`` and ``chip_smoke.py`` import neither ``jax`` nor
  anything of the reference package ``repro`` (``repro_torch`` is not
  ``repro``): a port that calls the reference cannot be checked against it.
* Entry points run on ``"cuda"`` by default and raise without a GPU unless
  the caller asks for ``"cpu"`` — they never carry on quietly on the CPU.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import obs
from repro_torch.core import (Planner, bcd_solve, exhaustive_joint,
                              make_edge_network, no_pipeline, ours,
                              uniform_profile)
from repro_torch.ft import Coordinator
from repro_torch.pipeline import SplitLearningExecutor
from repro_torch import sim
from repro_torch.sim import FIFO, MemoryBudgeted, OneFOneB, resolve_policy

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_scan_finds_every_port_module():
    names = {p.name for p in PORT_FILES}
    assert {"shortest_path.py", "planner_device.py", "coordinator.py",
            "kernel.py", "executor.py", "chip_smoke.py", "engine.py",
            "advance.py", "utilization.py", "fuzz.py", "robustness.py",
            "policy.py", "adaptive.py", "trace.py", "store.py"} <= names
    assert ROOT / "src" / "repro_torch" / "checkpoint" / "store.py" in \
        PORT_FILES


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prof = uniform_profile(4)
    net = make_edge_network(2, 2, seed=0)
    for call in (lambda: Planner(prof, net),
                 lambda: ours(prof, net, B=8),
                 lambda: no_pipeline(prof, net, B=8),
                 lambda: bcd_solve(prof, net, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    plan = ours(prof, net, B=8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SplitLearningExecutor(plan, prof, net)
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["coordinator", "solve_many_device",
                                   "exhaustive_joint_device"])
def test_replanning_entry_points_raise_without_gpu(entry, monkeypatch):
    """The coordinator and the device backend run on cuda by default: they
    raise without a GPU unless given device="cpu", and then run."""
    prof = uniform_profile(4)
    net = make_edge_network(2, 2, seed=0)
    calls = {
        "coordinator": lambda dev: Coordinator(prof, net, B=8, **dev).plan,
        "solve_many_device": lambda dev: Planner(prof, net, **dev)
        .solve_many([2, 4], 8, backend="device")[0],
        "exhaustive_joint_device": lambda dev: exhaustive_joint(
            prof, net, 8, backend="device", **dev),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]({})
    assert calls[entry]({"device": "cpu"}).feasible


def test_planner_on_another_device_is_refused():
    prof = uniform_profile(4)
    net = make_edge_network(2, 2, seed=0)
    pl = Planner(prof, net, device="cpu")
    with pytest.raises(ValueError, match="planner runs on"):
        bcd_solve(prof, net, 8, planner=pl, device="cuda")


def test_obs_is_a_no_op_until_enabled():
    obs.reset()
    with obs.span("x", a=1):
        obs.inc("c")
    assert obs.counter("c") == 0 and obs.wall_spans() == []
    with obs.enabled_scope():
        with obs.span("x", a=1):
            obs.inc("c", 2)
    assert obs.counter("c") == 2
    assert obs.span_summary()["x"]["count"] == 1
    assert not obs.enabled()
    obs.reset()


def test_admission_policies():
    """``resolve_policy("memory")`` returns the memory-budgeted policy,
    unbound: its windows need a plan (``bind``), which ``simulate_plan``
    supplies."""
    assert OneFOneB().stage_capacity(4, 8) == {0: 4, 1: 3, 2: 2, 3: 1}
    assert FIFO().stage_capacity(3, 8) == {0: 8, 1: 8, 2: 8}
    assert isinstance(resolve_policy("gpipe"), FIFO)
    pol = resolve_policy("memory")
    assert isinstance(pol, MemoryBudgeted) and not pol.bound
    assert resolve_policy("memory_budgeted").name == "memory"
    with pytest.raises(RuntimeError, match="bind"):
        pol.window(2, 0)
    with pytest.raises(ValueError, match="unknown admission policy"):
        resolve_policy("round-robin")


@pytest.mark.parametrize("entry", ["simulate_plan", "simulate_plans",
                                   "simulate_with_replanning",
                                   "cross_validate", "compare_engines",
                                   "PipelineSimulator"])
def test_simulator_entry_points_raise_without_gpu(entry, monkeypatch):
    """The simulator's entry points run on cuda by default: they raise
    without a GPU unless given device="cpu", and then run."""
    prof = uniform_profile(4)
    net = make_edge_network(2, 2, seed=0)
    sol = sim.random_chain_solution(np.random.default_rng(0), prof, net)
    calls = {
        "simulate_plan": lambda dev: sim.simulate_plan(
            prof, net, sol, 2, B=8, engine="vectorized", **dev).L_t,
        "simulate_plans": lambda dev: sim.simulate_plans(
            prof, net, [(sol, 2), (sol, 4)], B=8, **dev)[0].L_t,
        "simulate_with_replanning": lambda dev: sim.simulate_with_replanning(
            prof, net, 8, [], **dev).makespan,
        "cross_validate": lambda dev: sim.cross_validate(
            prof, net, sol, 2, 8, **dev).L_t_sim,
        "compare_engines": lambda dev: sim.compare_engines(
            prof, net, sol, 2, 4, **dev) + 1.0,
        "PipelineSimulator": lambda dev: sim.PipelineSimulator(
            net, sim.build_tasks(prof, net, sol, 2, 4), **dev).run().L_t,
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]({})
    assert calls[entry]({"device": "cpu"}) > 0


@pytest.mark.parametrize("entry", ["sim_refined", "SimMakespan",
                                   "RobustMakespan", "run_fuzz",
                                   "evaluate_policies", "tune_policies",
                                   "restore_checkpoint"])
def test_planning_and_policy_entry_points_raise_without_gpu(
        entry, monkeypatch, tmp_path):
    """The simulator-scored planners, the fuzzer, the policy harnesses and
    the checkpoint restore run on cuda by default: they raise without a
    GPU unless given device="cpu", and then run."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core import SimMakespan, sim_refined
    from repro_torch.ft import Hysteresis, evaluate_policies, tune_policies
    prof = uniform_profile(4)
    net = make_edge_network(2, 2, seed=0)
    sol = sim.random_chain_solution(np.random.default_rng(0), prof, net)
    streams = [sim.fuzz_event_stream(np.random.default_rng(s), net,
                                     horizon=1.0, max_events=2,
                                     allow_failure=False) for s in (1, 2)]
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2, 3)})
    calls = {
        "sim_refined": lambda dev: sim_refined(prof, net, 8, **dev).L_t,
        "SimMakespan": lambda dev: SimMakespan(**dev).evaluate(
            prof, net, sol, 2, 8),
        "RobustMakespan": lambda dev: sim.RobustMakespan(
            n_scenarios=2, **dev).evaluate(prof, net, sol, 2, 8),
        "run_fuzz": lambda dev: sim.run_fuzz(2, **dev).trials,
        "evaluate_policies": lambda dev: evaluate_policies(
            prof, net, 8, streams, {"h": Hysteresis}, **dev)["h"].mean,
        "tune_policies": lambda dev: tune_policies(
            prof, net, 8, streams, configs={"h": Hysteresis},
            min_streams=1, cache=False, **dev).score,
        "restore_checkpoint": lambda dev: float(restore_checkpoint(
            str(tmp_path), 1, {"w": np.zeros((2, 3), np.float32)},
            **dev)[0]["w"].sum()),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]({})
    assert calls[entry]({"device": "cpu"}) > 0


@pytest.mark.parametrize("entry", ["train", "make_train_step", "loss",
                                   "make_prefill_step", "make_decode_step",
                                   "VGGStage.init"])
def test_training_entry_points_raise_without_gpu(entry, monkeypatch):
    """The trainer, the step factories, ``ModelAPI.loss`` (through
    ``get_model``) and a VGG stage's init run on cuda by default: they
    raise without a GPU unless given device="cpu", and then run."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.train import train
    from repro_torch.models.registry import get_model
    from repro_torch.optim import get_optimizer
    from repro_torch.pipeline import VGGStage
    cfg = get_config("qwen3-0.6b", reduced=True)
    batch = {"tokens": np.zeros((2, 4), np.int32),
             "labels": np.ones((2, 4), np.int32)}

    def loss(dev):
        api = get_model(cfg, **dev)
        model = api.init(torch.Generator().manual_seed(0))
        return float(api.loss(model, batch).detach())

    calls = {
        "train": lambda dev: train("qwen3-0.6b", steps=1, batch=2, seq=4,
                                   microbatches=1, **dev)[0],
        "make_train_step": lambda dev: steps.make_train_step(
            cfg, get_optimizer("sgd"), 1, **dev) is not None,
        "loss": loss,
        "make_prefill_step": lambda dev: steps.make_prefill_step(
            cfg, 8, **dev) is not None,
        "make_decode_step": lambda dev: steps.make_decode_step(
            cfg, **dev) is not None,
        "VGGStage.init": lambda dev: len(VGGStage.init(
            14, 16, torch.Generator().manual_seed(0), **dev)),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]({})
    assert calls[entry]({"device": "cpu"}) > 0


def test_scan_finds_the_training_modules():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES if "src" in p.parts}
    assert {"launch/train.py", "launch/steps.py", "optim/optimizers.py",
            "utils/treemath.py", "configs/base.py",
            "configs/vgg16_sl.py"} <= names
