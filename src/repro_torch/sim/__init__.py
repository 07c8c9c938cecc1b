"""Discrete-event simulation of pipelined split learning — the port of
``repro.sim``'s engine.

``engine`` executes a split/placement solution — per micro-batch FP/BP
compute on each node and activation/gradient transfers on each hop, with
FIFO resource occupancy — through the heap event loop (host floats) or the
vectorized engine (max-plus prefix scans over float64 tensors on the run's
device; ``engine="auto"`` picks it wherever it covers the instance).
``policies`` supplies micro-batch admission (FIFO, 1F1B, and the
memory-budgeted windows of Eq. (11)); ``scenario`` time-varying capacity
traces, straggler windows, link outages and replan triggers; ``validate``
cross-checks the simulated T_f/T_i/L_t against Eqs. (12)-(14) and the two
engines against each other.  ``simulate_with_replanning`` drives the
port's coordinator from simulated time.  ``fuzz`` composes failure
families into seeded scenarios and replays them through both engines (the
differential oracle, with a shrinker and the shared JSON corpus);
``robustness`` scores plans by their tail across a fuzzed scenario
distribution (CVaR) and threads that score into the planner as
``RobustMakespan``.  ``events.write_chrome_trace`` exports a timeline to
Perfetto.  Every entry point runs on ``device="cuda"`` unless given
``"cpu"``.
"""

from .events import (Task, Timeline, TraceRecord, VisitTable,
                     write_chrome_trace)
from .scenario import (PiecewiseTrace, constant, piecewise, gauss_markov,
                       iid_piecewise, square_wave, NetworkScenario,
                       ReplanTrigger, piecewise_cv_scenario,
                       gauss_markov_scenario, sampled_network,
                       periodic_resync_triggers)
from .policies import (AdmissionPolicy, FIFO, OneFOneB, MemoryBudgeted,
                       resolve_policy, activation_occupancy,
                       stage_activation_highwater)
from .engine import (PipelineSimulator, SimReport, build_tasks,
                     build_visit_table, simulate_plan, simulate_plans,
                     vectorizable, SegmentReport, ReplanSimReport,
                     simulate_with_replanning)
from .validate import (CrossCheck, cross_validate, cross_validate_many,
                       compare_engines, compare_utilization,
                       random_chain_solution, random_instance,
                       random_reentrant_solution)
from .fuzz import (ALL_FAMILIES, FuzzCase, FuzzConfig, FuzzSummary,
                   ParityResult, check_parity, fuzz_case, fuzz_event_stream,
                   fuzz_scenario, fuzz_scenario_weighted, load_case,
                   load_corpus, run_fuzz, save_case, shrink_case)
from .robustness import (RobustMakespan, RobustnessReport, cvar,
                         scenario_distribution,
                         importance_scenario_distribution,
                         memory_occupancy_overflow, score_plan,
                         score_plans)

__all__ = [
    "Task", "Timeline", "TraceRecord", "VisitTable", "write_chrome_trace",
    "PiecewiseTrace", "constant", "piecewise", "gauss_markov",
    "iid_piecewise", "square_wave", "NetworkScenario", "ReplanTrigger",
    "piecewise_cv_scenario", "gauss_markov_scenario", "sampled_network",
    "periodic_resync_triggers",
    "AdmissionPolicy", "FIFO", "OneFOneB", "MemoryBudgeted", "resolve_policy",
    "activation_occupancy", "stage_activation_highwater",
    "PipelineSimulator", "SimReport", "build_tasks", "build_visit_table",
    "simulate_plan", "simulate_plans", "vectorizable",
    "SegmentReport", "ReplanSimReport", "simulate_with_replanning",
    "CrossCheck", "cross_validate", "cross_validate_many", "compare_engines",
    "compare_utilization",
    "random_chain_solution", "random_instance", "random_reentrant_solution",
    "ALL_FAMILIES", "FuzzCase", "FuzzConfig", "FuzzSummary", "ParityResult",
    "check_parity", "fuzz_case", "fuzz_event_stream", "fuzz_scenario",
    "fuzz_scenario_weighted", "load_case", "load_corpus", "run_fuzz",
    "save_case", "shrink_case",
    "RobustMakespan", "RobustnessReport", "cvar", "scenario_distribution",
    "importance_scenario_distribution", "memory_occupancy_overflow",
    "score_plan", "score_plans",
]
