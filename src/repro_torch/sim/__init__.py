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
port's coordinator from simulated time.  Every entry point runs on
``device="cuda"`` unless given ``"cpu"``.  The fuzzer and the robustness
scores wait for ROADMAP Queue 1 item 5, Chrome-trace export for item 6.
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
]
