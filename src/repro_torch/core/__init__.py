"""The paper's contribution, ported: joint model splitting & placement
(Algorithm 1, on the device through the min-plus kernel), closed-form
micro-batching (Theorem 1) and their BCD combination (Algorithm 2), with
the paper's comparison schemes and its fluctuation model.
"""

from .profiles import (ModelProfile, vgg16_profile, uniform_profile,
                       random_profile, transformer_layer_flops,
                       transformer_profile, flops_summary)
from .network import (Node, EdgeNetwork, make_edge_network, shannon_rate,
                      stage_network)
from .latency import (SplitSolution, fill_latency, pipeline_interval,
                      total_latency, memory_feasible, node_memory_usage,
                      num_fills, breakdown, client_shares, client_max_share,
                      memory_split, max_feasible_microbatch)
from .msp_graph import (GraphFactory, MSPGraph, build_graph, graph_stats,
                        path_to_solution)
from .shortest_path import (DEFAULT_SOLVER, MSPResult, Planner, solve_msp,
                            brute_force_msp, enumerate_solutions, path_cost)
from .cost_model import (CostModel, ClosedForm, SimMakespan, StageClaim,
                         DegradedTail, stage_memory_claims,
                         node_budget_windows, node_budget_windows_many,
                         budget_feasible, resolve_cost_model,
                         memoized_cost_model)
from .microbatch import (MicrobatchResult, optimal_microbatch,
                         exhaustive_microbatch, feasibility_box)
from .bcd import Plan, bcd_solve, exhaustive_joint
from .baselines import (rc_op, rp_oc, no_pipeline, ours, sim_refined,
                        optimal, SCHEMES)
from .fluctuation import FluctuationReport, evaluate_under_fluctuation
from .planner import StagePlan, plan_stages, replan

__all__ = [
    "ModelProfile", "vgg16_profile", "uniform_profile", "random_profile",
    "transformer_layer_flops", "transformer_profile", "flops_summary",
    "Node", "EdgeNetwork", "make_edge_network", "shannon_rate",
    "SplitSolution", "fill_latency", "pipeline_interval", "total_latency",
    "memory_feasible", "node_memory_usage", "num_fills", "breakdown",
    "client_shares", "client_max_share", "memory_split",
    "max_feasible_microbatch", "GraphFactory", "MSPGraph", "build_graph",
    "graph_stats", "path_to_solution", "path_cost", "DEFAULT_SOLVER",
    "MSPResult", "Planner",
    "solve_msp", "brute_force_msp", "enumerate_solutions", "CostModel",
    "ClosedForm", "SimMakespan", "StageClaim", "DegradedTail",
    "stage_memory_claims", "node_budget_windows", "node_budget_windows_many",
    "budget_feasible", "resolve_cost_model", "memoized_cost_model",
    "MicrobatchResult", "optimal_microbatch", "exhaustive_microbatch",
    "feasibility_box", "Plan", "bcd_solve", "exhaustive_joint", "rc_op",
    "rp_oc", "no_pipeline", "ours", "sim_refined", "optimal", "SCHEMES",
    "FluctuationReport", "evaluate_under_fluctuation", "stage_network",
    "StagePlan", "plan_stages", "replan",
]
