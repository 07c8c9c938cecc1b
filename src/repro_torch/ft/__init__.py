"""Fault tolerance & elasticity, ported: failure detection -> BCD re-plan
-> resume, straggler mitigation via Theorem-1 micro-batch re-solving, every
event's network mutation routed through ``Planner.update`` (warm replans),
and pluggable replanning *policies* (debounce, rate-limiting, cadence,
tail-risk pre-spill, the self-tuning cadence and its successive-halving
tuner) deciding when the coordinator should act at all."""

from .coordinator import (Coordinator, NodeFailure, RateChange, Straggler,
                          Resync, ReplanOutcome)
from .policy import (PolicyDecision, ReplanPolicy, Eager, RideOut, Periodic,
                     Hysteresis, RateLimited, CVaRPreSpill,
                     resolve_replan_policy, event_deviation, net_deviation,
                     PolicyEvalReport, evaluate_policies)
from .adaptive import (DriftEstimator, AdaptiveCadence, TuneResult,
                       default_tuning_grid, tune_policies, network_signature,
                       clear_tune_cache)

__all__ = ["Coordinator", "NodeFailure", "RateChange", "Straggler",
           "Resync", "ReplanOutcome",
           "PolicyDecision", "ReplanPolicy", "Eager", "RideOut", "Periodic",
           "Hysteresis", "RateLimited", "CVaRPreSpill",
           "resolve_replan_policy", "event_deviation", "net_deviation",
           "PolicyEvalReport", "evaluate_policies",
           "DriftEstimator", "AdaptiveCadence", "TuneResult",
           "default_tuning_grid", "tune_policies", "network_signature",
           "clear_tune_cache"]
