"""Fault tolerance & elasticity, ported: failure detection -> BCD re-plan
-> resume, straggler mitigation via Theorem-1 micro-batch re-solving, and
every event's network mutation routed through ``Planner.update`` (warm
replans).  The replanning policies (``repro/ft/policy.py``) and their
adaptive tuning (``repro/ft/adaptive.py``) wait for ROADMAP Queue 1 item 6;
the coordinator runs the reference's eager default (``policy=None``), and
``sim.simulate_with_replanning`` drives it from simulated time."""

from .coordinator import (Coordinator, NodeFailure, RateChange, Straggler,
                          Resync, ReplanOutcome)

__all__ = ["Coordinator", "NodeFailure", "RateChange", "Straggler",
           "Resync", "ReplanOutcome"]
