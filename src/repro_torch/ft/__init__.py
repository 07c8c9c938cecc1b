"""Fault tolerance & elasticity, ported: failure detection -> BCD re-plan
-> resume, straggler mitigation via Theorem-1 micro-batch re-solving, and
every event's network mutation routed through ``Planner.update`` (warm
replans).  The replanning policies (``repro/ft/policy.py``) and their
adaptive tuning (``repro/ft/adaptive.py``) need the simulator and wait for
its port; the coordinator runs the reference's eager default
(``policy=None``)."""

from .coordinator import (Coordinator, NodeFailure, RateChange, Straggler,
                          Resync, ReplanOutcome)

__all__ = ["Coordinator", "NodeFailure", "RateChange", "Straggler",
           "Resync", "ReplanOutcome"]
