"""repro_torch.obs — counters, wall-clock spans and idle accounting, off
until enabled.

The port's copy of ``repro.obs``: the registry and span tracing that the
planner, the executor and the simulator call, and the per-resource
busy/blocked/fill/bubble/drain decomposition of a simulated schedule
(``utilization``).  ``repro.obs.trace`` (Chrome-trace export) waits for
ROADMAP Queue 1 item 6.
"""

from .registry import (Registry, counter, disable, enable, enabled,
                       enabled_scope, get_registry, inc, reset)
from .spans import SpanRecord, span, span_summary, wall_spans
from .utilization import (ResourceUtilization, UtilizationReport,
                          accumulate_service, busy_fractions,
                          resource_sort_key, resource_traces,
                          service_from_records, utilization_from_records,
                          utilization_from_timeline)

__all__ = [
    "Registry", "counter", "disable", "enable", "enabled", "enabled_scope",
    "get_registry", "inc", "reset",
    "SpanRecord", "span", "span_summary", "wall_spans",
    "ResourceUtilization", "UtilizationReport", "accumulate_service",
    "busy_fractions", "resource_sort_key", "resource_traces",
    "service_from_records", "utilization_from_records",
    "utilization_from_timeline",
]
