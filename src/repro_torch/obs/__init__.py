"""repro_torch.obs — counters, wall-clock spans and idle accounting, off
until enabled.

The port's copy of ``repro.obs``: the registry and span tracing that the
planner, the executor and the simulator call (``dump`` writes them as
JSON), the per-resource busy/blocked/fill/bubble/drain decomposition of a
simulated schedule (``utilization``), and the Chrome-trace event builders
and schema check (``trace``) behind ``sim.write_chrome_trace``.
"""

from .registry import (Registry, counter, disable, dump, enable, enabled,
                       enabled_scope, get_registry, inc, reset)
from .spans import SpanRecord, span, span_summary, wall_spans
from .trace import (SIM_PID, SOLVER_PID, microbatch_flow_events,
                    solver_span_events, utilization_counter_events,
                    validate_chrome_trace)
from .utilization import (ResourceUtilization, UtilizationReport,
                          accumulate_service, busy_fractions,
                          resource_sort_key, resource_traces,
                          service_from_records, utilization_from_records,
                          utilization_from_timeline)

__all__ = [
    "Registry", "counter", "disable", "dump", "enable", "enabled",
    "enabled_scope", "get_registry", "inc", "reset",
    "SpanRecord", "span", "span_summary", "wall_spans",
    "SIM_PID", "SOLVER_PID", "microbatch_flow_events", "solver_span_events",
    "utilization_counter_events", "validate_chrome_trace",
    "ResourceUtilization", "UtilizationReport", "accumulate_service",
    "busy_fractions", "resource_sort_key", "resource_traces",
    "service_from_records", "utilization_from_records",
    "utilization_from_timeline",
]
