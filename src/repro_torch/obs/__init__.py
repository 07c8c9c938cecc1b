"""repro_torch.obs — counters and wall-clock spans, off until enabled.

The port's minimal copy of ``repro.obs``: the registry and span tracing
that the planner and the executor call.  ``repro.obs.trace`` and
``repro.obs.utilization`` are not ported yet.
"""

from .registry import (Registry, counter, disable, enable, enabled,
                       enabled_scope, get_registry, inc, reset)
from .spans import SpanRecord, span, span_summary, wall_spans

__all__ = [
    "Registry", "counter", "disable", "enable", "enabled", "enabled_scope",
    "get_registry", "inc", "reset",
    "SpanRecord", "span", "span_summary", "wall_spans",
]
