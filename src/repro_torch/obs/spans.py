"""Wall-clock span tracing: ``with span("planner.solve", b=4): ...``.

A minimal copy of ``repro/obs/spans.py``.  While telemetry is disabled
:func:`span` returns one shared no-op context manager.  A span measures
the host clock: code that enqueues GPU work synchronises inside the span
when telemetry is on (see ``pipeline.executor``), or the span ends at
enqueue time.
"""

from __future__ import annotations

import dataclasses
import time

from . import registry as _registry


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One finished wall-clock span (``perf_counter`` seconds)."""
    name: str
    start: float
    end: float
    args: tuple          # ((key, value), ...) — kwargs at the call site

    @property
    def duration(self) -> float:
        return self.end - self.start


class _NullSpan:
    """Shared do-nothing context manager returned while disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "start")

    def __init__(self, name, args):
        self.name = name
        self.args = args
        self.start = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _registry.get_registry().spans.append(
            SpanRecord(self.name, self.start, end, self.args))
        return False


def span(name: str, **args):
    """Context manager timing one named operation (no-op when disabled)."""
    if not _registry.enabled():
        return _NULL
    return _Span(name, tuple(args.items()))


def wall_spans() -> list:
    """Finished spans recorded so far (in completion order)."""
    return list(_registry.get_registry().spans)


def span_summary() -> dict:
    """Per-name ``{count, total_s}`` rollup of the finished spans."""
    out: dict = {}
    for s in _registry.get_registry().spans:
        agg = out.setdefault(s.name, {"count": 0, "total_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += s.duration
    return out
