"""Process-local counter/span registry — zero overhead when disabled.

The port of ``repro/obs/registry.py``: instrumented call sites go through
the module-level :func:`inc` / ``spans.span`` entry points, which cost one
global load plus a branch while telemetry is off and allocate nothing.
Counter names are dotted strings (``"planner.solve_memo_hit"``);
histogram-style tallies embed the bucket in the name
(``"sim.engine_reason[vectorized: ...]"``).  :func:`dump` writes the
counters and a per-span-name rollup as JSON.
"""

from __future__ import annotations

import contextlib
import json
import os


class Registry:
    """A process-local bag of named counters and finished spans."""

    __slots__ = ("counters", "spans")

    def __init__(self):
        self.counters: dict = {}
        self.spans: list = []

    def inc(self, name: str, n=1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def snapshot(self) -> dict:
        """A point-in-time copy of the counters."""
        return dict(self.counters)

    def reset(self) -> None:
        self.counters.clear()
        self.spans.clear()


_ENABLED = False
_REGISTRY = Registry()


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


@contextlib.contextmanager
def enabled_scope(on: bool = True):
    """Temporarily flip telemetry on (or off) around a block; yields the
    process registry.  The previous state is always restored."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = on
    try:
        yield _REGISTRY
    finally:
        _ENABLED = prev


def get_registry() -> Registry:
    return _REGISTRY


def inc(name: str, n=1) -> None:
    """Guarded hot-path increment: a global load + branch when disabled."""
    if _ENABLED:
        _REGISTRY.inc(name, n)


def counter(name: str):
    """Current value of one counter (0 when never incremented)."""
    return _REGISTRY.counters.get(name, 0)


def reset() -> None:
    """Clear all counters and recorded spans (the enabled flag is kept)."""
    _REGISTRY.reset()


def dump(path: str) -> str:
    """Write the registry (counters + per-span-name rollup) as JSON."""
    from .spans import span_summary
    counters = _REGISTRY.counters
    payload = {
        "counters": {k: counters[k] for k in sorted(counters, key=str)},
        "spans": span_summary(),
    }
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)
    return path
