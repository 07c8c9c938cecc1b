"""Chrome-trace (Perfetto) event builders and schema validation — the port of
``repro/obs/trace.py``.

``sim.events.write_chrome_trace`` composes these into one JSON file with two
processes:

* pid :data:`SIM_PID` — simulated-time pipeline tracks (one thread per
  resource; "X" slices per task, optional "C" counter tracks for
  instantaneous utilization, optional "s"/"f" flow arrows tying a
  micro-batch's forward hop to its backward hop).
* pid :data:`SOLVER_PID` — wall-clock solver tracks built from
  ``obs.span()`` records (planner/BCD/cost-model/coordinator timing).

Timestamps are microseconds (``time_scale=1e6`` from seconds), matching
chrome://tracing / https://ui.perfetto.dev conventions.  The builders are
duck-typed (records need ``.microbatch/.resource/.start/.end``; spans
need ``.name/.start/.end/.args``) so this module imports nothing from
``sim``.
"""

from __future__ import annotations


SIM_PID = 0       # simulated-time pipeline tracks
SOLVER_PID = 1    # wall-clock solver/span tracks


def utilization_counter_events(records, *, pid: int = SIM_PID,
                               time_scale: float = 1e6,
                               label_of=None) -> list:
    """Per-resource "C" counter tracks: instantaneous occupancy (0/1 for
    FIFO resources), plus a pipeline-wide active-task counter.  Perfetto
    renders these as stepped area charts — bubbles show as dips."""
    if label_of is None:
        label_of = str
    per_res: dict = {}
    for r in records:
        per_res.setdefault(r.resource, []).append((r.start, +1))
        per_res[r.resource].append((r.end, -1))
    events: list = []
    all_edges: list = []
    for res, edges in per_res.items():
        # ends (-1) before starts (+1) at equal timestamps, so
        # back-to-back tasks show 1 -> 0 -> 1 without a spurious 2
        edges.sort(key=lambda e: (e[0], e[1]))
        name = f"busy {label_of(res)}"
        level = 0
        for ts, delta in edges:
            level += delta
            events.append({"ph": "C", "name": name, "pid": pid, "tid": 0,
                           "ts": ts * time_scale, "args": {"busy": level}})
        all_edges.extend(edges)
    if all_edges:
        all_edges.sort(key=lambda e: (e[0], e[1]))
        level = 0
        for ts, delta in all_edges:
            level += delta
            events.append({"ph": "C", "name": "pipeline active tasks",
                           "pid": pid, "tid": 0, "ts": ts * time_scale,
                           "args": {"active": level}})
    return events


def microbatch_flow_events(records, tid_of: dict, *, pid: int = SIM_PID,
                           time_scale: float = 1e6) -> list:
    """Flow arrows linking each micro-batch's forward transfer on hop
    ``a -> c`` to the matching backward transfer on ``c -> a`` — the
    visual round trip of one micro-batch through the pipeline."""
    fwd: dict = {}
    bwd: dict = {}
    for r in records:
        if r.resource[0] == "fwd":
            key = (r.microbatch, r.resource[1], r.resource[2])
            fwd.setdefault(key, []).append(r)
        elif r.resource[0] == "bwd":
            key = (r.microbatch, r.resource[2], r.resource[1])
            bwd.setdefault(key, []).append(r)
    events: list = []
    fid = 0
    for key in sorted(fwd):
        outs = sorted(fwd[key], key=lambda r: r.start)
        # the backward pass retraces the route in reverse, so the i-th
        # forward crossing of a repeated link pairs with the (last-i)-th
        # backward crossing
        backs = sorted(bwd.get(key, []), key=lambda r: r.start, reverse=True)
        for f, b in zip(outs, backs):
            fid += 1
            common = {"cat": "microbatch", "name": f"mb{key[0]}",
                      "id": fid, "pid": pid}
            events.append({**common, "ph": "s", "tid": tid_of[f.resource],
                           "ts": f.start * time_scale})
            events.append({**common, "ph": "f", "bp": "e",
                           "tid": tid_of[b.resource],
                           "ts": b.start * time_scale})
    return events


def solver_span_events(spans, *, pid: int = SOLVER_PID,
                       time_scale: float = 1e6,
                       t0: float | None = None) -> list:
    """Wall-clock "X" slices from finished ``obs.span()`` records, on one
    thread so properly nested spans render as stacked slices.  Times are
    rebased so the earliest span starts at ts 0 (``perf_counter`` has an
    arbitrary epoch)."""
    spans = list(spans)
    if not spans:
        return []
    if t0 is None:
        t0 = min(s.start for s in spans)
    events = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": "solver (wall clock)"}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
         "args": {"name": "spans"}},
    ]
    for s in spans:
        events.append({
            "name": s.name, "ph": "X", "pid": pid, "tid": 0,
            "ts": (s.start - t0) * time_scale,
            "dur": max(s.end - s.start, 0.0) * time_scale,
            "args": {k: v for k, v in s.args},
        })
    return events


def validate_chrome_trace(data) -> list:
    """Check a loaded trace dict against the Chrome trace-event schema
    subset this repo emits (phase/ts/dur/pid/tid types).  Returns a list
    of problem strings — empty means valid."""
    if not isinstance(data, dict) or \
            not isinstance(data.get("traceEvents"), list):
        return ["top level must be an object with a 'traceEvents' list"]
    errs: list = []
    for i, ev in enumerate(data["traceEvents"]):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or len(ph) != 1:
            errs.append(f"event {i}: 'ph' must be a 1-char phase string")
            continue
        for field in ("pid", "tid"):
            if not isinstance(ev.get(field), int):
                errs.append(f"event {i} ({ph}): '{field}' must be an int")
        if ph != "M" and not isinstance(ev.get("ts"), (int, float)):
            errs.append(f"event {i} ({ph}): 'ts' must be a number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event {i}: X event needs a non-negative 'dur'")
        if ph in ("s", "t", "f") and "id" not in ev:
            errs.append(f"event {i}: flow event ({ph}) needs an 'id'")
        if not isinstance(ev.get("name", ""), str):
            errs.append(f"event {i} ({ph}): 'name' must be a string")
    return errs
