"""Chrome-trace-format export: one traced run -> a Perfetto-loadable
JSON document (the ``--trace out.json`` artifact of the flow CLI).

The format is the Trace Event Format's JSON-object flavor: complete
("X") duration events for spans, cumulative ("C") counter events, and
"M" metadata events naming the process and per-stage tracks.  Times are
microseconds relative to the run's first event, so traces from different
machines diff cleanly.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

from .tracer import Tracer

#: Process id every event carries (one traced run = one logical process).
PID = 1


def to_chrome(tracer: Tracer,
              metadata: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Render a tracer's events as a Chrome-trace JSON object."""
    base = tracer.t_start
    us = lambda t: (t - base) * 1e6
    events = [
        {
            "ph": "M", "name": "process_name", "pid": PID, "tid": 0,
            "args": {"name": "repro"},
        },
    ]
    for track in sorted(
        set(tracer.track_names)
        | {s.track for s in tracer.spans}
        | {c.track for c in tracer.counters}
    ):
        events.append({
            "ph": "M", "name": "thread_name", "pid": PID, "tid": track,
            "args": {"name": tracer.track_names.get(track, f"track{track}")},
        })
        # Perfetto orders threads by sort_index, not tid
        events.append({
            "ph": "M", "name": "thread_sort_index", "pid": PID,
            "tid": track, "args": {"sort_index": track},
        })
    for s in tracer.spans:
        if s.open:
            continue  # an aborted run's dangling spans are dropped
        events.append({
            "ph": "X", "name": s.name, "cat": s.cat or "span",
            "pid": PID, "tid": s.track,
            "ts": us(s.t0), "dur": max(0.0, us(s.t1) - us(s.t0)),
            "args": dict(s.args),
        })
    for c in tracer.counters:
        events.append({
            "ph": "C", "name": c.name, "pid": PID, "tid": c.track,
            "ts": us(c.t), "args": dict(c.values),
        })
    doc: Dict[str, Any] = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
    }
    meta = dict(tracer.meta)
    if metadata:
        meta.update(metadata)
    if meta:
        doc["otherData"] = meta
    return doc


def write_chrome(tracer: Tracer, path: str,
                 metadata: Optional[Dict[str, Any]] = None) -> None:
    """Serialize :func:`to_chrome` to ``path`` (load in Perfetto or
    ``chrome://tracing``)."""
    with open(path, "w") as f:
        json.dump(to_chrome(tracer, metadata), f, indent=1)
        f.write("\n")
