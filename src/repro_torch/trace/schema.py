"""Trace-schema validation: the checks CI runs on every emitted trace
and the helpers the tests assert with.

A valid trace document is Chrome-trace JSON whose duration events nest
strictly within each (pid, tid) track: for any two events on one track,
their time intervals are either disjoint or one contains the other --
never partially overlapping.  Counter events must carry numeric series.
These are exactly the invariants ``repro_torch.trace.attribution`` relies on
when it sums per-stage span time against the plan.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

#: Interval slack in us: guards float round-off from the s -> us scaling,
#: far below any real span duration.
_EPS_US = 1e-3


def validate(doc: Any) -> List[str]:
    """Validate a Chrome-trace document; returns a list of problems
    (empty = valid)."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return [f"trace document must be a JSON object, got {type(doc).__name__}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    if not events:
        errors.append("traceEvents is empty")

    durations: Dict[Tuple[Any, Any], List[Tuple[float, float, str]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i} is not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "C", "M", "B", "E", "i", "I"):
            errors.append(f"event {i}: unknown phase {ph!r}")
            continue
        if ph == "M":
            continue
        if "pid" not in ev or "tid" not in ev:
            errors.append(f"event {i} ({ev.get('name')!r}): missing pid/tid")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < -_EPS_US:
            errors.append(
                f"event {i} ({ev.get('name')!r}): bad ts {ts!r}"
            )
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(
                    f"event {i} ({ev.get('name')!r}): bad dur {dur!r}"
                )
                continue
            if not ev.get("name"):
                errors.append(f"event {i}: X event without a name")
            durations.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ts), float(ts) + float(dur), str(ev.get("name")))
            )
        elif ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                errors.append(
                    f"event {i} ({ev.get('name')!r}): counter without "
                    "series args"
                )
            elif not all(
                isinstance(v, (int, float)) for v in args.values()
            ):
                errors.append(
                    f"event {i} ({ev.get('name')!r}): non-numeric "
                    "counter series"
                )

    for (pid, tid), ivals in durations.items():
        errors.extend(_check_nesting(pid, tid, ivals))
    return errors


def _check_nesting(
    pid: Any, tid: Any, ivals: List[Tuple[float, float, str]]
) -> List[str]:
    """Intervals on one track must strictly nest (no partial overlap).

    Sweep in start order (longer spans first on ties, so a parent is
    visited before children that start at the same timestamp); a stack
    of enclosing intervals catches any child poking past its parent.
    """
    errors: List[str] = []
    stack: List[Tuple[float, float, str]] = []
    for t0, t1, name in sorted(ivals, key=lambda iv: (iv[0], -iv[1])):
        while stack and stack[-1][1] <= t0 + _EPS_US:
            stack.pop()
        if stack and t1 > stack[-1][1] + _EPS_US:
            errors.append(
                f"track ({pid},{tid}): span {name!r} "
                f"[{t0:.3f},{t1:.3f}]us partially overlaps "
                f"{stack[-1][2]!r} [{stack[-1][0]:.3f},{stack[-1][1]:.3f}]us"
            )
            continue
        stack.append((t0, t1, name))
    return errors


def validate_file(path: str) -> List[str]:
    """Load + validate a trace JSON file (parse errors are reported,
    not raised)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"cannot load {path}: {e}"]
    return validate(doc)


def assert_valid(doc_or_tracer: Any) -> None:
    """Raise AssertionError listing every schema violation (test helper;
    accepts a Tracer, a trace dict, or a path)."""
    from .chrome import to_chrome
    from .tracer import Tracer

    if isinstance(doc_or_tracer, Tracer):
        errors = validate(to_chrome(doc_or_tracer))
    elif isinstance(doc_or_tracer, str):
        errors = validate_file(doc_or_tracer)
    else:
        errors = validate(doc_or_tracer)
    assert not errors, "invalid trace:\n" + "\n".join(errors)
