"""Exposition: the registry as Prometheus text format or snapshot JSON.

``export_prometheus`` emits the text exposition format (version 0.0.4):
one ``# HELP`` / ``# TYPE`` header per metric name, one sample line per
series, histogram series expanded into cumulative ``_bucket{le=...}``
plus ``_sum`` / ``_count``.  Label values are escaped per the spec
(backslash, double-quote, newline) and label names are emitted in
sorted order so output is byte-stable across runs -- both properties
are pinned by tests.

``write_snapshot`` is the JSON side: the registry's :meth:`snapshot`
dict (plus any extra top-level sections, e.g. an SLO verdict) to a
file, ready for ``python -m repro_torch.metrics``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from .registry import Histogram


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_text(items) -> str:
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in items)
    return "{" + inner + "}"


def export_prometheus(registry) -> str:
    """The registry in Prometheus text exposition format."""
    lines: List[str] = []
    seen_header = set()
    for m in registry.collect():
        if m.name not in seen_header:
            seen_header.add(m.name)
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            cum = 0
            for le, c in zip(m.buckets, m.bucket_counts):
                cum += c
                items = m.labels + (("le", _fmt(le)),)
                lines.append(f"{m.name}_bucket{_labels_text(items)} {cum}")
            cum += m.bucket_counts[-1]
            items = m.labels + (("le", "+Inf"),)
            lines.append(f"{m.name}_bucket{_labels_text(items)} {cum}")
            lines.append(f"{m.name}_sum{_labels_text(m.labels)} {_fmt(m.sum)}")
            lines.append(f"{m.name}_count{_labels_text(m.labels)} {m.count}")
        else:
            lines.append(f"{m.name}{_labels_text(m.labels)} {_fmt(m.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_snapshot(registry, path: str,
                   extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Write the registry snapshot (plus ``extra`` top-level sections,
    e.g. ``{"slo": tracker.verdict()}``) as JSON; returns the dict."""
    snap = registry.snapshot()
    if extra:
        for k, v in extra.items():
            if k in snap:
                raise ValueError(f"extra section {k!r} collides with snapshot")
            snap[k] = v
    with open(path, "w") as f:
        json.dump(snap, f, indent=1, sort_keys=True)
        f.write("\n")
    return snap
