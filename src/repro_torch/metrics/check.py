"""Snapshot self-consistency: the invariants a healthy engine satisfies.

A metrics snapshot is only trustworthy if it agrees with itself -- and
with the trace artifact of the same run.  This module checks both:

  * **Structural**: every series well-formed, histogram bucket counts
    summing to the series count, no duplicate (name, labels) identity.
  * **Serving conservation**: ``submitted == completed + failed +
    rejected + in_flight``; latency-histogram counts equal to the
    completed counter; phase sums (queue + execute) equal to the total
    within float tolerance; ``waves x E == admitted elements + pad``.
  * **Trace reconciliation**: the engine's pad/wave/request counters
    must agree *exactly* with the tracer's ``COUNTER_PAD_ELEMENTS`` /
    ``COUNTER_SERVE_WAVES`` / ``COUNTER_SERVE_REQUESTS`` totals from the
    same run's ``--trace`` file -- two independent instrumentation paths
    observing identical events.

Violations raise :class:`~repro_torch.metrics.registry.MetricsError` naming
the failing identity and both sides of the failed equality; CI pipes
the serve smoke's snapshot through ``python -m repro_torch.metrics --check``
and fails the build on any breach.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .registry import MetricsError

SCHEMA = "repro.metrics/v1"

_REL_EPS = 1e-9
_ABS_EPS = 1e-6

Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def index_metrics(snap: Dict[str, Any]) -> Dict[Key, Dict[str, Any]]:
    """Snapshot series by (name, sorted labels); duplicate identities
    are a structural violation."""
    if snap.get("schema") != SCHEMA:
        raise MetricsError(
            f"snapshot schema {snap.get('schema')!r} != {SCHEMA!r}"
        )
    idx: Dict[Key, Dict[str, Any]] = {}
    for m in snap.get("metrics", []):
        for field in ("name", "type", "labels"):
            if field not in m:
                raise MetricsError(f"metric missing {field!r}: {m}")
        key = (m["name"], tuple(sorted(
            (str(k), str(v)) for k, v in m["labels"].items()
        )))
        if key in idx:
            raise MetricsError(
                f"duplicate metric identity {m['name']}"
                f"{dict(key[1])}"
            )
        idx[key] = m
    return idx


def _value(idx: Dict[Key, Dict[str, Any]], name: str, **labels) -> float:
    m = idx.get((name, tuple(sorted((k, str(v)) for k, v in labels.items()))))
    return float(m["value"]) if m else 0.0


def _series(idx: Dict[Key, Dict[str, Any]], name: str) -> List[Dict[str, Any]]:
    return [m for (n, _), m in sorted(idx.items()) if n == name]


def _hist(idx: Dict[Key, Dict[str, Any]], name: str,
          **labels) -> Optional[Dict[str, Any]]:
    return idx.get(
        (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
    )


def _ident(name: str, labels: Dict[str, str]) -> str:
    return f"{name}{labels}" if labels else name


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise MetricsError(msg)


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= _ABS_EPS + _REL_EPS * max(abs(a), abs(b))


def check_structure(snap: Dict[str, Any]) -> List[str]:
    """Every series well-formed for its type; histogram bucket counts
    must sum to the series count."""
    idx = index_metrics(snap)
    for (name, labels), m in idx.items():
        ident = _ident(name, dict(labels))
        kind = m["type"]
        if kind in ("counter", "gauge"):
            _require("value" in m, f"{ident}: {kind} missing value")
            if kind == "counter":
                _require(float(m["value"]) >= 0,
                         f"{ident}: counter value {m['value']} < 0")
        elif kind == "histogram":
            for field in ("count", "sum", "buckets"):
                _require(field in m, f"{ident}: histogram missing {field!r}")
            bucket_sum = sum(int(b["count"]) for b in m["buckets"])
            _require(
                bucket_sum == int(m["count"]),
                f"{ident}: bucket counts sum to {bucket_sum}, "
                f"count is {m['count']}"
            )
            les = [b["le"] for b in m["buckets"]]
            _require(
                les and les[-1] == "+Inf",
                f"{ident}: histogram buckets must end with +Inf"
            )
        else:
            raise MetricsError(f"{ident}: unknown metric type {kind!r}")
    return ["structure"]


def check_serving(snap: Dict[str, Any]) -> List[str]:
    """The serving-layer conservation laws (no-op for snapshots from a
    run that never served -- e.g. a flow CLI batch job)."""
    idx = index_metrics(snap)
    if not _series(idx, "serve_requests_total"):
        return []
    checked = []
    req = {e: _value(idx, "serve_requests_total", event=e)
           for e in ("submitted", "completed", "failed", "rejected")}
    in_flight = _value(idx, "serve_in_flight_requests")
    finished = req["completed"] + req["failed"] + req["rejected"]
    _require(
        req["submitted"] == finished + in_flight,
        f"request conservation: submitted({req['submitted']:g}) != "
        f"completed({req['completed']:g}) + failed({req['failed']:g}) + "
        f"rejected({req['rejected']:g}) + in_flight({in_flight:g})"
    )
    checked.append("request-conservation")

    hists = {
        phase: _hist(idx, "serve_request_latency_seconds", phase=phase)
        for phase in ("total", "queue", "execute")
    }
    if any(h is not None for h in hists.values()):
        for phase, h in hists.items():
            _require(
                h is not None,
                f"serve_request_latency_seconds{{phase={phase}}} missing "
                f"while other phases are present"
            )
        _require(
            int(hists["total"]["count"]) == int(req["completed"]),
            f"serve_request_latency_seconds{{phase=total}} count"
            f"({hists['total']['count']}) != serve_requests_total"
            f"{{event=completed}}({req['completed']:g})"
        )
        for phase in ("queue", "execute"):
            _require(
                int(hists[phase]["count"]) == int(hists["total"]["count"]),
                f"serve_request_latency_seconds{{phase={phase}}} count"
                f"({hists[phase]['count']}) != phase=total count"
                f"({hists['total']['count']})"
            )
        decomposed = float(hists["queue"]["sum"]) + float(
            hists["execute"]["sum"])
        _require(
            _close(decomposed, float(hists["total"]["sum"])),
            f"latency decomposition: queue+execute sum({decomposed:g}) != "
            f"total sum({float(hists['total']['sum']):g})"
        )
        checked.append("latency-decomposition")

    waves = _value(idx, "serve_waves_total")
    e = _value(idx, "serve_batch_elements")
    if waves and e:
        admitted = _value(idx, "serve_admitted_elements_total")
        pad = _value(idx, "serve_pad_elements_total", kind="wave")
        _require(
            waves * e == admitted + pad,
            f"wave elements: waves({waves:g}) x E({e:g}) != "
            f"admitted({admitted:g}) + pad({pad:g})"
        )
        checked.append("wave-elements")
        wave_hist = _hist(idx, "admission_wave_size_elements")
        if wave_hist is not None:
            _require(
                int(wave_hist["count"]) == int(waves),
                f"admission_wave_size_elements count({wave_hist['count']}) "
                f"!= serve_waves_total({waves:g})"
            )
            flushes = sum(
                float(m["value"])
                for m in _series(idx, "admission_flush_total")
            )
            _require(
                flushes == waves,
                f"admission_flush_total over reasons({flushes:g}) != "
                f"serve_waves_total({waves:g})"
            )
            checked.append("admission-accounting")
    return checked


def trace_counter_totals(trace: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Final cumulative counter totals from an exported Chrome trace
    document (its ``C`` events carry running totals; the last sample
    per counter name is the run's sum).  Delegates to the tracer side's
    :func:`repro_torch.trace.attribution.chrome_counter_totals` -- one parser
    for the format both layers agreed on."""
    from ..trace.attribution import chrome_counter_totals  # lazy import

    return chrome_counter_totals(trace)


def check_trace_reconciliation(snap: Dict[str, Any],
                               trace: Dict[str, Any]) -> List[str]:
    """The snapshot's serve counters must agree exactly with the trace's
    cumulative counter totals from the same run."""
    idx = index_metrics(snap)
    if not _series(idx, "serve_requests_total"):
        return []
    totals = trace_counter_totals(trace)

    def t(counter: str, key: str) -> float:
        return totals.get(counter, {}).get(key, 0.0)

    pairs = [
        ("serve_pad_elements_total{kind=wave}",
         _value(idx, "serve_pad_elements_total", kind="wave"),
         "pad_elements[wave]", t("pad_elements", "wave")),
        ("serve_pad_elements_total{kind=plan}",
         _value(idx, "serve_pad_elements_total", kind="plan"),
         "pad_elements[pad]", t("pad_elements", "pad")),
        ("serve_waves_total", _value(idx, "serve_waves_total"),
         "serve_waves[waves]", t("serve_waves", "waves")),
    ]
    for event in ("submitted", "admitted", "completed", "failed", "rejected"):
        pairs.append((
            f"serve_requests_total{{event={event}}}",
            _value(idx, "serve_requests_total", event=event),
            f"serve_requests[{event}]", t("serve_requests", event),
        ))
    for m_ident, m_val, t_ident, t_val in pairs:
        _require(
            m_val == t_val,
            f"trace reconciliation: {m_ident}({m_val:g}) != "
            f"trace {t_ident}({t_val:g})"
        )
    return ["trace-reconciliation"]


def check_snapshot(snap: Dict[str, Any],
                   trace: Optional[Dict[str, Any]] = None) -> List[str]:
    """Run every applicable invariant; returns the list of checks that
    ran.  Raises :class:`MetricsError` naming the first failure."""
    checked = check_structure(snap)
    checked += check_serving(snap)
    if trace is not None:
        checked += check_trace_reconciliation(snap, trace)
    return checked


def diff_snapshots(a: Dict[str, Any], b: Dict[str, Any]) -> List[str]:
    """Human-readable per-series differences between two snapshots
    (counter/gauge value deltas, histogram count/sum deltas)."""
    ia, ib = index_metrics(a), index_metrics(b)
    lines: List[str] = []
    for key in sorted(set(ia) | set(ib)):
        name, labels = key
        ident = _ident(name, dict(labels))
        ma, mb = ia.get(key), ib.get(key)
        if ma is None:
            lines.append(f"+ {ident} (only in second)")
        elif mb is None:
            lines.append(f"- {ident} (only in first)")
        elif ma["type"] == "histogram":
            da = int(mb["count"]) - int(ma["count"])
            ds = float(mb["sum"]) - float(ma["sum"])
            if da or ds:
                lines.append(f"~ {ident}: count {ma['count']} -> "
                             f"{mb['count']} (+{da}), sum +{ds:g}")
        else:
            if float(ma["value"]) != float(mb["value"]):
                lines.append(
                    f"~ {ident}: {float(ma['value']):g} -> "
                    f"{float(mb['value']):g}"
                )
    return lines
