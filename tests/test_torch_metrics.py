"""repro_torch.metrics against repro.metrics: every registry, exposition,
SLO, snapshot-check and CLI property of the reference suite, run on the
port, and the same metering held byte for byte against the reference --
the Prometheus exposition and the snapshot of the same operations, and
of two serving engines (one per package) on the same requests with
fake clocks.
"""
import copy
import json

import pytest

import numpy as np

from repro import metrics as R
from repro_torch import metrics as M
from repro_torch.metrics import cli as mcli
from repro_torch.metrics.registry import _NULL_METRIC


# ---------------------------------------------------------------------------
# registry primitives
# ---------------------------------------------------------------------------

def test_counter_monotone_and_gauge_levels():
    reg = M.MetricsRegistry()
    c = reg.counter("reqs_total", "requests")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(M.MetricsError):
        c.inc(-1)
    g = reg.gauge("depth")
    g.set(4)
    g.inc()
    g.dec(2)
    assert g.value == 3


def test_registry_identity_same_object_any_label_order():
    reg = M.MetricsRegistry()
    a = reg.counter("x_total", "x", stage="s0", event="hit")
    b = reg.counter("x_total", "x", event="hit", stage="s0")
    assert a is b
    assert reg.counter("x_total", "x", event="miss") is not a
    # one name, one type -- even across label sets
    with pytest.raises(M.MetricsError):
        reg.gauge("x_total", "x", other="1")
    with pytest.raises(M.MetricsError):
        reg.histogram("x_total", "x", stage="s0", event="hit")


def test_registry_rejects_bad_names():
    reg = M.MetricsRegistry()
    with pytest.raises(M.MetricsError):
        reg.counter("bad-name")
    with pytest.raises(M.MetricsError):
        reg.counter("ok_name", "", **{"0bad": "v"})


def test_histogram_buckets_quantiles_and_window():
    h = M.Histogram(name="lat", buckets=(0.1, 1.0, 10.0), window=4)
    for x in (0.05, 0.5, 5.0, 50.0, 0.5):
        h.observe(x)
    assert h.count == 5
    assert sum(h.bucket_counts) == h.count
    assert h.bucket_counts == [1, 2, 1, 1]  # last slot: +Inf overflow
    # quantiles are nearest-rank over the *recent window* (4 here), so
    # the evicted 0.05 no longer contributes
    assert h.quantile(0.0) == 0.5
    assert h.quantile(0.95) == 50.0
    s = h.summary()
    assert s["count"] == 5.0 and s["max"] == 50.0 and s["min"] == 0.05
    with pytest.raises(M.MetricsError):
        M.Histogram(buckets=(1.0, 1.0))  # not strictly ascending


def test_bucket_ladders():
    b = M.log_buckets(1e-3, 1.0, per_decade=3)
    assert b[0] == 1e-3 and b[-1] >= 1.0
    assert list(b) == sorted(b)
    # rounded to 3 significant figures: exposition stays readable
    assert all(float(f"{x:.2e}") == x for x in b)
    assert M.linear_buckets(0.0, 1.0, 4) == (0.25, 0.5, 0.75, 1.0)


def test_null_registry_falsy_and_allocation_free():
    assert not M.NULL_REGISTRY
    assert M.NULL_REGISTRY.snapshot()["metrics"] == []
    # every factory returns THE shared null metric: no per-series alloc
    mets = [
        M.NULL_REGISTRY.counter("a_total", event="x"),
        M.NULL_REGISTRY.gauge("b"),
        M.NULL_REGISTRY.histogram("c_seconds", window=2),
    ]
    for m in mets:
        assert m is _NULL_METRIC
        assert not m
    # mutators all accept and record nothing
    m = mets[0]
    m.inc()
    m.dec()
    m.set(3.0)
    m.observe(1.0)
    assert m.value == 0.0 and m.count == 0 and m.quantile(0.95) == 0.0


# ---------------------------------------------------------------------------
# Prometheus exposition
# ---------------------------------------------------------------------------

def test_prometheus_label_escaping_and_sorted_order():
    reg = M.MetricsRegistry()
    nasty = 'a\\b"c\nd'
    # labels handed over in non-sorted order on purpose
    reg.counter("svc_total", "requests served", zone=nasty, app="x").inc(2)
    text = M.export_prometheus(reg)
    # sorted label names, escaped value: backslash, quote, newline
    assert 'svc_total{app="x",zone="a\\\\b\\"c\\nd"} 2' in text
    assert text.count("# TYPE svc_total counter") == 1
    assert "# HELP svc_total requests served" in text


def test_prometheus_one_header_per_name():
    reg = M.MetricsRegistry()
    reg.counter("ev_total", "events", kind="a").inc()
    reg.counter("ev_total", "events", kind="b").inc(3)
    text = M.export_prometheus(reg)
    assert text.count("# TYPE ev_total counter") == 1
    assert 'ev_total{kind="a"} 1' in text
    assert 'ev_total{kind="b"} 3' in text


def test_prometheus_histogram_cumulative_buckets():
    reg = M.MetricsRegistry()
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    for x in (0.05, 0.5, 5.0):
        h.observe(x)
    text = M.export_prometheus(reg)
    assert 'lat_seconds_bucket{le="0.1"} 1' in text
    assert 'lat_seconds_bucket{le="1"} 2' in text
    assert 'lat_seconds_bucket{le="+Inf"} 3' in text
    assert "lat_seconds_count 3" in text
    assert "lat_seconds_sum 5.55" in text


# ---------------------------------------------------------------------------
# snapshot checks: every violation names the failing identity
# ---------------------------------------------------------------------------

def _serving_snapshot():
    """A minimal self-consistent serving snapshot (3 requests, 2 waves
    of E=2, 1 element of wave pad)."""
    reg = M.MetricsRegistry()
    for event, n in (("submitted", 3), ("admitted", 3), ("completed", 3)):
        reg.counter("serve_requests_total", "", event=event).inc(n)
    reg.counter("serve_requests_total", "", event="failed")
    reg.counter("serve_requests_total", "", event="rejected")
    reg.gauge("serve_in_flight_requests")
    reg.counter("serve_waves_total").inc(2)
    reg.gauge("serve_batch_elements").set(2)
    reg.counter("serve_admitted_elements_total").inc(3)
    reg.counter("serve_pad_elements_total", "", kind="wave").inc(1)
    reg.counter("serve_pad_elements_total", "", kind="plan")
    for phase, xs in (("total", (1.0, 2.0, 3.0)),
                      ("queue", (0.25, 0.5, 1.0)),
                      ("execute", (0.75, 1.5, 2.0))):
        h = reg.histogram(
            "serve_request_latency_seconds", "", phase=phase)
        for x in xs:
            h.observe(x)
    return reg.snapshot()


def test_check_snapshot_accepts_consistent_serving_run():
    checked = M.check_snapshot(_serving_snapshot())
    assert "request-conservation" in checked
    assert "latency-decomposition" in checked
    assert "wave-elements" in checked


def test_structure_violation_names_series():
    snap = _serving_snapshot()
    h = next(m for m in snap["metrics"]
             if m["name"] == "serve_request_latency_seconds"
             and m["labels"] == {"phase": "total"})
    h["buckets"][0]["count"] += 1  # bucket sum no longer matches count
    with pytest.raises(M.MetricsError) as ei:
        M.check_snapshot(snap)
    assert "serve_request_latency_seconds" in str(ei.value)


def test_duplicate_identity_rejected():
    snap = _serving_snapshot()
    snap["metrics"].append(copy.deepcopy(snap["metrics"][0]))
    with pytest.raises(M.MetricsError) as ei:
        M.check_snapshot(snap)
    assert "duplicate metric identity" in str(ei.value)


def test_request_conservation_violation():
    snap = _serving_snapshot()
    sub = next(m for m in snap["metrics"]
               if m["name"] == "serve_requests_total"
               and m["labels"] == {"event": "submitted"})
    sub["value"] += 1
    with pytest.raises(M.MetricsError) as ei:
        M.check_snapshot(snap)
    assert "request conservation" in str(ei.value)


def test_latency_decomposition_violation():
    snap = _serving_snapshot()
    q = next(m for m in snap["metrics"]
             if m["name"] == "serve_request_latency_seconds"
             and m["labels"] == {"phase": "queue"})
    q["sum"] += 0.5
    with pytest.raises(M.MetricsError) as ei:
        M.check_snapshot(snap)
    assert "latency decomposition" in str(ei.value)


def test_wave_element_conservation_violation():
    snap = _serving_snapshot()
    pad = next(m for m in snap["metrics"]
               if m["name"] == "serve_pad_elements_total"
               and m["labels"] == {"kind": "wave"})
    pad["value"] += 1
    with pytest.raises(M.MetricsError) as ei:
        M.check_snapshot(snap)
    assert "wave elements" in str(ei.value)


def test_trace_reconciliation_exact():
    snap = _serving_snapshot()
    trace = {"traceEvents": [
        {"ph": "C", "name": "pad_elements", "args": {"wave": 1, "pad": 0}},
        {"ph": "C", "name": "serve_waves", "args": {"waves": 2}},
        {"ph": "C", "name": "serve_requests",
         "args": {"submitted": 3, "admitted": 3, "completed": 3}},
    ]}
    checked = M.check_snapshot(snap, trace)
    assert "trace-reconciliation" in checked
    # the C events carry cumulative totals: only the LAST one counts
    trace["traceEvents"].append(
        {"ph": "C", "name": "serve_waves", "args": {"waves": 1}}
    )
    with pytest.raises(M.MetricsError) as ei:
        M.check_snapshot(snap, trace)
    assert "serve_waves_total" in str(ei.value)


def test_diff_snapshots():
    a = _serving_snapshot()
    b = copy.deepcopy(a)
    next(m for m in b["metrics"]
         if m["name"] == "serve_waves_total")["value"] = 5
    lines = M.diff_snapshots(a, b)
    assert any("serve_waves_total" in ln and "2 -> 5" in ln
               for ln in lines)
    b["metrics"] = [m for m in b["metrics"]
                    if m["name"] != "serve_batch_elements"]
    lines = M.diff_snapshots(a, b)
    assert any(ln.startswith("- serve_batch_elements") for ln in lines)


# ---------------------------------------------------------------------------
# SLO tracking
# ---------------------------------------------------------------------------

def test_slo_validates_targets():
    with pytest.raises(M.MetricsError):
        M.SLOTracker(0.0)
    with pytest.raises(M.MetricsError):
        M.SLOTracker(1.0, target_error_rate=1.0)


def test_slo_verdict_transitions_and_gauges():
    reg = M.MetricsRegistry()
    slo = M.SLOTracker(1.0, 0.5, window=16, min_count=4, registry=reg)
    # below min_count: no judgement even on terrible latency
    slo.observe(100.0)
    assert slo.verdict()["verdict"] == "ok"
    for _ in range(8):
        slo.observe(0.1)
    v = slo.verdict()
    # 1 of 9 over target -> latency burn 1/9/0.05 > 1: still breach;
    # push the violation out of the window with more good traffic
    for _ in range(8):
        slo.observe(0.1)
    v = slo.verdict()
    assert v["verdict"] == "ok" and v["latency_burn"] == 0.0
    # sustained over-target traffic burns the 5% allowance immediately
    for _ in range(16):
        slo.observe(2.0)
    v = slo.verdict()
    assert v["verdict"] == "breach"
    assert v["latency_burn"] == pytest.approx(1.0 / 0.05)
    # the exported gauges carry the same state
    assert M.export_prometheus(reg)
    snap = {m["name"]: m for m in reg.snapshot()["metrics"]}
    assert snap["slo_verdict"]["value"] == float(M.VERDICTS.index("breach"))
    assert snap["slo_target_p95_seconds"]["value"] == 1.0


def test_slo_error_burn():
    slo = M.SLOTracker(10.0, 0.5, window=8, min_count=2)
    slo.observe(0.1, error=True)
    slo.observe(0.1)
    v = slo.verdict()
    assert v["errors"] == 1
    assert v["error_burn"] == pytest.approx((1 / 2) / 0.5)
    assert v["verdict"] == "breach"
    # a zero error budget burns infinitely on the first failure
    strict = M.SLOTracker(10.0, 0.0, window=8, min_count=1)
    strict.observe(0.1, error=True)
    assert strict.verdict()["error_burn"] == float("inf")
    assert strict.verdict()["verdict"] == "breach"


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _write(tmp_path, name, doc):
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return str(p)


def test_cli_ok_and_violation_exit_codes(tmp_path, capsys):
    good = _write(tmp_path, "good.json", _serving_snapshot())
    assert mcli.main([good, "--check"]) == 0
    out = capsys.readouterr().out
    assert "series ok" in out and "request-conservation" in out

    snap = _serving_snapshot()
    next(m for m in snap["metrics"]
         if m["name"] == "serve_requests_total"
         and m["labels"] == {"event": "submitted"})["value"] += 1
    bad = _write(tmp_path, "bad.json", snap)
    assert mcli.main([bad, "--check"]) == 1
    assert "INVARIANT VIOLATION" in capsys.readouterr().err


def test_cli_unreadable_input_exits_2(tmp_path):
    with pytest.raises(SystemExit) as ei:
        mcli.main([str(tmp_path / "nope.json")])
    assert ei.value.code == 2


def test_cli_pretty_and_diff(tmp_path, capsys):
    a = _write(tmp_path, "a.json", _serving_snapshot())
    snap = _serving_snapshot()
    next(m for m in snap["metrics"]
         if m["name"] == "serve_waves_total")["value"] = 7
    b = _write(tmp_path, "b.json", snap)
    assert mcli.main([a, "--pretty", "--diff", b]) == 0
    out = capsys.readouterr().out
    assert "serve_waves_total: 2" in out      # pretty line
    assert "~ serve_waves_total" in out       # diff line
    assert "1 series changed" in out


# ---------------------------------------------------------------------------
# held against the reference: the same metering, the same bytes
# ---------------------------------------------------------------------------

def _metered(mod):
    """The same operations on one package's registry: every series type,
    escaped labels, histogram buckets, an SLO tracker's gauges."""
    reg = mod.MetricsRegistry()
    reg.counter("svc_total", "requests served", zone='a\\b"c\nd',
                app="x").inc(2)
    reg.counter("ev_total", "events", kind="a").inc()
    reg.counter("ev_total", "events", kind="b").inc(3)
    reg.gauge("depth", "queue depth").set(4.5)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    for x in (0.05, 0.5, 5.0):
        h.observe(x)
    w = reg.histogram("win_seconds", "windowed", window=3,
                      buckets=mod.log_buckets(1e-3, 1.0, per_decade=3))
    for x in (0.002, 0.02, 0.2, 2.0):
        w.observe(x)
    slo = mod.SLOTracker(1.0, 0.5, window=8, min_count=2, registry=reg)
    for x in (0.1, 2.0, 0.3):
        slo.observe(x)
    slo.observe(0.2, error=True)
    return reg, slo


def test_exposition_and_snapshot_equal_reference():
    ref_reg, ref_slo = _metered(R)
    reg, slo = _metered(M)
    assert M.export_prometheus(reg) == R.export_prometheus(ref_reg)
    assert reg.snapshot() == ref_reg.snapshot()
    assert slo.verdict() == ref_slo.verdict()


def test_snapshot_checks_equal_reference():
    snap = _serving_snapshot()
    assert M.check_snapshot(snap) == R.check_snapshot(copy.deepcopy(snap))
    b = copy.deepcopy(snap)
    next(m for m in b["metrics"]
         if m["name"] == "serve_waves_total")["value"] = 5
    assert M.diff_snapshots(snap, b) == R.diff_snapshots(snap, b)


class _Ticks:
    """A fake clock: every read advances it by one millisecond."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def test_serving_exposition_equal_reference(monkeypatch):
    """Two engines, one per package, serve the same requests through the
    same Fig. 2 system with the same fake clocks (the engine's and the
    pipeline driver's): their Prometheus expositions are equal byte for
    byte."""
    import types

    from repro.core import dsl
    from repro.flow import build as r_build
    from repro.memory import channels as r_channels
    from repro.memory import pipeline as r_pipe
    from repro.serve import ServeEngine as RServe
    from repro_torch.flow import build as t_build
    from repro_torch.memory import pipeline as t_pipe
    from repro_torch.serve import ServeEngine as TServe

    src = dsl.INVERSE_HELMHOLTZ_SRC.format(p=3)
    kw = dict(name="m", element_vars=("u", "D", "v"), target="cpu-host",
              batch_elements=4, n_eq=8)
    rng = np.random.default_rng(3)
    reqs = [{q: rng.uniform(-1, 1, (n, 3, 3, 3)).astype(np.float32)
             for q in ("s0.u", "s3.D")} for n in (1, 3, 2, 6, 4)]
    expo = []
    for mod_pipe, build, serve, extra in (
            (r_pipe, r_build, RServe, dict(target=r_channels.CPU_HOST)),
            (t_pipe, t_build, TServe, dict(device="cpu"))):
        monkeypatch.setattr(mod_pipe, "time",
                            types.SimpleNamespace(perf_counter=_Ticks()))
        system = build.compile(src, **{**kw, **extra})
        reg = (R if serve is RServe else M).MetricsRegistry()
        eng = serve(system, seed=0, metrics=reg, clock=_Ticks(),
                    **({"device": "cpu"} if serve is TServe else {}))
        assert sorted(eng.in_specs) == sorted(reqs[0])
        for r in reqs:
            eng.submit(r)
        eng.drain()
        expo.append((R if serve is RServe else M).export_prometheus(reg))
    assert expo[1] == expo[0]
