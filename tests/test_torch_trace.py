"""repro_torch.trace against repro.trace: the tracer, the Chrome export
and its schema, pred-vs-measured attribution, and the profile store.

Both packages run the same traced chain (p = 5, E = 128, three
stage-pipelined batches, alveo-u280 plan) on the same seeded inputs: the
port's spans have the reference's names, categories, tracks and args,
its counters the reference's totals exactly, and the stable
``measured:`` section is byte for byte ``tests/golden/
trace_measured_cfd_p5_alveo.txt``.  The profile store keys samples by a
machine fingerprint built from torch (``machine_fingerprint(device)``):
paired store tests pass ``fingerprint=``, ``epoch=`` and ``src=``, as the
reference's tests do, and a store written for the host never feeds a
card's plan.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro import trace as r_trace
from repro.cfd import operators as r_operators
from repro.cfd import simulation as r_simulation
from repro.memory import chain as r_chain
from repro.memory import channels as r_channels
from repro.memory import dse as r_dse
from repro_torch import trace
from repro_torch.cfd import operators
from repro_torch.cfd import simulation
from repro_torch.cfd.simulation import run_chain
from repro_torch.memory import chain as mchain
from repro_torch.memory import channels, dse
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.trace import profile as t_profile
from repro_torch.trace.attribution import (
    CAT_DISPATCH, CAT_SLOT, CAT_SYNC, COUNTER_CHANNEL_BYTES,
    COUNTER_OCCUPANCY, host_channel_bytes,
)

GOLDEN = (pathlib.Path(__file__).parent / "golden"
          / "trace_measured_cfd_p5_alveo.txt")

P, E, N_B = 5, 128, 3


@pytest.fixture(scope="module")
def cfd_chain():
    return operators.build_cfd_chain(P, device="cpu")


@pytest.fixture(scope="module")
def ref_chain():
    return r_operators.build_cfd_chain(P)


def _chain_data(chain, n, rng):
    inputs = {
        "interp.u": rng.uniform(-1, 1, (n, P, P, P)).astype(np.float32),
        "helmholtz.D": rng.uniform(-1, 1, (n, P, P, P)).astype(np.float32),
    }
    shared = {
        name: rng.uniform(-1, 1, node.shape).astype(np.float32)
        for name, node in sorted(chain.shared_operands().items())
    }
    return inputs, shared


def _plan(mod_chain, chain, target, e=E, n=N_B):
    return mod_chain.plan_chain(chain, target=target, batch_elements=e,
                                prefetch_depth=1, n_eq=e * n)


@pytest.fixture(scope="module")
def traced_run(cfd_chain):
    """One stage-pipelined 3-batch run of the port with tracing on."""
    plan = _plan(mchain, cfd_chain, channels.ALVEO_U280)
    inputs, shared = _chain_data(cfd_chain, E * N_B,
                                 np.random.default_rng(3))
    tracer = trace.Tracer()
    res = run_chain(cfd_chain, plan, inputs=inputs, shared=shared,
                    n_eq=E * N_B, max_batches=N_B, pipeline_stages=True,
                    tracer=tracer, device="cpu")
    return plan, tracer, res


@pytest.fixture(scope="module")
def ref_traced_run(ref_chain):
    """The reference's run of the same chain on the same inputs."""
    plan = _plan(r_chain, ref_chain, r_channels.ALVEO_U280)
    inputs, shared = _chain_data(ref_chain, E * N_B,
                                 np.random.default_rng(3))
    tracer = r_trace.Tracer()
    res = r_simulation.run_chain(
        ref_chain, plan, inputs=inputs, shared=shared, n_eq=E * N_B,
        max_batches=N_B, pipeline_stages=True, tracer=tracer)
    return plan, tracer, res


def _structure(tracer):
    """Everything of a trace but its times."""
    spans = [(s.name, s.cat, s.track, s.args) for s in tracer.spans]
    counters = [(c.name, c.track, c.values) for c in tracer.counters]
    return spans, counters, tracer.track_names, tracer.meta


# ---------------------------------------------------------------------------
# tracer core
# ---------------------------------------------------------------------------


def test_tracer_spans_nest_lifo():
    tr = trace.Tracer()
    outer = tr.begin("outer", "run", 0)
    inner = tr.begin("inner", "slot", 0)
    tr.end(inner)
    tr.end(outer)
    assert not outer.open and not inner.open
    assert inner.t0 >= outer.t0 and inner.t1 <= outer.t1


def test_tracer_rejects_out_of_order_end():
    tr = trace.Tracer()
    outer = tr.begin("outer", "run", 0)
    tr.begin("inner", "slot", 0)
    with pytest.raises(trace.TraceError):
        tr.end(outer)


def test_tracer_rejects_end_without_begin():
    tr = trace.Tracer()
    sp = tr.begin("a", "run", 0)
    tr.end(sp)
    with pytest.raises(trace.TraceError):
        tr.end(sp)


def test_null_tracer_is_falsy_noop():
    assert not trace.NULL
    assert not trace.NullTracer()
    with trace.NULL.span("x", "run", 0) as sp:
        assert sp is None
    trace.NULL.bump("c", {"a": 1.0})


def test_counter_totals_accumulate():
    tr = trace.Tracer()
    tr.bump("bytes", {"0": 10.0, "1": 5.0})
    tr.bump("bytes", {"0": 10.0})
    assert tr.totals("bytes") == {"0": 20.0, "1": 5.0}


# ---------------------------------------------------------------------------
# the traced chain run: schema, counters, and the reference's structure
# ---------------------------------------------------------------------------


def test_traced_chain_schema_valid(traced_run, tmp_path):
    _, tracer, _ = traced_run
    assert trace.validate(trace.to_chrome(tracer)) == []
    path = tmp_path / "trace.json"
    trace.write_chrome(tracer, str(path))
    loaded = json.loads(path.read_text())
    assert trace.validate(loaded) == []
    assert {e["ph"] for e in loaded["traceEvents"]} >= {"X", "C", "M"}
    assert tracer.open_spans() == []


def test_channel_counters_sum_exactly_to_plan(traced_run):
    plan, tracer, res = traced_run
    per_ch = tracer.totals(COUNTER_CHANNEL_BYTES)
    assert sum(per_ch.values()) == res.batches * plan.host_stream_bytes
    assert sum(host_channel_bytes(plan.buffers).values()) == (
        plan.host_stream_bytes)
    assert tracer.totals(COUNTER_OCCUPANCY) == {
        sp.name: float(sp.cu_count) for sp in plan.stages}


def test_trace_structure_equals_reference(traced_run, ref_traced_run):
    """Span names, categories, tracks and args, counter samples and
    track names in the reference's order; counter totals exactly."""
    plan, tracer, res = traced_run
    r_plan, r_tracer, r_res = ref_traced_run
    assert plan.signature == r_plan.signature
    assert _structure(tracer) == _structure(r_tracer)
    for name in (COUNTER_CHANNEL_BYTES, COUNTER_OCCUPANCY):
        assert tracer.totals(name) == r_tracer.totals(name)
    for q, v in r_res.checksums.items():
        assert res.checksums[q] == pytest.approx(v, rel=1e-4, abs=1e-3)


def test_tracer_off_is_bitwise_identical(cfd_chain):
    plan = _plan(mchain, cfd_chain, channels.ALVEO_U280, e=64, n=2)
    inputs, shared = _chain_data(cfd_chain, 128, np.random.default_rng(5))
    kw = dict(inputs=inputs, shared=shared, n_eq=128, max_batches=2,
              pipeline_stages=True, collect_outputs=True, device="cpu")
    plain = run_chain(cfd_chain, plan, **kw)
    traced = run_chain(cfd_chain, plan, tracer=trace.Tracer(), **kw)
    nulled = run_chain(cfd_chain, plan, tracer=trace.NULL, **kw)
    assert plain.checksums == traced.checksums == nulled.checksums
    for q, v in plain.outputs.items():
        assert np.array_equal(traced.outputs[q], v)


def test_run_simulation_trace_equals_reference():
    cfg = dict(p=3, n_eq=64, batch_elements=16, backend="pallas")
    got, want = trace.Tracer(), r_trace.Tracer()
    res = simulation.run_simulation(simulation.SimConfig(**cfg),
                                    max_batches=3, device="cpu", tracer=got)
    r_plan = r_simulation.plan_config(r_simulation.SimConfig(**cfg))
    ref = r_simulation.run_simulation(r_simulation.SimConfig(**cfg),
                                      max_batches=3, tracer=want,
                                      plan=r_plan)
    assert res.batches == ref.batches == 3
    assert trace.validate(trace.to_chrome(got)) == []
    s_got, c_got, names, _ = _structure(got)
    s_want, c_want, r_names, _ = _structure(want)
    assert s_got == s_want and names == r_names
    assert [c[0] for c in c_got] == [c[0] for c in c_want]
    assert sum(got.totals(COUNTER_CHANNEL_BYTES).values()) == (
        3 * res.plan.host_stream_bytes)


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------


def test_attribution_matches_span_sums(traced_run):
    plan, tracer, _ = traced_run
    a = trace.attribute(tracer, plan)
    assert a.n_batches == N_B and len(a.stages) == len(plan.stages)
    for i, s in enumerate(a.stages):
        assert s.name == plan.stages[i].name and s.slots == N_B
        disp = [sp for sp in tracer.spans
                if sp.cat == CAT_DISPATCH and int(sp.args["stage"]) == i]
        assert s.measured_s == pytest.approx(
            sum(sp.duration for sp in disp))
        assert s.measured_s > 0
    slots = [sp for sp in tracer.spans if sp.cat == CAT_SLOT]
    assert len(slots) == N_B * len(plan.stages)
    assert a.wall_s > 0 and a.pred_s_per_batch > 0


def test_attribution_report_renders(traced_run):
    plan, tracer, _ = traced_run
    rep = trace.attribution_report(tracer, plan)
    assert rep.startswith("measured:")
    for sp in plan.stages:
        assert sp.name in rep
    assert "-> ok)" in rep


def test_golden_measured_section_stable(traced_run, ref_traced_run):
    """The deterministic fields of the measured: section equal the
    reference's golden, byte for byte (and the reference's own render)."""
    plan, tracer, _ = traced_run
    rep = trace.attribution_report(tracer, plan, stable_only=True)
    assert rep + "\n" == GOLDEN.read_text()
    r_plan, r_tracer, _ = ref_traced_run
    assert rep == r_trace.attribution_report(r_tracer, r_plan,
                                             stable_only=True)


def test_compiled_report_appends_the_measured_section():
    system = operators.compile_cfd_pipeline(
        3, backends="pallas", target="cpu-host", batch_elements=16,
        n_eq=32, device="cpu")
    tracer = trace.Tracer()
    system.run(max_batches=2, tracer=tracer, device="cpu")
    rep = system.report(tracer=tracer)
    assert rep.startswith(system.report())
    assert "\nmeasured: 2 batches traced" in rep


def test_monitor_flags_become_span_annotations(cfd_chain):
    plan = _plan(mchain, cfd_chain, channels.ALVEO_U280, e=64, n=3)
    inputs, shared = _chain_data(cfd_chain, 192, np.random.default_rng(9))
    tracer = trace.Tracer()
    mon = StepMonitor(straggler_factor=0.0, warmup=0)
    res = run_chain(cfd_chain, plan, inputs=inputs, shared=shared,
                    n_eq=192, max_batches=3, pipeline_stages=True,
                    tracer=tracer, monitor=mon, device="cpu")
    assert res.straggler_batches == (1, 2)
    flagged = sorted(int(sp.args["batch"]) for sp in tracer.spans
                     if sp.cat == CAT_SYNC and sp.args.get("straggler"))
    assert flagged == [1, 2]
    assert trace.attribute(tracer, plan).straggler_batches == (1, 2)


def test_samples_from_trace_marks_device_clock_stages(traced_run):
    """Stage samples whose dispatch spans carry the card's times (the
    driver keeps the host duration as ``host_s``) are marked
    ``clock="device"``; host-clock samples are the reference's."""
    plan, tracer, _ = traced_run
    r_plan = _plan(r_chain, r_operators.build_cfd_chain(P),
                   r_channels.ALVEO_U280)
    host = trace.samples_from_trace(tracer, plan)
    want = r_trace.samples_from_trace(tracer, r_plan)
    assert host == want and all("clock" not in s for s in host)
    dev = trace.Tracer()
    dev.spans = [
        trace.SpanEvent(**{**sp.__dict__, "args": {
            **sp.args, **({"host_s": 1e-6} if sp.cat == CAT_DISPATCH
                          and sp.args["stage"] == 1 else {})}})
        for sp in tracer.spans]
    dev.counters = tracer.counters
    marked = [s.get("clock") for s in trace.samples_from_trace(dev, plan)]
    assert marked == [None, "device", None, None]


# ---------------------------------------------------------------------------
# profile store
# ---------------------------------------------------------------------------


def test_profile_store_roundtrip(traced_run, tmp_path):
    plan, tracer, _ = traced_run
    path = str(tmp_path / "profile.json")
    store = trace.ProfileStore(path=path, fingerprint="testfp")
    n = store.record_trace(tracer, plan)
    assert n == len(plan.stages) + 1
    store2 = trace.ProfileStore(path=path, fingerprint="testfp")
    assert len(store2) == n
    corr = store2.correction(plan.target.name, plan.signature)
    assert corr.n_samples == n
    assert corr.factor > 0 and corr.factor != pytest.approx(1.0)
    other = trace.ProfileStore(path=path, fingerprint="elsewhere")
    assert other.samples(plan.target.name) == []


def test_profile_store_file_equals_reference(traced_run, tmp_path):
    """The same samples recorded under the same fingerprint, epoch and
    source digest make the same file and the same correction."""
    plan, tracer, _ = traced_run
    samples = trace.samples_from_trace(tracer, plan)
    stamp = dict(fingerprint="fp", epoch="v1", src="s0")
    got = trace.ProfileStore(path=str(tmp_path / "t.json"), **stamp)
    want = r_trace.ProfileStore(path=str(tmp_path / "r.json"), **stamp)
    got.record(plan.target.name, plan.signature, samples)
    want.record(plan.target.name, plan.signature, samples)
    assert (tmp_path / "t.json").read_text() == (
        tmp_path / "r.json").read_text()
    assert dataclasses.asdict(got.correction(plan.target.name)) == (
        dataclasses.asdict(want.correction(plan.target.name)))


def test_profile_store_env_override(tmp_path, monkeypatch):
    p = str(tmp_path / "env_profile.json")
    monkeypatch.setenv(trace.PROFILE_ENV, p)
    assert trace.default_profile_path() == p
    assert trace.ProfileStore().path == p


def test_profile_store_fifo_bound(tmp_path):
    store = trace.ProfileStore(path=str(tmp_path / "p.json"),
                               fingerprint="fp")
    samples = [{"predicted_s": 1.0, "measured_s": 2.0, "bottleneck": "hbm"}
               for _ in range(t_profile.MAX_SAMPLES_PER_KEY + 50)]
    store.record("t", "sig", samples, save=False)
    assert len(store) == t_profile.MAX_SAMPLES_PER_KEY


def test_machine_fingerprint_is_per_device(monkeypatch):
    fp = trace.machine_fingerprint("cpu")
    assert fp == trace.machine_fingerprint("cpu") and len(fp) == 12
    int(fp, 16)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert trace.machine_fingerprint("cuda") != fp


def test_host_samples_never_feed_a_card_plan(tmp_path, monkeypatch):
    """A store opened on a machine with a card is keyed for the card;
    its view for the host records under the host's fingerprint, and the
    card's queries never see those samples.  An explicit fingerprint is
    kept as given."""
    monkeypatch.setattr(
        t_profile, "machine_fingerprint",
        lambda device=None: "host" if device == "cpu" else "card")
    store = trace.ProfileStore(path=str(tmp_path / "p.json"))
    assert store.fingerprint == "card"
    host = store.for_device("cpu")
    assert host.fingerprint == "host" and host.path == store.path
    host.record("h100-sxm", "sig", [
        {"predicted_s": 1.0, "measured_s": 50.0, "bottleneck": "hbm"}])
    assert store.samples("h100-sxm") == []
    assert store.correction("h100-sxm").n_samples == 0
    assert len(host.samples("h100-sxm")) == 1
    assert store.for_device(None) is store
    pinned = trace.ProfileStore(path=str(tmp_path / "p.json"),
                                fingerprint="fp")
    assert pinned.for_device("cpu") is pinned


def test_explore_chain_warm_profile_reranks(traced_run, cfd_chain,
                                            ref_chain, tmp_path):
    """trace -> store -> refit -> the DSE ranking is re-priced by the
    learned per-term corrections, as the reference's is."""
    plan, tracer, _ = traced_run
    stamp = dict(fingerprint="testfp", epoch="v1", src="s0")
    store = trace.ProfileStore(path=str(tmp_path / "t.json"), **stamp)
    r_store = r_trace.ProfileStore(path=str(tmp_path / "r.json"), **stamp)
    samples = trace.samples_from_trace(tracer, plan)
    store.record(plan.target.name, plan.signature, samples)
    r_store.record(plan.target.name, plan.signature, samples)
    space = dict(backends=("xla", "staged"), batch_divisors=(1, 2),
                 prefetch_depths=(0, 1), cu_counts=(1,), max_placements=2)
    cold = dse.explore_chain(cfd_chain, target=channels.ALVEO_U280,
                             n_eq=1 << 10,
                             space=dse.ChainDesignSpace(**space))
    warm = dse.explore_chain(cfd_chain, target=channels.ALVEO_U280,
                             n_eq=1 << 10,
                             space=dse.ChainDesignSpace(**space),
                             profile=store)
    r_warm = r_dse.explore_chain(ref_chain, target=r_channels.ALVEO_U280,
                                 n_eq=1 << 10,
                                 space=r_dse.ChainDesignSpace(**space),
                                 profile=r_store)
    assert all(c.corrected_s_per_element is None for c in cold)
    feas = [c for c in warm if c.plan.feasible]
    assert feas and all(c.corrected_s_per_element is not None for c in feas)
    assert any(c.corrected_s_per_element != c.predicted_s_per_element
               for c in feas)
    vals = [c.corrected_s_per_element for c in feas]
    assert vals == sorted(vals)
    assert [c.plan.signature for c in warm] == [
        c.plan.signature for c in r_warm]
    assert [c.corrected_s_per_element for c in warm] == pytest.approx(
        [c.corrected_s_per_element for c in r_warm], rel=1e-12)


def _contention_samples(plan, *, clock=None):
    """One sample per stage, device-bound by the model (measured far
    above the host link), optionally timed by the card's clock."""
    out = []
    for sp in plan.stages:
        c = sp.cost
        s = {"scope": f"stage:{sp.name}", "bottleneck": c.bottleneck,
             "predicted_s": c.t_pipelined,
             "measured_s": c.t_host + c.t_overhead
             + 3.0 * max(c.t_compute, c.t_hbm)}
        if clock:
            s["clock"] = clock
        out.append(s)
    return out


def test_plan_chain_profile_contention_equals_reference(
        cfd_chain, ref_chain, tmp_path):
    plan = _plan(mchain, cfd_chain, channels.ALVEO_U280)
    r_plan = _plan(r_chain, ref_chain, r_channels.ALVEO_U280)
    stamp = dict(fingerprint="fp", epoch="v1", src="s0")
    store = trace.ProfileStore(path=str(tmp_path / "t.json"), **stamp)
    r_store = r_trace.ProfileStore(path=str(tmp_path / "r.json"), **stamp)
    for st, p in ((store, plan), (r_store, r_plan)):
        st.record(p.target.name, p.signature, _contention_samples(p))
    got = mchain.plan_chain(cfd_chain, target=channels.ALVEO_U280,
                            batch_elements=E, prefetch_depth=1,
                            n_eq=E * N_B, profile=store)
    want = r_chain.plan_chain(ref_chain, target=r_channels.ALVEO_U280,
                              batch_elements=E, prefetch_depth=1,
                              n_eq=E * N_B, profile=r_store)
    assert got.cost.contention_fit and (
        got.cost.contention_fit == want.cost.contention_fit)
    assert got.report() == want.report()
    assert "contention fitted from profile" in got.report()
    fused = mchain.plan_chain(cfd_chain, target=channels.ALVEO_U280,
                              fuse="auto", profile=store)
    r_fused = r_chain.plan_chain(ref_chain, target=r_channels.ALVEO_U280,
                                 fuse="auto", profile=r_store)
    assert fused.cost.contention_fit == r_fused.cost.contention_fit


def test_fit_contention_takes_device_clock_samples_as_evidence(cfd_chain):
    """A host-bound sample says nothing about contention -- unless the
    card's own clock timed it: then it is the device term itself."""
    plan = _plan(mchain, cfd_chain, channels.ALVEO_U280)
    names = [sp.name for sp in plan.stages]
    dev = [max(sp.cost.t_compute, sp.cost.t_hbm) for sp in plan.stages]
    host_bound = [{"scope": f"stage:{n}", "measured_s": 2.5 * d}
                  for n, d in zip(names, dev)]
    assert all(sp.cost.t_host >= 2.5 * d
               for sp, d in zip(plan.stages, dev))
    assert mchain.fit_contention(plan.cost, names, host_bound) == ()
    timed = [dict(s, clock="device") for s in host_bound]
    assert mchain.fit_contention(plan.cost, names, timed) == pytest.approx(
        (2.5,) * len(names))


def test_compile_tune_blocks_deposits_the_winners(tmp_path):
    """flow.compile(tune_blocks=True, profile=...) records one ``tune``
    sample per tuned stage under the plan's signature."""
    store = trace.ProfileStore(path=str(tmp_path / "p.json"),
                               fingerprint="fp")
    system = operators.compile_cfd_pipeline(
        3, backends="pallas", target="cpu-host", batch_elements=64,
        n_eq=128, device="cpu", tune_blocks=True, profile=store)
    assert system.tuning
    entries = json.loads((tmp_path / "p.json").read_text())["entries"]
    (key, samples), = entries.items()
    assert key.startswith("fp/cpu-host/")
    assert sorted(s["name"] for s in samples) == sorted(
        f"tune:{n}" for n in system.tuning)
    for s in samples:
        tune = system.tuning[s["name"][len("tune:"):]]
        assert s["scope"] == "tune"
        assert s["block_elements"] == tune.block_elements
        assert s["measured_s"] == min(t for _, _, t in tune.candidates)


# ---------------------------------------------------------------------------
# command lines
# ---------------------------------------------------------------------------


def test_flow_cli_trace_profile_metrics(tmp_path, capsys):
    from repro_torch.flow import cli as t_cli
    from repro_torch.metrics import cli as m_cli
    from repro_torch.trace import __main__ as trace_cli

    src = pathlib.Path(__file__).parents[1] / "examples" / "cfd_pipeline.cfd"
    out = {k: str(tmp_path / f"{k}.json") for k in ("t", "m", "p")}
    assert t_cli.main([str(src), "--device", "cpu", "--backend", "pallas",
                       "--n-eq", "64", "--trace", out["t"], "--metrics",
                       out["m"], "--profile", out["p"]]) == 0
    text = capsys.readouterr().out
    assert "\nmeasured: 2 batches traced" in text
    assert "profile: recorded" in text and "metrics written to" in text
    assert trace_cli.main([out["t"]]) == 0
    assert m_cli.main([out["m"], "--check", "--trace", out["t"]]) == 0
    assert json.loads(pathlib.Path(out["p"]).read_text())["entries"]


def test_trace_cli_exit_codes(tmp_path, capsys):
    from repro_torch.trace import __main__ as trace_cli

    assert trace_cli.main([]) == 2
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": 0, "dur": 10},
        {"ph": "X", "name": "b", "pid": 1, "tid": 1, "ts": 5, "dur": 10},
    ]}))
    assert trace_cli.main([str(bad)]) == 1
    assert "partially overlaps" in capsys.readouterr().out
