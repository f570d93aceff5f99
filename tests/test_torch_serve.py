"""repro_torch.serve against repro.serve: the plan cache, admission
coalescing and the serving engine, on the CPU.

Every property of the reference suite runs on the port (a repeat
compile is a cache hit that never re-plans, backpressure, drain and
shutdown semantics, one poisoned wave, profile aging, CLI validation),
and the port is held against the reference on the same inputs: equal
``cache_key`` and ``program_fingerprint`` strings, equal wave
composition and pad counts, engine outputs within the chain tests'
float32 tolerance of the reference engine's.  Coalesced waves are
bitwise equal to per-request serial runs on every backend, and the
serve CLI's ``--smoke`` prints ``bitwise ok``.
"""
import json
import os

import numpy as np
import pytest

from repro import serve as r_serve
from repro.flow import build as r_build
from repro.memory import channels as r_channels
from repro_torch import trace as trace_mod
from repro_torch.core import dsl
from repro_torch.flow import build
from repro_torch.flow import cli as flow_cli
from repro_torch.memory import channels
from repro_torch.memory.pipeline import (StagePipelineDriver,
                                         run_stage_pipelined)
from repro_torch.serve import (AdmissionQueue, Backpressure, DrainTimeout,
                               EngineShutdown, PlanCache, ServeEngine,
                               ServeRequest)
from repro_torch.trace.attribution import (COUNTER_PAD_ELEMENTS,
                                           COUNTER_PLAN_CACHE,
                                           COUNTER_SERVE_REQUESTS,
                                           COUNTER_SERVE_WAVES)

P = 3
E = 4
SRC = dsl.INVERSE_HELMHOLTZ_SRC.format(p=P)
KW = dict(
    name="serve-fig2", element_vars=("u", "D", "v"),
    target=channels.CPU_HOST, batch_elements=E, n_eq=2 * E, device="cpu",
)
#: the reference's compile call: the same knobs, its own datasheet
R_KW = dict(KW, target=r_channels.CPU_HOST)
del R_KW["device"]
#: float32 sums in other orders (the chain tests' tolerance)
RTOL, ATOL_FRAC = 5e-4, 5e-4


@pytest.fixture(scope="module")
def system():
    return build.compile(SRC, **KW)


def _requests(engine, sizes, seed=7, fill=None):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        out.append({
            q: (np.full((n,) + shape, fill, np.float32) if fill is not None
                else rng.uniform(-1, 1, (n,) + shape).astype(np.float32))
            for q, shape in sorted(engine.in_specs.items())
        })
    return out


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# plan cache: compile once, zero re-plans after the first compile
# ---------------------------------------------------------------------------

def test_plan_cache_hit_never_replans(monkeypatch):
    calls = []
    real = build.plan_chain

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(build, "plan_chain", spy)
    tracer = trace_mod.Tracer()
    cache = PlanCache(tracer=tracer)
    first = cache.get_or_compile(SRC, **KW)
    assert (cache.hits, cache.misses) == (0, 1)
    assert len(calls) == 1
    again = cache.get_or_compile(SRC, **KW)
    assert again is first
    assert (cache.hits, cache.misses) == (1, 1)
    assert cache.hit_rate == 0.5
    # the acceptance bar: ZERO re-plans after the first compile -- the
    # repeat compile AND standing up + serving an engine never plan again
    eng = ServeEngine(first, seed=0, device="cpu")
    for inp in _requests(eng, [E, 3]):
        eng.submit(inp)
    eng.drain()
    assert len(calls) == 1
    assert tracer.totals(COUNTER_PLAN_CACHE) == {"hit": 1.0, "miss": 1.0}


def test_cache_key_semantics():
    k1 = build.cache_key(SRC, **{k: v for k, v in KW.items() if k != "name"})
    # stable across calls; formatting is gone post-rewrite
    assert k1 == build.cache_key(
        "\n\n" + SRC.replace("\n", "\n\n"),
        **{k: v for k, v in KW.items() if k != "name"})
    kw2 = {k: v for k, v in KW.items() if k != "name"}
    kw2["policy"] = "float64"
    assert build.cache_key(SRC, **kw2) != k1
    kw3 = {k: v for k, v in KW.items() if k != "name"}
    kw3["batch_elements"] = 2 * E
    assert build.cache_key(SRC, **kw3) != k1
    # name= is presentation, not architecture: same key
    assert PlanCache().key(SRC, **KW) == build.cache_key(
        SRC, **{k: v for k, v in KW.items() if k != "name"})


def test_plan_cache_fifo_bound(system, monkeypatch):
    cache = PlanCache(max_systems=1)
    monkeypatch.setattr(build, "compile", lambda src, **kw: system)
    monkeypatch.setattr(PlanCache, "key", lambda self, src, **kw: src)
    cache.get_or_compile("a = 1")
    cache.get_or_compile("b = 2")
    assert len(cache) == 1
    cache.get_or_compile("b = 2")
    assert (cache.hits, cache.misses) == (1, 2)


# ---------------------------------------------------------------------------
# admission queue (pure host logic)
# ---------------------------------------------------------------------------

def _req(rid, n):
    return ServeRequest(rid=rid, inputs={}, n_elements=n)


def test_queue_coalesces_fifo_and_splits_large():
    q = AdmissionQueue(4)
    r0, r1, r2 = _req(0, 3), _req(1, 2), _req(2, 4)
    q.push(r0)
    assert not q.ready()           # 3 < E and no latency knob
    q.push(r1)
    q.push(r2)
    w1 = q.pop_wave()
    assert [(p.request.rid, p.lo, p.hi, p.dst) for p in w1.parts] == [
        (0, 0, 3, 0), (1, 0, 1, 3)]
    assert w1.pad_elements == 0
    w2 = q.pop_wave()              # r1's tail keeps FIFO order
    assert [(p.request.rid, p.lo, p.hi, p.dst) for p in w2.parts] == [
        (1, 1, 2, 0), (2, 0, 3, 1)]
    assert q.pop_wave() is None    # 1 element left: not due
    w3 = q.pop_wave(force=True)
    assert [(p.request.rid, p.lo, p.hi, p.dst) for p in w3.parts] == [
        (2, 3, 4, 0)]
    assert w3.pad_elements == 3
    assert (r0.parts, r1.parts, r2.parts) == (1, 2, 2)
    assert not q.pending_requests


def test_queue_max_wait_flushes_undersized_wave():
    clk = FakeClock()
    q = AdmissionQueue(4, max_wait_s=5.0, clock=clk)
    q.push(_req(0, 2))
    assert not q.ready()
    clk.t = 5.0
    assert q.ready()
    assert q.pop_wave().pad_elements == 2


def test_queue_remove_only_before_admission():
    q = AdmissionQueue(4)
    big = _req(0, 6)
    q.push(big)
    q.pop_wave(force=True)
    assert not q.remove(big)       # already partially admitted
    fresh = _req(1, 1)
    q.push(fresh)
    assert q.remove(fresh)
    assert q.pending_requests == [big]


# ---------------------------------------------------------------------------
# engine: coalesced == serial, bitwise
# ---------------------------------------------------------------------------

def test_coalesced_waves_bitwise_equal_serial(system):
    sizes = [3, 1, E, 2, 2 * E + 1, 1, 1, E - 1]
    coalesced = ServeEngine(system, seed=0, device="cpu")
    inputs = _requests(coalesced, sizes)
    served = [coalesced.submit(inp) for inp in inputs]
    coalesced.drain()
    assert all(r.error is None for r in served)
    total = sum(sizes)
    assert coalesced.stats["waves"] == -(-total // E)

    serial = ServeEngine(system, seed=0, device="cpu")
    for r, n, inp in zip(served, sizes, inputs):
        ref = serial.submit(inp)
        serial.drain()
        assert ref.error is None
        assert set(r.outputs) == set(coalesced.out_names)
        for q in coalesced.out_names:
            assert r.outputs[q].shape[0] == n
            assert np.array_equal(r.outputs[q], ref.outputs[q]), q


def test_engine_output_matches_direct_chain_eval(system):
    """Not just self-consistent: a request's outputs equal evaluating
    the chain's stage programs directly on its rows."""
    import torch

    eng = ServeEngine(system, seed=0, device="cpu")
    (inp,) = _requests(eng, [E])
    req = eng.submit(inp)
    eng.drain()
    chain = system.chain
    live = {}
    for i, s in enumerate(chain.stages):
        env = {}
        for name in s.program.inputs:
            if name in chain.resolved[i]:
                pi, oname = chain.resolved[i][name]
                env[name] = live[f"{chain.stages[pi].name}.{oname}"]
            elif f"{s.name}.{name}" in inp:
                env[name] = torch.from_numpy(inp[f"{s.name}.{name}"])
            else:
                env[name] = torch.from_numpy(eng.shared_host[name])
        for oname, val in s.compiled.batched_fn(env).items():
            live[f"{s.name}.{oname}"] = val
    for q in eng.out_names:
        assert np.array_equal(req.outputs[q], live[q].numpy()), q


def test_wave_pad_accounted_exactly(system):
    tracer = trace_mod.Tracer()
    eng = ServeEngine(system, tracer=tracer, seed=0, device="cpu")
    sizes = [3, E, 2]              # 9 elements -> 3 waves, 3 pad rows
    for inp in _requests(eng, sizes):
        eng.submit(inp)
    eng.drain()
    total = sum(sizes)
    waves = -(-total // E)
    pad = tracer.totals(COUNTER_PAD_ELEMENTS)
    assert pad.get("wave", 0.0) == float(waves * E - total)
    assert eng.stats["pad_elements"] == waves * E - total
    # the planner's own snap pad flows through the same counter, one
    # bump per wave, exactly batch_pad_elements each
    assert pad.get("pad", 0.0) == float(
        waves * system.plan.batch_pad_elements)
    assert eng.stats["plan_pad_elements"] == (
        waves * system.plan.batch_pad_elements)
    assert tracer.totals(COUNTER_SERVE_WAVES) == {"waves": float(waves)}
    reqs = tracer.totals(COUNTER_SERVE_REQUESTS)
    assert reqs["submitted"] == reqs["completed"] == float(len(sizes))


# ---------------------------------------------------------------------------
# backpressure, drain, shutdown semantics
# ---------------------------------------------------------------------------

def test_backpressure_blocks_at_window(system):
    eng = ServeEngine(system, window=1, seed=0, device="cpu")
    served = []
    for inp in _requests(eng, [E, E, E]):
        served.append(eng.submit(inp))
        assert len(eng._wave_parts) <= 1
    eng.drain()
    assert all(r.error is None and r.done for r in served)


def test_backpressure_rejects_at_window(system):
    eng = ServeEngine(system, window=1, reject=True, seed=0,
                      device="cpu")
    first_inp, second_inp = _requests(eng, [E, E])
    first = eng.submit(first_inp)
    with pytest.raises(Backpressure):
        eng.submit(second_inp)
    assert eng.stats["rejected"] == 1
    rejected = [r for r in (first,) if isinstance(r.error, Backpressure)]
    assert not rejected            # the *first* request was admitted
    eng.drain()
    assert first.error is None and first.done
    # the rejected request is gone from the queue, not half-admitted
    assert eng.queue.pending_requests == []
    assert eng.stats["completed"] == 1


def test_drain_budget_exhaustion_raises_with_undrained(system):
    eng = ServeEngine(system, seed=0, device="cpu")
    (inp,) = _requests(eng, [E])
    req = eng.submit(inp)
    with pytest.raises(DrainTimeout) as ei:
        eng.drain(max_ticks=1)
    assert ei.value.undrained == [req]
    assert not req.done            # NOT silently "served"
    eng.drain()                    # a real budget finishes it
    assert req.done and req.error is None


def test_shutdown_surfaces_inflight_errors(system):
    eng = ServeEngine(system, seed=0, device="cpu")
    reqs = [eng.submit(inp) for inp in _requests(eng, [E, 2])]
    leftovers = eng.shutdown()
    assert set(id(r) for r in leftovers) <= set(id(r) for r in reqs)
    assert leftovers               # something was in flight
    for r in leftovers:
        assert isinstance(r.error, EngineShutdown) and r.done
    with pytest.raises(RuntimeError):
        eng.submit(_requests(eng, [1])[0])


def test_stage_error_poisons_only_its_wave(system):
    eng = ServeEngine(system, seed=0, device="cpu")
    q0 = sorted(eng.in_specs)[0]
    orig = eng.driver.stage_fns[0]

    def boom(staged, carry):
        if float(staged.arrays()[q0].ravel()[0]) == 777.0:
            raise RuntimeError("injected stage failure")
        return orig(staged, carry)

    eng.driver.stage_fns[0] = boom
    good1_inp, bad_inp, good2_inp = (
        _requests(eng, [E])[0],
        _requests(eng, [E], fill=777.0)[0],
        _requests(eng, [E], seed=11)[0],
    )
    good1 = eng.submit(good1_inp)
    bad = eng.submit(bad_inp)
    good2 = eng.submit(good2_inp)
    eng.drain()                    # the ring never wedges
    assert good1.error is None and good1.outputs is not None
    assert good2.error is None and good2.outputs is not None
    assert isinstance(bad.error, RuntimeError)
    assert "injected stage failure" in str(bad.error)
    assert eng.stats["failed"] == 1 and eng.stats["completed"] == 2


def test_max_wait_knob_flushes_partial_wave(system):
    clk = FakeClock()
    eng = ServeEngine(system, max_wait_s=5.0, seed=0, clock=clk,
                      device="cpu")
    (inp,) = _requests(eng, [2])
    req = eng.submit(inp)
    for _ in range(4):
        eng.poll()
    assert eng.stats["waves"] == 0         # undersized, still young
    clk.t = 6.0
    eng.poll()
    assert eng.stats["waves"] == 1         # latency knob flushed it
    eng.drain()
    assert req.done and req.error is None
    assert req.outputs[eng.out_names[0]].shape[0] == 2


def test_submit_validates_request_shape(system):
    eng = ServeEngine(system, seed=0, device="cpu")
    (inp,) = _requests(eng, [2])
    with pytest.raises(ValueError):
        eng.submit({})                      # missing streams
    bad = dict(inp)
    q0 = sorted(eng.in_specs)[0]
    bad[q0] = bad[q0][:, :-1]               # wrong row shape
    with pytest.raises(ValueError):
        eng.submit(bad)


# ---------------------------------------------------------------------------
# driver: resume across feeds (the serve engine's contract)
# ---------------------------------------------------------------------------

def _arith_stages():
    def s0(staged, carry):
        return staged * 1.0

    def s1(staged, carry):
        return carry * 3.0

    return [s0, s1]


def test_driver_incremental_feed_matches_batch_run():
    want = run_stage_pipelined(
        _arith_stages(), [float(x) for x in range(6)], depths=[2, 1]
    )
    drv = StagePipelineDriver(_arith_stages(), depths=[2, 1])
    fed = 0
    # feed two, let the ring go COMPLETELY idle, then resume with four
    for _ in range(2):
        drv.feed(float(fed))
        fed += 1
    for _ in range(30):
        drv.tick()
    assert drv.idle and drv.in_flight == 2  # delivered, waiting in take()
    for _ in range(4):
        assert drv.wants_input or drv.tick() or True
        drv.feed(float(fed))
        fed += 1
    drv.close()
    while not drv.idle:
        drv.tick()
    got = drv.take()
    assert [k for k, _ in got] == list(range(6))
    assert [v for _, v in got] == want


def test_driver_capture_errors_poisons_and_delivers():
    def s0(staged, carry):
        if staged == 2.0:
            raise ValueError("bad batch")
        return staged * 3.0

    drv = StagePipelineDriver([s0], depths=[1], capture_errors=True)
    for x in range(4):
        drv.feed(float(x))
    drv.close()
    while not drv.idle:
        drv.tick()
    got = dict(drv.take())
    assert got[0] == 0.0 and got[1] == 3.0 and got[3] == 9.0
    assert isinstance(got[2], ValueError)


# ---------------------------------------------------------------------------
# satellites: profile epoch aging, DSE profile threading, CLI validation
# ---------------------------------------------------------------------------

def test_profile_epoch_aging_on_cost_model_bump(tmp_path, monkeypatch):
    from repro_torch.memory import dse
    from repro_torch.trace.profile import ProfileStore

    p = str(tmp_path / "prof.json")
    store = ProfileStore(path=p, fingerprint="fp")
    assert store.epoch == f"v{dse.COST_MODEL_VERSION}"
    n = store.record("tgt", "sig", [
        {"predicted_s": 1.0, "measured_s": 2.0, "bottleneck": "hbm"}])
    assert n == 1 and len(store.samples("tgt", "sig")) == 1
    assert store.correction("tgt", "sig").factor == pytest.approx(2.0)

    # cost model changes -> old (predicted, measured) ratios are ratios
    # against the WRONG predictions; the refit must not see them
    monkeypatch.setattr(dse, "COST_MODEL_VERSION", dse.COST_MODEL_VERSION + 1)
    bumped = ProfileStore(path=p, fingerprint="fp")
    assert bumped.epoch != store.epoch
    assert bumped.samples("tgt", "sig") == []
    corr = bumped.correction("tgt", "sig")
    assert corr.factor == 1.0 and corr.n_samples == 0
    # recording post-bump prunes the stale bucket in the file
    bumped.record("tgt", "sig", [
        {"predicted_s": 1.0, "measured_s": 3.0, "bottleneck": "hbm"}])
    assert [s["measured_s"] for s in bumped.samples("tgt", "sig")] == [3.0]
    on_disk = json.load(open(p))["entries"]["fp/tgt/sig"]
    assert len(on_disk) == 1 and on_disk[0]["epoch"] == bumped.epoch


def test_profile_pre_epoch_store_loads_gracefully(tmp_path):
    from repro_torch.trace.profile import ProfileStore

    p = str(tmp_path / "old.json")
    with open(p, "w") as f:        # a store written before epochs existed
        json.dump({"version": 1, "entries": {"fp/tgt/sig": [
            {"predicted_s": 1.0, "measured_s": 9.0, "bottleneck": "hbm",
             "scope": "chain"}]}}, f)
    store = ProfileStore(path=p, fingerprint="fp")
    assert store.samples("tgt", "sig") == []
    assert store.correction("tgt", "sig").factor == 1.0
    assert store.record("tgt", "sig", [
        {"predicted_s": 1.0, "measured_s": 2.0, "bottleneck": "hbm"}]) == 1
    assert len(store.samples("tgt", "sig")) == 1


def test_compile_threads_profile_into_dse(tmp_path, monkeypatch):
    from repro_torch.memory import dse as dse_mod
    from repro_torch.trace.profile import ProfileStore

    store = ProfileStore(path=str(tmp_path / "p.json"), fingerprint="fp")
    seen = {}
    real = dse_mod.explore_chain

    def spy(*a, **kw):
        seen["profile"] = kw.get("profile")
        return real(*a, **kw)

    monkeypatch.setattr(dse_mod, "explore_chain", spy)
    system = build.compile(SRC, dse=True, profile=store, **KW)
    assert seen["profile"] is store
    assert system.plan.feasible


def test_profile_src_digest_aging_on_planner_edit(tmp_path):
    """A planner-source change under an unchanged COST_MODEL_VERSION
    still ages out old samples: the src stamp gates code drift, not
    just declared epochs."""
    from repro_torch.trace.profile import ProfileStore, plan_code_digest

    p = str(tmp_path / "prof.json")
    store = ProfileStore(path=p, fingerprint="fp")
    assert store.src == plan_code_digest()
    store.record("tgt", "sig", [
        {"predicted_s": 1.0, "measured_s": 2.0, "bottleneck": "hbm"}])
    assert len(store.samples("tgt", "sig")) == 1
    on_disk = json.load(open(p))["entries"]["fp/tgt/sig"]
    assert on_disk[0]["src"] == store.src

    # same epoch, different planner source -> the old ratios measured a
    # different planner; the refit must not see them
    edited = ProfileStore(path=p, fingerprint="fp", src="feedbeefcafe")
    assert edited.epoch == store.epoch
    assert edited.samples("tgt", "sig") == []
    assert edited.correction("tgt", "sig").n_samples == 0
    # recording post-edit prunes the stale bucket in the file
    edited.record("tgt", "sig", [
        {"predicted_s": 1.0, "measured_s": 4.0, "bottleneck": "hbm"}])
    on_disk = json.load(open(p))["entries"]["fp/tgt/sig"]
    assert len(on_disk) == 1 and on_disk[0]["src"] == "feedbeefcafe"


def test_profile_src_unstamped_samples_tolerated(tmp_path):
    """Samples recorded before the src stamp existed (right epoch, no
    src key) still surface: the digest gates drift, it does not orphan
    pre-stamp history."""
    from repro_torch.trace.profile import ProfileStore, cost_model_epoch

    p = str(tmp_path / "old.json")
    with open(p, "w") as f:
        json.dump({"version": 1, "entries": {"fp/tgt/sig": [
            {"predicted_s": 1.0, "measured_s": 2.0, "bottleneck": "hbm",
             "epoch": cost_model_epoch()}]}}, f)
    store = ProfileStore(path=p, fingerprint="fp")
    assert len(store.samples("tgt", "sig")) == 1
    assert store.correction("tgt", "sig").factor == pytest.approx(2.0)


def test_plan_cache_warm_hit_picks_up_profile_refit(tmp_path, monkeypatch):
    """profile= threads through warm hits: the cache key excludes it,
    so a hit must re-apply the store's *current* correction -- feedback
    recorded after the original compile reaches the next compile."""
    from repro_torch.memory import dse as dse_mod
    from repro_torch.trace.profile import ProfileStore

    store = ProfileStore(path=str(tmp_path / "p.json"), fingerprint="fp")
    cache = PlanCache()
    kw = dict(KW, dse=True, profile=store)
    first = cache.get_or_compile(SRC, **kw)
    assert cache.misses == 1 and first.candidates

    # feedback lands in the store between the two compiles
    store.record(first.target.name, first.plan.signature, [
        {"predicted_s": 1.0, "measured_s": 3.0, "bottleneck": "hbm"}])

    applied = {}
    real = dse_mod.apply_correction

    def spy(cands, corr):
        applied["corr"] = corr
        return real(cands, corr)

    monkeypatch.setattr(dse_mod, "apply_correction", spy)
    again = cache.get_or_compile(SRC, **kw)
    assert (cache.hits, cache.misses) == (1, 1)  # profile= not in the key
    assert again is first
    assert applied["corr"].n_samples >= 1       # refit reached the hit
    assert all(
        c.corrected_s_per_element is not None for c in again.candidates
    )
    # without a profile the hit path stays untouched
    cold = PlanCache()
    kw2 = dict(KW, dse=True)
    one = cold.get_or_compile(SRC, **kw2)
    applied.clear()
    assert cold.get_or_compile(SRC, **kw2) is one
    assert not applied


def test_flow_cli_profile_requires_trace_or_dse(tmp_path, capsys):
    src = tmp_path / "p.cfd"
    src.write_text(SRC)
    rc = flow_cli.main([str(src), "--element-vars", "u,D,v",
                        "--target", "cpu-host", "--profile"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "--profile" in err and "--trace" in err and "--dse" in err


def test_flow_cli_per_stage_prefetch_vector(tmp_path, capsys, system):
    n_stages = len(system.plan.stages)
    src = tmp_path / "p.cfd"
    src.write_text(SRC)
    vec = ",".join(["1"] * n_stages)
    rc = flow_cli.main([
        str(src), "--element-vars", "u,D,v", "--target", "cpu-host",
        "--batch-elements", str(E), "--n-eq", str(2 * E),
        "--prefetch-depth", vec,
    ])
    assert rc == 0
    assert "pipeline:" in capsys.readouterr().out
    rc = flow_cli.main([str(src), "--prefetch-depth", "1,x"])
    assert rc == 2
    assert "--prefetch-depth" in capsys.readouterr().err


def test_serve_cli_smoke(tmp_path, capsys):
    from repro_torch.serve import cli as serve_cli

    src = tmp_path / "p.cfd"
    src.write_text(SRC)
    trace_out = str(tmp_path / "serve.json")
    rc = serve_cli.main([
        str(src), "--element-vars", "u,D,v", "--target", "cpu-host",
        "--requests", "5", "--batch-elements", str(E),
        "--n-eq", str(2 * E), "--smoke", "--trace", trace_out,
        "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "plan_cache: hits=1 misses=1" in out
    assert "bitwise ok" in out
    assert os.path.exists(trace_out)
    doc = json.load(open(trace_out))
    assert doc["traceEvents"]


# ---------------------------------------------------------------------------
# always-on metrics: metering changes nothing, and the snapshot holds
# ---------------------------------------------------------------------------

def test_metered_engine_bitwise_identical_to_unmetered(system):
    from repro_torch import metrics as metrics_mod

    reg = metrics_mod.MetricsRegistry()
    slo = metrics_mod.SLOTracker(5.0, registry=reg)
    metered = ServeEngine(system, seed=0, metrics=reg, slo=slo,
                          device="cpu")
    plain = ServeEngine(system, seed=0, device="cpu")
    sizes = [1, 3, 2, 6, 4]
    inputs = _requests(metered, sizes)
    got = [metered.submit(inp) for inp in inputs]
    metered.drain()
    want = [plain.submit(inp) for inp in inputs]
    plain.drain()
    for g, w in zip(got, want):
        assert g.error is None and w.error is None
        for q in metered.out_names:
            np.testing.assert_array_equal(g.outputs[q], w.outputs[q])
    # and the two engines agree on every serving stat
    assert metered.stats == plain.stats

    # the live snapshot satisfies every serving invariant
    snap = reg.snapshot()
    checked = metrics_mod.check_snapshot(snap)
    assert "request-conservation" in checked
    assert "latency-decomposition" in checked
    assert "wave-elements" in checked
    assert "admission-accounting" in checked
    # SLO saw every finished request
    v = slo.verdict()
    assert v["count"] == len(sizes)
    assert v["verdict"] == "ok"  # synthetic runs are well under 5 s


def test_metered_engine_reconciles_with_trace(system):
    from repro_torch import metrics as metrics_mod
    from repro_torch.trace.chrome import to_chrome

    reg = metrics_mod.MetricsRegistry()
    tracer = trace_mod.Tracer()
    eng = ServeEngine(system, seed=0, metrics=reg, tracer=tracer,
                      device="cpu")
    for inp in _requests(eng, [3, E, 2]):
        eng.submit(inp)
    eng.drain()
    doc = to_chrome(tracer)
    checked = metrics_mod.check_snapshot(reg.snapshot(), doc)
    assert "trace-reconciliation" in checked


def test_queue_metrics_wait_age_and_flush_reasons():
    from repro_torch import metrics as metrics_mod

    reg = metrics_mod.MetricsRegistry()
    clk = FakeClock()
    q = AdmissionQueue(4, max_wait_s=5.0, clock=clk, metrics=reg)
    q.push(_req(0, 4))
    assert q.pop_wave() is not None        # full wave at t=0
    q.push(_req(1, 2))
    clk.t = 6.0
    assert q.pop_wave() is not None        # expired undersized wave
    q.push(_req(2, 1))
    assert q.pop_wave(force=True) is not None
    idx = {(m["name"], tuple(sorted(m["labels"].items()))): m
           for m in reg.snapshot()["metrics"]}
    flush = {lbl[0][1]: m["value"] for (n, lbl), m in idx.items()
             if n == "admission_flush_total"}
    assert flush == {"full": 1.0, "max_wait": 1.0, "force": 1.0}
    wait = idx[("admission_wait_age_seconds", ())]
    assert wait["count"] == 3 and wait["max"] == 6.0
    fill = idx[("admission_wave_fill_ratio", ())]
    assert fill["count"] == 3
    assert fill["sum"] == pytest.approx(1.0 + 0.5 + 0.25)


# ---------------------------------------------------------------------------
# held against the reference
# ---------------------------------------------------------------------------

def _knobs(kw):
    return {k: v for k, v in kw.items() if k != "name"}


@pytest.mark.parametrize("src,kw", [
    (SRC, {}),
    (SRC, dict(policy="float64")),
    (SRC, dict(batch_elements=2 * E, prefetch_depth=[1, 2])),
    (SRC, dict(devices="cpu:2,tpu:4", dse=True)),
    ("\n\n" + SRC.replace("\n", "\n\n"), dict(fuse="auto")),
], ids=["default", "float64", "knobs", "topology", "reformatted"])
def test_cache_key_equals_reference(src, kw):
    """The same source and knobs key the same plan-cache entry in both
    packages: the post-rewrite program's fingerprint, the target, the
    policy, the topology and the knob digest."""
    got = build.cache_key(src, **_knobs({**KW, **kw}))
    want = r_build.cache_key(src, **_knobs({**R_KW, **kw}))
    # the port's device knob is part of its digest (a host-compiled
    # system never answers a card's compile call); without it, equal
    no_dev = {k: v for k, v in _knobs({**KW, **kw}).items() if k != "device"}
    assert build.cache_key(src, **no_dev) == want
    assert got.split("/")[:4] == want.split("/")[:4]
    assert got != want


def test_program_fingerprint_equals_reference():
    from repro.core import dsl as r_dsl
    from repro.core import rewrite as r_rewrite
    from repro_torch.cfd import operators as t_ops
    from repro_torch.core import rewrite

    for src in (SRC, t_ops.CFD_PIPELINE_SRC.format(p=5)):
        kw = {} if "elem" in src else dict(element_vars=("u", "D", "v"))
        got = build.program_fingerprint(
            rewrite.optimize(dsl.parse(src, **kw)))
        want = r_build.program_fingerprint(
            r_rewrite.optimize(r_dsl.parse(src, **kw)))
        assert got == want
    assert build.topology_fingerprint("cpu:2,tpu:4") == (
        r_build.topology_fingerprint("cpu:2,tpu:4"))
    assert build.topology_fingerprint(3) == r_build.topology_fingerprint(3)
    assert build.topology_fingerprint(None) == "auto"


def _wave_plan(queue_mod, sizes, e, flush_at=()):
    q = queue_mod.AdmissionQueue(e)
    waves = []
    for rid, n in enumerate(sizes):
        q.push(queue_mod.ServeRequest(rid=rid, inputs={}, n_elements=n))
        while q.ready(force=rid in flush_at):
            w = q.pop_wave(force=rid in flush_at)
            waves.append(([(p.request.rid, p.lo, p.hi, p.dst)
                           for p in w.parts], w.pad_elements))
    while q.ready(force=True):
        w = q.pop_wave(force=True)
        waves.append(([(p.request.rid, p.lo, p.hi, p.dst)
                       for p in w.parts], w.pad_elements))
    return waves


def test_queue_waves_equal_reference():
    from repro.serve import queue as r_queue
    from repro_torch.serve import queue as t_queue

    sizes = np.random.default_rng(4).integers(1, 40, 60).tolist()
    for e, flush in ((16, ()), (7, (5, 17, 33)), (64, (59,))):
        got = _wave_plan(t_queue, sizes, e, flush)
        assert got == _wave_plan(r_queue, sizes, e, flush)
        assert sum(p for _, p in got) == len(got) * e - sum(sizes)


@pytest.fixture(scope="module")
def ref_system():
    return r_build.compile(SRC, **R_KW)


def test_engine_equals_reference_engine(system, ref_system):
    """Both engines serve the same requests: the same waves, pads and
    stats, and outputs within float32 tolerance of each other."""
    sizes = [3, 1, E, 2, 2 * E + 1, 1, 1, E - 1, 5]
    eng = ServeEngine(system, seed=0, device="cpu")
    ref = r_serve.ServeEngine(ref_system, seed=0)
    assert eng.in_specs == ref.in_specs and eng.out_names == ref.out_names
    for name, h in ref.shared_host.items():
        assert np.array_equal(eng.shared_host[name], h)
    inputs = _requests(eng, sizes)
    got = [eng.submit(inp) for inp in inputs]
    want = [ref.submit(inp) for inp in inputs]
    eng.drain()
    ref.drain()
    assert eng.stats == ref.stats
    for g, w in zip(got, want):
        assert g.error is None and w.error is None
        for q in eng.out_names:
            np.testing.assert_allclose(
                g.outputs[q], w.outputs[q], rtol=RTOL,
                atol=ATOL_FRAC * np.abs(w.outputs[q]).max())


@pytest.mark.parametrize("backends", [
    ("xla",) * 3, ("staged",) * 3, ("pallas",) * 3, ("pallas", "xla", "staged"),
], ids=["xla", "staged", "pallas", "mixed"])
def test_cfd_chain_coalesced_bitwise_equal_serial(backends):
    """The CFD chain served on every backend: coalesced waves, serial
    per-request runs and run_chain over the same rows agree bit for bit."""
    from repro_torch.cfd import operators as t_ops

    e = 8
    system = t_ops.compile_cfd_pipeline(
        3, backends=backends, target="cpu-host", batch_elements=e,
        n_eq=2 * e, device="cpu")
    sizes = [5, 1, e + 3, 2, 7]
    coalesced = ServeEngine(system, seed=0, device="cpu")
    inputs = _requests(coalesced, sizes)
    served = [coalesced.submit(inp) for inp in inputs]
    coalesced.drain()
    serial = ServeEngine(system, seed=0, device="cpu")
    for r, inp in zip(served, inputs):
        one = serial.submit(inp)
        serial.drain()
        for q in coalesced.out_names:
            assert np.array_equal(r.outputs[q], one.outputs[q]), q
    # the same rows through the batch driver, one wave per batch
    rows = {q: np.concatenate([inp[q] for inp in inputs])
            for q in coalesced.in_specs}
    n = sum(sizes) // e * e
    res = system.run(inputs={q: v[:n] for q, v in rows.items()},
                     shared=coalesced.shared_host, n_eq=n,
                     collect_outputs=True, device="cpu")
    got = {q: np.concatenate([r.outputs[q] for r in served])[:n]
           for q in coalesced.out_names}
    for q in coalesced.out_names:
        assert np.array_equal(got[q], res.outputs[q]), q


def test_engine_device_fault_is_not_captured(system, monkeypatch):
    """A captured host-side stage error poisons one wave, but the engine
    asks the card whether it is still healthy first: a (sticky) device
    fault propagates out of the engine instead of marking the wave."""
    import torch

    eng = ServeEngine(system, seed=0, device="cpu")

    def boom(staged, carry):
        raise RuntimeError("host-side refusal")

    eng.driver.stage_fns[0] = boom
    eng.driver.device = torch.device("cuda", 0)
    calls = []

    def faulted(device=None):
        calls.append(device)
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(torch.cuda, "synchronize", faulted)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.submit(_requests(eng, [E])[0])
    assert calls
