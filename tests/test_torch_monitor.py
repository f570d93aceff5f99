"""repro_torch.runtime.monitor against repro.runtime.monitor: the
straggler monitor, the request-latency tracker and the elastic re-mesh
helpers, each fed the same step and latency series in both packages,
with equal flags, EWMAs and summaries; and the monitor on a traced
``run_chain`` flagging the same batches as the reference's."""
import numpy as np
import pytest

from repro.runtime import monitor as r_mon
from repro_torch.runtime import monitor as t_mon
from repro_torch.metrics import Histogram


def test_straggler_detection():
    mon = t_mon.StepMonitor(straggler_factor=2.0, warmup=0)
    assert not mon.record(1.0)
    for _ in range(5):
        assert not mon.record(1.0)
    assert mon.record(5.0)          # flagged
    assert not mon.record(1.0)      # ewma not poisoned


def test_flagged_step_still_updates_ewma_damped():
    mon = t_mon.StepMonitor(straggler_factor=2.0, warmup=0)
    mon.record(1.0)  # seeds the EWMA
    before = mon.ewma
    assert mon.record(10.0)
    assert mon.ewma > before
    expect = (1 - mon.flagged_alpha) * before + mon.flagged_alpha * 10.0
    assert mon.ewma == pytest.approx(expect)
    assert mon.ewma < (1 - mon.alpha) * before + mon.alpha * 10.0


def test_persistent_slowdown_rebaselines():
    mon = t_mon.StepMonitor(straggler_factor=2.0, warmup=0, flagged_alpha=0.3)
    mon.record(1.0)
    flags = [mon.record(5.0) for _ in range(30)]
    assert flags[0] and not flags[-1]
    assert mon.flags


def test_elastic_remesh_plan():
    assert t_mon.plan_elastic_remesh(256, model_axis=16) == (16, 16)
    assert t_mon.plan_elastic_remesh(248, model_axis=16) == (15, 16)
    with pytest.raises(ValueError):
        t_mon.plan_elastic_remesh(8, model_axis=16)
    assert t_mon.rebalance_batch(256, 15) == 255


def test_request_latency_delegates_to_metrics_histogram():
    rl = t_mon.RequestLatency(window=8)
    ref = Histogram(window=8)
    xs = [0.01 * (i + 1) for i in range(20)]
    for x in xs:
        rl.record(x)
        ref.observe(x)
    assert rl.count == ref.count == 20
    assert rl.total_s == ref.sum and rl.max_s == ref.max
    for q in (0.0, 0.5, 0.95, 1.0):
        assert rl.quantile(q) == ref.quantile(q)
    s = rl.summary()
    assert sorted(s) == ["count", "max_s", "mean_s", "p50_s", "p95_s"]
    assert s["mean_s"] == pytest.approx(sum(xs) / len(xs))
    assert t_mon.RequestLatency().summary() == {
        "count": 0.0, "mean_s": 0.0, "p50_s": 0.0, "p95_s": 0.0,
        "max_s": 0.0}


def test_step_monitor_summary_histogram_backed():
    mon = t_mon.StepMonitor(straggler_factor=2.0, warmup=0)
    for _ in range(6):
        mon.record(1.0)
    mon.record(5.0)
    s = mon.summary()
    assert s["count"] == 7.0 and s["max_s"] == 5.0
    assert s["flagged"] == 1.0 and s["flag_rate"] == pytest.approx(1 / 7)
    assert s["p50_s"] == 1.0


@pytest.mark.parametrize("kw", [
    dict(straggler_factor=2.0, warmup=0),
    dict(straggler_factor=1.5, warmup=3, alpha=0.3),
    dict(straggler_factor=2.0, warmup=1, flagged_alpha=0.3),
], ids=["default", "warmup", "damped"])
def test_step_monitor_equals_reference(kw):
    """The same step-time series through both packages' monitors: the
    same flags, EWMA and summary after every step."""
    steps = np.random.default_rng(11).lognormal(0.0, 0.6, 200)
    steps[[40, 41, 120]] *= 8.0
    ref, got = r_mon.StepMonitor(**kw), t_mon.StepMonitor(**kw)
    for dt in steps.tolist():
        assert got.record(dt) == ref.record(dt)
        assert got.ewma == ref.ewma
    assert got.flags == ref.flags and got.flags
    assert got.summary() == ref.summary()


def test_request_latency_equals_reference():
    lat = np.random.default_rng(12).exponential(0.05, 3000).tolist()
    ref, got = r_mon.RequestLatency(window=256), t_mon.RequestLatency(window=256)
    for x in lat:
        ref.record(x)
        got.record(x)
    assert got.summary() == ref.summary()
    for q in (0.1, 0.5, 0.9, 0.99):
        assert got.quantile(q) == ref.quantile(q)


def test_run_chain_monitor_flags_equal_reference():
    """A monitor that flags every post-seed batch on both packages'
    traced run_chain: the same straggler batches, on the result, the
    sync spans and the attribution."""
    from repro.cfd import operators as r_ops
    from repro.cfd import simulation as r_sim
    from repro.memory import chain as r_chain
    from repro.memory import channels as r_channels
    from repro import trace as r_trace
    from repro_torch.cfd import operators as t_ops
    from repro_torch.cfd import simulation as t_sim
    from repro_torch.memory import chain as t_chain
    from repro_torch.memory import channels as t_channels
    from repro_torch import trace as t_trace

    p, e, n = 3, 16, 3
    rng = np.random.default_rng(9)
    inputs = {q: rng.uniform(-1, 1, (e * n, p, p, p)).astype(np.float32)
              for q in ("interp.u", "helmholtz.D")}
    got = []
    for ops, sim, chain_mod, target, trace, mon_mod, dev in (
            (r_ops, r_sim, r_chain, r_channels.ALVEO_U280, r_trace, r_mon, {}),
            (t_ops, t_sim, t_chain, t_channels.ALVEO_U280, t_trace, t_mon,
             {"device": "cpu"})):
        chain = ops.build_cfd_chain(p, **dev)
        plan = chain_mod.plan_chain(chain, target=target, batch_elements=e,
                                    prefetch_depth=1, n_eq=e * n)
        tracer = trace.Tracer()
        mon = mon_mod.StepMonitor(straggler_factor=0.0, warmup=0)
        res = sim.run_chain(chain, plan, inputs=inputs, n_eq=e * n,
                            max_batches=n, pipeline_stages=True,
                            tracer=tracer, monitor=mon, **dev)
        got.append((res.straggler_batches,
                    trace.attribute(tracer, plan).straggler_batches,
                    mon.flags))
    assert got[1] == got[0] and got[1][0] == (1, 2)
