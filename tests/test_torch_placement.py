"""Element-axis placement in the port, on the CPU: the device pool,
``placement_meshes``, the ``place_fns`` hook, ``run_chain`` over
placed plans, CU replication in ``run_simulation``, the DSE's
measurements and the serving engine over a pool of host slots.

A pool is an ordered list of slots (``["cpu", "cpu"]`` is two slots on
one host), the port's counterpart of the reference's element mesh over
``--xla_force_host_platform_device_count`` devices.  Every placed run is
held bitwise against the serial one-slot run (elements are independent
and every kernel and plain stage sums in one fixed order); the
reference's own acceptance flow (its DSE's top multi-device placement)
runs once in a two-device subprocess, and the port's placement groups
equal its, its outputs within the chain tests' float32 tolerance.
"""
import json
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

from conftest import subprocess_env
from repro.memory import pipeline as r_pipeline
from repro.memory import placement as r_placement
from repro_torch.cfd import operators as t_operators
from repro_torch.cfd import simulation as t_simulation
from repro_torch.flow import build as t_build
from repro_torch.memory import chain as t_chain
from repro_torch.memory import channels as t_channels
from repro_torch.memory import dse as t_dse
from repro_torch.memory import pipeline as t_pipeline
from repro_torch.memory import placement as t_placement
from repro_torch.memory.placement import DeviceTopology as TTopology
from repro_torch.serve import ServeEngine

P, E, N_B = 5, 16, 4
N = E * N_B
#: float32 results of both packages sum in different orders
RTOL, ATOL_FRAC = 5e-4, 5e-4
#: a checksum is a sum of per-shard sums: another float32 order
CHECKSUM_RTOL = 1e-4
CPU2 = ["cpu", "cpu"]

_CACHE = {}


def _fixture(backend="pallas"):
    """The chain at p = 5 with the reference tests' numpy inputs (seed
    0, E = 16, four batches) and its serial one-slot outputs (K = 0)."""
    if backend not in _CACHE:
        ch = t_operators.build_cfd_chain(P, backends=backend, device="cpu")
        rng = np.random.default_rng(0)
        inputs = {
            "interp.u": rng.uniform(-1, 1, (N, P, P, P)).astype(np.float32),
            "helmholtz.D": rng.uniform(-1, 1, (N, P, P, P)).astype(np.float32),
        }
        shared = {
            name: rng.uniform(-1, 1, node.shape).astype(np.float32)
            for name, node in sorted(ch.shared_operands().items())
        }
        base_plan = t_chain.plan_chain(
            ch, target=t_channels.CPU_HOST, batch_elements=E, n_eq=N,
            prefetch_depth=0)
        base = t_simulation.run_chain(
            ch, base_plan, inputs=inputs, shared=shared,
            collect_outputs=True, pipeline_stages=False, device="cpu")
        assert base.placement_groups is None and not base.pipelined_stages
        _CACHE[backend] = (ch, inputs, shared, base)
    return _CACHE[backend]


def _assert_bitwise(want, got, what):
    assert set(want.outputs) == set(got.outputs)
    for q in want.outputs:
        assert np.array_equal(want.outputs[q], got.outputs[q]), (q, what)


# ---------------------------------------------------------------------------
# the device pool
# ---------------------------------------------------------------------------


def test_resolve_devices_without_a_card_raises():
    if torch.cuda.is_available():
        pool = t_channels.resolve_devices()
        assert pool == [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_channels.resolve_devices()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_channels.resolve_devices(["cpu", "cuda"])


def test_resolve_devices_pool_and_one_slot_shorthand():
    cpu = torch.device("cpu")
    assert t_channels.resolve_devices(device="cpu") == [cpu]
    assert t_channels.resolve_devices(CPU2) == [cpu, cpu]
    assert t_channels.resolve_devices((cpu,) * 4) == [cpu] * 4
    with pytest.raises(ValueError, match="not both"):
        t_channels.resolve_devices(CPU2, "cpu")
    with pytest.raises(ValueError, match="at least one slot"):
        t_channels.resolve_devices([])
    # the default plan's topology follows the pool, repeated slots too
    topo = TTopology.from_torch(t_channels.resolve_devices(CPU2))
    assert (topo.n_devices, topo.device_kind) == (2, "cpu")


# ---------------------------------------------------------------------------
# placement_meshes: the reference's rules, on the reference's placements
# ---------------------------------------------------------------------------

#: the placements tests/test_placement.py builds (topology size,
#: per-stage CU vector, depths, n_stages)
PLACEMENTS = {
    "disjoint-4": (4, [1, 2, 1], 1, None),
    "wrap-2": (2, [1, 2, 1], (2, 1, 1), None),
    "single-1": (1, [1, 1, 1], 1, None),
    "clamped-2": (2, [4, 1], (1, 1), None),
    "broadcast-2": (2, 2, 0, 3),
    "one-slot-2": (2, [1, 1, 1], 1, None),
}


def _both_placements(case):
    n, cus, depths, n_stages = PLACEMENTS[case]
    kw = {} if n_stages is None else {"n_stages": n_stages}
    return (t_placement.place_chain(TTopology(n), cus, depths, **kw),
            r_placement.place_chain(r_placement.DeviceTopology(n), cus,
                                    depths, **kw))


@pytest.mark.parametrize("n_slots", [1, 2, 3, 4])
@pytest.mark.parametrize("case", sorted(PLACEMENTS))
def test_placement_meshes_equal_the_reference(case, n_slots):
    t_place, r_place = _both_placements(case)
    pool = [f"d{i}" for i in range(n_slots)]
    assert t_place.device_groups == r_place.device_groups
    got = t_pipeline.placement_meshes(t_place, devices=pool)
    want = r_pipeline.placement_meshes(r_place, devices=pool)
    assert got == want


def test_placement_meshes_reference_cases():
    """tests/test_placement.py's cases, both Nones included (a one-device
    pool stands in for the reference's one local device)."""
    place = t_placement.place_chain(TTopology(1), [1, 1, 1], 1)
    assert t_pipeline.placement_meshes(place, devices=["d0"]) is None
    assert t_pipeline.placement_meshes(None, devices=["d0"]) is None
    big = t_placement.place_chain(TTopology(4), [1, 2, 1], 1)
    assert t_pipeline.placement_meshes(big, devices=["d0"]) is None
    got = t_pipeline.placement_meshes(big, devices=["d0", "d1", "d2", "d3"])
    assert got == [("d0",), ("d1", "d2"), ("d3",)]
    # slots are told apart by index: two slots on one device still place
    two = t_placement.place_chain(TTopology(2), [1, 2, 1], 1)
    cpu = torch.device("cpu")
    assert t_pipeline.placement_meshes(two, devices=[cpu, cpu]) == [
        (cpu,), (cpu, cpu), (cpu,)]


def test_run_stage_pipelined_place_fns_hook():
    """place_fns runs before each stage consumes a batch and its
    rewrites are what the stage sees (the reshard hook)."""
    calls = []

    def place0(staged, carry):
        calls.append(("p0", staged))
        return staged + 100, carry

    def stage0(staged, carry):
        return staged

    def stage1(staged, carry):
        return carry * 2

    out = t_pipeline.run_stage_pipelined(
        [stage0, stage1], range(3), depths=(0, 1),
        place_fns=[place0, None],
    )
    assert out == [200, 202, 204]
    assert [c[1] for c in calls] == [0, 1, 2]
    with pytest.raises(ValueError, match="place fns"):
        t_pipeline.run_stage_pipelined(
            [stage0, stage1], range(2), depths=0, place_fns=[place0],
        )


def test_place_fns_feed_the_handoff_span_and_series():
    from repro_torch import metrics, trace

    tracer, reg = trace.Tracer(), metrics.MetricsRegistry()
    t_pipeline.run_stage_pipelined(
        [lambda s, c: s, lambda s, c: c + 1], range(3), depths=(0, 1),
        place_fns=[None, lambda s, c: (s, c * 10)], tracer=tracer,
        metrics=reg, stage_names=["a", "b"])
    hand = [s for s in tracer.spans
            if s.cat == trace.attribution.CAT_HANDOFF]
    assert [(s.args["stage"], s.args["batch"]) for s in hand] == [
        (1, 0), (1, 1), (1, 2)]
    snap = {(m["name"], m["labels"].get("stage")): m
            for m in reg.snapshot()["metrics"]}
    assert snap[("pipeline_stage_handoff_seconds", "b")]["count"] == 3
    assert snap[("pipeline_stage_handoff_seconds", "a")]["count"] == 0
    trace.assert_valid(tracer)


# ---------------------------------------------------------------------------
# shards: layout, re-sharding, staging
# ---------------------------------------------------------------------------


def test_element_chunks_is_the_reference_layout():
    assert t_pipeline.element_chunks(16, 4) == [(0, 4), (4, 8), (8, 12),
                                                (12, 16)]
    assert t_pipeline.element_chunks(16, 1) == [(0, 16)]
    with pytest.raises(ValueError, match="shard evenly"):
        t_pipeline.element_chunks(15, 2)


def test_reshard_views_where_it_can_and_keeps_row_order():
    x = torch.arange(24.0).reshape(12, 2)
    two = t_pipeline.reshard((x,), CPU2)
    assert [s.data_ptr() for s in two] == [x[:6].data_ptr(),
                                           x[6:].data_ptr()]
    assert t_pipeline.reshard(two, CPU2) == two  # matching layout: as is
    three = t_pipeline.reshard(two, ["cpu"] * 3)
    assert [tuple(s.shape) for s in three] == [(4, 2)] * 3
    assert torch.equal(torch.cat(three), x)
    (one,) = t_pipeline.reshard(three, ["cpu"])
    assert torch.equal(one, x)


def test_host_stager_shards_each_name_over_its_slots():
    stager = t_pipeline.HostStager(CPU2, slots=2, layout={"b": ["cpu"]})
    batch = {"a": np.arange(8, dtype=np.float32),
             "b": np.arange(8, 16, dtype=np.float32)}
    staged = stager(batch)
    got = staged.shards()
    assert [s.tolist() for s in got["a"]] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert [s.tolist() for s in got["b"]] == [list(range(8, 16))]
    with pytest.raises(ValueError, match="shards"):
        staged.arrays()
    one = t_pipeline.HostStager("cpu")(batch).arrays()
    assert one["a"].tolist() == list(range(8))
    with pytest.raises(ValueError, match="shard evenly"):
        stager({"a": np.zeros(7, np.float32)})


# ---------------------------------------------------------------------------
# run_chain over placed plans: bitwise the serial one-slot run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["xla", "staged", "pallas"])
@pytest.mark.parametrize("pool,cus,depths", [
    (2, (1, 2, 1), (1, 1, 1)),
    (2, (2, 2, 2), (0, 0, 0)),
    (3, (1, 2, 1), (2, 1, 1)),
    (4, (2, 1, 1), (1, 2, 0)),
    (4, (4, 2, 1), (1, 1, 1)),
])
def test_placed_run_bitwise_equal_serial_one_slot(pool, cus, depths,
                                                  backend):
    ch, inputs, shared, base = _fixture(backend)
    plan = t_chain.plan_chain(
        ch, target=t_channels.CPU_HOST, batch_elements=E, n_eq=N,
        prefetch_depth=list(depths), cu_count=list(cus),
        topology=TTopology.homogeneous(pool))
    got = t_simulation.run_chain(ch, plan, inputs=inputs, shared=shared,
                                 collect_outputs=True,
                                 devices=["cpu"] * pool)
    assert got.placement_groups == plan.placement.device_groups
    assert got.devices == ("cpu",) * pool
    _assert_bitwise(base, got, (pool, cus, depths))


def _check_property(n_pool, cus, divs, depths):
    ch, inputs, shared, base = _fixture("pallas")
    # the widest group of {1, 2, 4} the pool holds: every group divides E
    cus = [max(d for d in (1, 2, 4) if d <= min(c, n_pool)) for c in cus]
    plan = t_chain.plan_chain(
        ch, target=t_channels.CPU_HOST, batch_elements=E, n_eq=N,
        prefetch_depth=list(depths), cu_count=cus,
        topology=TTopology.homogeneous(n_pool),
        stage_batch_elements=[E // d for d in divs])
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # no fallback
        got = t_simulation.run_chain(ch, plan, inputs=inputs, shared=shared,
                                     collect_outputs=True,
                                     devices=["cpu"] * n_pool)
    _assert_bitwise(base, got, (n_pool, cus, divs, depths))


try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - the container has hypothesis
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:

    @given(
        n_pool=st.integers(1, 4),
        cus=st.tuples(*[st.sampled_from([1, 2, 4])] * 3),
        divs=st.tuples(*[st.sampled_from([1, 2, 4])] * 3),
        depths=st.tuples(*[st.integers(0, 2)] * 3),
    )
    @settings(max_examples=12, deadline=None)
    def test_placed_execution_bitwise_equal_property(n_pool, cus, divs,
                                                     depths):
        _check_property(n_pool, cus, divs, depths)

else:  # deterministic fallback so the property still runs everywhere

    @pytest.mark.parametrize("n_pool,cus,divs,depths", [
        (1, (1, 1, 1), (1, 1, 1), (1, 1, 1)),
        (2, (1, 2, 1), (2, 1, 4), (2, 0, 1)),
        (3, (2, 1, 2), (1, 2, 1), (0, 1, 2)),
        (4, (4, 2, 1), (4, 4, 1), (1, 1, 1)),
    ])
    def test_placed_execution_bitwise_equal_property(n_pool, cus, divs,
                                                     depths):
        _check_property(n_pool, cus, divs, depths)


@pytest.mark.parametrize("n_pool,cus,divs,depths", [
    (2, (1, 2, 1), (2, 1, 4), (2, 0, 1)),
    (3, (2, 1, 2), (1, 2, 1), (0, 1, 2)),
    (4, (4, 2, 1), (4, 4, 1), (1, 1, 1)),
    (4, (1, 4, 2), (2, 4, 2), (2, 2, 2)),
])
def test_placed_execution_bitwise_fixed_cases(n_pool, cus, divs, depths):
    """The property's cases that cover re-blocking inside shards, groups
    that wrap, and every pool size."""
    _check_property(n_pool, cus, divs, depths)


def test_placed_run_handoffs_checksums_and_fallbacks():
    ch, inputs, shared, base = _fixture("pallas")
    from repro_torch import trace

    plan = t_chain.plan_chain(
        ch, target=t_channels.CPU_HOST, batch_elements=E, n_eq=N,
        prefetch_depth=(1, 1, 1), cu_count=(1, 2, 1),
        topology=TTopology.homogeneous(2))
    tracer = trace.Tracer()
    got = t_simulation.run_chain(ch, plan, inputs=inputs, shared=shared,
                                 devices=CPU2, tracer=tracer)
    assert got.placement_groups == ((0,), (1, 0), (1,))
    # interp -> grad (w) and grad -> helmholtz (gx) cross groups
    hand = [s for s in tracer.spans if s.cat == "handoff"]
    assert sorted({s.args["stage"] for s in hand}) == [1, 2]
    assert len(hand) == 2 * N_B
    for q, v in base.checksums.items():
        assert got.checksums[q] == pytest.approx(v, rel=CHECKSUM_RTOL), q
    # a one-device plan runs one group over the whole pool, bitwise
    whole = t_simulation.run_chain(ch, base.plan, inputs=inputs,
                                   shared=shared, collect_outputs=True,
                                   devices=["cpu"] * 4)
    assert whole.placement_groups is None
    _assert_bitwise(base, whole, "whole pool")
    # a plan for a bigger machine than the pool warns, with the
    # reference's text, and runs on the pool
    with pytest.warns(RuntimeWarning, match="are local"):
        small = t_simulation.run_chain(ch, plan, inputs=inputs,
                                       shared=shared, collect_outputs=True,
                                       device="cpu")
    assert small.placement_groups is None
    _assert_bitwise(base, small, "bigger machine")
    # a group the batch does not shard over evenly raises, as the
    # reference's device_put does
    odd = t_chain.plan_chain(ch, target=t_channels.CPU_HOST,
                             batch_elements=15, n_eq=30)
    with pytest.raises(ValueError, match="shard evenly"):
        t_simulation.run_chain(ch, odd, inputs=inputs, shared=shared,
                               devices=CPU2)


def test_compiled_system_run_passes_the_pool_through():
    src = t_operators.CFD_PIPELINE_SRC.format(p=P)
    system = t_build.compile(
        src, name="cfd", stages=t_operators.CFD_PIPELINE_STAGES,
        target=t_channels.CPU_HOST, batch_elements=E, n_eq=2 * E,
        cu_count=(1, 2, 1), devices=2, device="cpu")
    placed = system.run(devices=CPU2, collect_outputs=True)
    assert placed.placement_groups == ((0,), (1, 0), (1,))
    with pytest.warns(RuntimeWarning, match="are local"):
        one = system.run(device="cpu", collect_outputs=True)
    _assert_bitwise(one, placed, "CompiledSystem.run")


# ---------------------------------------------------------------------------
# the reference's acceptance flows, on a two-slot pool
# ---------------------------------------------------------------------------

REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax

    from repro.cfd import operators, simulation
    from repro.memory import chain as mchain
    from repro.memory import channels, dse
    from repro.memory.placement import DeviceTopology

    assert jax.device_count() == 2, jax.devices()
    p, E, n_b = 5, 16, 4
    n = E * n_b
    chain = operators.build_cfd_chain(p)
    rng = np.random.default_rng(0)
    inputs = {
        "interp.u": rng.uniform(-1, 1, (n, p, p, p)).astype(np.float32),
        "helmholtz.D": rng.uniform(-1, 1, (n, p, p, p)).astype(np.float32),
    }
    shared = {
        name: rng.uniform(-1, 1, node.shape).astype(np.float32)
        for name, node in sorted(chain.shared_operands().items())
    }
    space = dse.ChainDesignSpace(
        backends=("xla",), batch_divisors=(1,),
        prefetch_depths=(0, 1, 2), cu_counts=(1, 2), max_placements=8,
    )
    cands = dse.explore_chain(
        chain, target=channels.CPU_HOST, n_eq=n, space=space,
        topology=DeviceTopology.homogeneous(2),
    )
    top_multi = next(
        c for c in cands
        if c.plan.feasible and len(set(c.plan.placement.devices_used)) > 1
    )
    plan = mchain.plan_chain(
        chain, target=channels.CPU_HOST, batch_elements=E, n_eq=n,
        placement=top_multi.plan.placement,
    )
    piped = simulation.run_chain(
        chain, plan, inputs=inputs, shared=shared, collect_outputs=True,
    )
    hplan = mchain.plan_chain(
        chain, target=channels.CPU_HOST, batch_elements=E, n_eq=n,
        prefetch_depth=(2, 1, 1), cu_count=1,
        topology=DeviceTopology.parse("cpu:1,alveo:1"),
        stage_groups=(0, 1, 1), stage_batch_elements=(E // 2, E, E),
    )
    hetero = simulation.run_chain(
        chain, hplan, inputs=inputs, shared=shared, collect_outputs=True,
    )
    np.savez(sys.argv[1], **{q: np.asarray(v)
                             for q, v in piped.outputs.items()})
    print(json.dumps({
        "groups": [list(g) for g in piped.placement_groups],
        "cu_counts": list(plan.cu_counts),
        "depths": list(plan.placement.prefetch_depths),
        "hetero_groups": [list(g) for g in hetero.placement_groups],
        "hetero_stage_e": list(hplan.stage_batch_elements),
    }))
""")


@pytest.fixture(scope="module")
def reference_two_devices(tmp_path_factory):
    """The reference's sharded and two-kind runs on two forced host
    devices: their placement groups and the sharded run's outputs."""
    out = tmp_path_factory.mktemp("ref") / "outputs.npz"
    res = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, str(out)],
        env=subprocess_env(2), capture_output=True, text=True, timeout=420,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    with np.load(out) as z:
        got["outputs"] = {q: z[q] for q in z.files}
    return got


def test_dse_top_multi_device_placement_runs_on_two_slots(
        reference_two_devices):
    """The reference's acceptance flow: the DSE's top-ranked multi-device
    placement over two devices runs bitwise equal to the serial one-slot
    baseline, on the reference's groups, within float32 tolerance of
    the reference's outputs."""
    ch, inputs, shared, base = _fixture("xla")
    ref = reference_two_devices
    space = t_dse.ChainDesignSpace(
        backends=("xla",), batch_divisors=(1,), prefetch_depths=(0, 1, 2),
        cu_counts=(1, 2), max_placements=8)
    cands = t_dse.explore_chain(ch, target=t_channels.CPU_HOST, n_eq=N,
                                space=space,
                                topology=TTopology.homogeneous(2))
    top_multi = next(
        c for c in cands
        if c.plan.feasible and len(set(c.plan.placement.devices_used)) > 1)
    plan = t_chain.plan_chain(ch, target=t_channels.CPU_HOST,
                              batch_elements=E, n_eq=N,
                              placement=top_multi.plan.placement)
    assert list(plan.cu_counts) == ref["cu_counts"]
    assert list(plan.placement.prefetch_depths) == ref["depths"]
    piped = t_simulation.run_chain(ch, plan, inputs=inputs, shared=shared,
                                   collect_outputs=True, devices=CPU2)
    assert [list(g) for g in piped.placement_groups] == ref["groups"]
    _assert_bitwise(base, piped, "DSE top multi-device")
    assert set(ref["outputs"]) == set(piped.outputs)
    for q, r in ref["outputs"].items():
        np.testing.assert_allclose(piped.outputs[q], r, rtol=RTOL,
                                   atol=ATOL_FRAC * np.abs(r).max())


def test_two_kind_placement_bitwise_on_two_slots(reference_two_devices):
    """The reference's two-kind case: stage 0 on the cpu-host group at
    half E, the rest on the alveo group, the 0 -> 1 handoff re-blocked
    and moved across groups, bitwise the serial one-slot run."""
    ch, inputs, shared, base = _fixture("pallas")
    plan = t_chain.plan_chain(
        ch, target=t_channels.CPU_HOST, batch_elements=E, n_eq=N,
        prefetch_depth=(2, 1, 1), cu_count=1,
        topology=TTopology.parse("cpu:1,alveo:1"),
        stage_groups=(0, 1, 1), stage_batch_elements=(E // 2, E, E))
    assert plan.feasible, plan.infeasible_reason
    assert [plan.placement.stage_kind(i) for i in range(3)] == [
        "cpu-host", "alveo-u280", "alveo-u280"]
    assert list(plan.stage_batch_elements) == (
        reference_two_devices["hetero_stage_e"])
    got = t_simulation.run_chain(ch, plan, inputs=inputs, shared=shared,
                                 collect_outputs=True, devices=CPU2)
    assert [list(g) for g in got.placement_groups] == (
        reference_two_devices["hetero_groups"])
    _assert_bitwise(base, got, "two kinds")


# ---------------------------------------------------------------------------
# CU replication (Fig. 2), the DSE's measurements, serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_slots", [2, 4])
def test_run_simulation_replicates_cus_over_the_pool(n_slots):
    cfg = t_simulation.SimConfig(p=P, n_eq=4 * E, batch_elements=E,
                                 backend="pallas")
    one = t_simulation.run_simulation(cfg, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = t_simulation.run_simulation(cfg, devices=["cpu"] * n_slots)
    assert got.plan.cu_count == n_slots  # planned with one CU a slot
    assert got.devices == ("cpu",) * n_slots and got.batches == 4
    assert got.checksum == pytest.approx(one.checksum, rel=CHECKSUM_RTOL)
    plan = t_simulation.plan_config(cfg, target=t_channels.CPU_HOST,
                                    cu_count=n_slots)
    with pytest.warns(RuntimeWarning, match=f"{n_slots} CUs"):
        t_simulation.run_simulation(cfg, plan=plan, max_batches=1,
                                    devices=["cpu"] * (n_slots // 2))


def test_measure_plans_time_a_big_enough_pool_and_refuse_a_smaller_one():
    plan = t_dse.make_plan(P, target=t_channels.CPU_HOST, batch_elements=E,
                           backend="pallas", cu_count=2)
    assert t_dse.measure_plan(plan, P, max_batches=1, devices=CPU2) > 0
    assert t_dse.measure_plan(plan, P, max_batches=1, device="cpu") is None
    ch = t_operators.build_cfd_chain(P, backends="pallas", device="cpu")
    wide = t_chain.plan_chain(ch, target=t_channels.CPU_HOST,
                              batch_elements=E, n_eq=2 * E,
                              cu_count=(1, 2, 1),
                              topology=TTopology.homogeneous(2))
    got = t_dse.measure_chain_plan(ch, wide, max_batches=1, devices=CPU2)
    assert got is not None and got > 0
    assert t_dse.measure_chain_plan(ch, wide, max_batches=1,
                                    devices=["cpu"]) is None
    four = t_chain.plan_chain(ch, target=t_channels.CPU_HOST,
                              batch_elements=E, n_eq=2 * E,
                              cu_count=(4, 1, 1),
                              topology=TTopology.homogeneous(4))
    assert t_dse.measure_chain_plan(ch, four, devices=["cpu"] * 3) is None
    assert t_dse.measure_chain_plan(ch, four, max_batches=1,
                                    devices=["cpu"] * 4) > 0


def test_explore_chain_measures_multi_device_candidates():
    ch = t_operators.build_cfd_chain(P, backends="pallas", device="cpu")
    space = t_dse.ChainDesignSpace(backends=("pallas",), batch_divisors=(1,),
                                   prefetch_depths=(0, 1), cu_counts=(1, 2),
                                   max_placements=4)
    cands = t_dse.explore_chain(ch, target=t_channels.CPU_HOST, n_eq=64,
                                space=space,
                                topology=TTopology.homogeneous(2),
                                measure_top=3, measure_batches=1,
                                devices=CPU2)
    measured = [c for c in cands if c.verified]
    assert len(measured) == 3
    assert any(len(c.plan.placement.devices_used) > 1 for c in measured)


def test_serving_engine_shards_waves_over_the_pool():
    src = t_operators.CFD_PIPELINE_SRC.format(p=P)
    system = t_build.compile(
        src, name="cfd", stages=t_operators.CFD_PIPELINE_STAGES,
        backends=("pallas",) * 3, target=t_channels.CPU_HOST,
        batch_elements=E, n_eq=2 * E, device="cpu")
    engine = ServeEngine(system, seed=0, devices=CPU2)
    alone = ServeEngine(system, seed=0, device="cpu")
    assert engine.devices == [torch.device("cpu")] * 2
    rng = np.random.default_rng(4)
    reqs = [{q: rng.uniform(-1, 1, (n,) + s).astype(np.float32)
             for q, s in sorted(engine.in_specs.items())}
            for n in (5, 16, 23, 1)]
    served = [engine.submit(r) for r in reqs]
    engine.drain()
    assert engine.stats["waves"] == 3
    for r, inp in zip(served, reqs):
        assert r.error is None
        one = alone.submit(inp)
        alone.drain()
        for q in engine.out_names:
            assert np.array_equal(r.outputs[q], one.outputs[q]), (r.rid, q)
