"""The port's chain design-space sweep (``explore_chain`` and its
placement searches, ``measure_chain_plan``, ``format_chain_ranking``,
``flow.compile(dse=True)``) held against the reference's.

Both packages sweep the same chains on the same datasheets and
topologies: the rankings list the same candidates in the same order --
per-stage backends, E, CU and depth vectors, per-stage groups and batch
sizes, the predicted seconds an element, equal plan signatures -- and
the leaderboard text is byte for byte the reference's.  On the CPU
``measure_chain_plan`` times the real chain driver, returns None only
for a plan it cannot run as planned, and lets every other failure
through.
"""
import dataclasses
import re

import numpy as np
import pytest

from repro import flow as r_flow
from repro.cfd import operators as r_operators
from repro.memory import channels as r_channels
from repro.memory import dse as r_dse
from repro.memory import layout as r_layout
from repro.memory.placement import DeviceTopology as RTopology
from repro_torch import flow as t_flow
from repro_torch.cfd import operators as t_operators
from repro_torch.cfd import simulation as t_simulation
from repro_torch.flow import patterns as t_patterns
from repro_torch.memory import chain as t_chain
from repro_torch.memory import channels as t_channels
from repro_torch.memory import dse as t_dse
from repro_torch.memory.placement import DeviceTopology as TTopology


def _r_target(name):
    if name == "h100-sxm":
        return r_channels.MemoryTarget(
            **dataclasses.asdict(t_channels.H100_SXM))
    return r_channels.resolve_target(name)


def _plan_like_the_port(target, monkeypatch):
    """On the H100 datasheet the port pads no batch to a VMEM block (its
    CUDA kernels walk a ragged last tile): have the reference plan so
    too, so that both sweep the same E."""
    if target == "h100-sxm":
        monkeypatch.setattr(r_layout, "pad_batch_for_block",
                            lambda e, *a, **kw: (e, 0))


_BLOCK = re.compile(r"BE=\d+ \(vmem ws [\d.]+ MiB\)")


def _report(plan):
    """A plan's report, with each stage's block masked on the H100, where
    the port's kernel stages carry their CUDA kernel's tile and the
    reference a VMEM block (:func:`_assert_kernel_tiles` checks those)."""
    text = plan.report()
    return _BLOCK.sub("BE=*", text) if plan.target.name == "h100-sxm" \
        else text


def _assert_kernel_tiles(plan, chain):
    """On the H100 each kernel stage's block is its CUDA kernel's tile."""
    if plan.target.name != "h100-sxm":
        return
    for sp, s in zip(plan.stages, chain.stages):
        tile = t_patterns.kernel_tile_for(s.program, 4)
        if sp.backend == "pallas" and tile is not None:
            assert (sp.block_elements, sp.block_working_set_bytes) == (
                tile[0], tile[2]), sp.name


def _key(c):
    """What a ranking entry is: its design point and its prediction."""
    p = c.plan
    return (tuple(sp.backend for sp in p.stages), p.batch_elements,
            tuple(p.cu_counts), tuple(sp.prefetch_depth for sp in p.stages),
            p.stage_batch_elements,
            tuple(sg.devices for sg in p.placement.stages),
            c.predicted_s_per_element, p.feasible, p.signature)


#: sweeps over the named-cut chain at p = 5: (target, n_eq, space,
#: topology spec, explore_chain keywords)
SWEEPS = {
    "homogeneous-4": ("alveo-u280", 1 << 14, dict(
        backends=("xla", "staged", "pallas"), batch_divisors=(1, 2),
        prefetch_depths=(0, 1, 2), cu_counts=(1, 2, 4), max_placements=4,
        max_backend_combos=6), "4", {}),
    "hetero-cpu2-tpu4": ("tpu-v5e", 1 << 14, dict(
        backends=("xla",), batch_divisors=(1, 2), prefetch_depths=(0, 1),
        cu_counts=(1, 2), max_placements=6), "cpu:2,tpu:4", {}),
    "h100-default": ("h100-sxm", 2_000_000, dict(
        backends=("xla", "staged", "pallas"), cu_counts=(1,)), None, {}),
    "h100-fused": ("h100-sxm", 2_000_000, dict(
        backends=("xla", "pallas"), batch_divisors=(1, 4)), None,
        dict(max_stages=2)),
}


def _sweep(name, monkeypatch):
    target, n_eq, space, topo, kw = SWEEPS[name]
    t_topo = TTopology.parse(topo) if topo else None
    r_topo = RTopology.parse(topo) if topo else None
    _plan_like_the_port(target, monkeypatch)
    chain = t_operators.build_cfd_chain(5, backends="pallas", device="cpu")
    got = t_dse.explore_chain(
        chain, target=t_channels.resolve_target(target), n_eq=n_eq,
        space=t_dse.ChainDesignSpace(**space), topology=t_topo, **kw)
    if not kw:
        for c in got[:3]:
            _assert_kernel_tiles(c.plan, chain)
    want = r_dse.explore_chain(
        r_operators.build_cfd_chain(5, backends="pallas"),
        target=_r_target(target), n_eq=n_eq,
        space=r_dse.ChainDesignSpace(**space), topology=r_topo, **kw)
    return got, want


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_explore_chain_ranking_matches_reference(name, monkeypatch):
    got, want = _sweep(name, monkeypatch)
    assert len(got) == len(want) > 0
    assert [_key(c) for c in got] == [_key(c) for c in want]
    assert (t_dse.format_chain_ranking(got, limit=len(got))
            == r_dse.format_chain_ranking(want, limit=len(want)))
    assert [_report(c.plan) for c in got[:3]] == \
        [_report(c.plan) for c in want[:3]]
    if SWEEPS[name][4]:
        assert all(c.plan.fusion is not None for c in got)
    if name.startswith("hetero"):
        # the joint (group, cu, E_s) search put stages on both kinds
        assert any(len(set(k[5])) > 1 for k in map(_key, got))


def test_placement_searches_match_reference():
    """The branch-and-bound frontiers themselves, fed the same per-stage
    cost terms: equal vectors in equal order."""
    chain = t_operators.build_cfd_chain(5, device="cpu")
    space = dict(cu_counts=(1, 2, 4), prefetch_depths=(0, 1, 2),
                 batch_divisors=(1, 2, 4), max_placements=5)
    ref = t_chain.plan_chain(chain, target=t_channels.ALVEO_U280,
                             batch_elements=512, n_eq=1 << 14)
    costs = [sp.cost for sp in ref.stages]
    got = t_dse._search_stage_placements(
        costs, t_dse.ChainDesignSpace(**space), TTopology.homogeneous(4), 512)
    want = r_dse._search_stage_placements(
        costs, r_dse.ChainDesignSpace(**space), RTopology.homogeneous(4), 512)
    assert got == want and len(got) == 5
    topo = TTopology.parse("cpu:2,tpu:4")
    group_costs = {
        gi: [sp.cost for sp in t_chain.plan_chain(
            chain, target=t_channels.TPU_V5E, batch_elements=512,
            n_eq=1 << 14, topology=topo, stage_groups=(gi,) * 3).stages]
        for gi in range(2)
    }
    got = t_dse._search_hetero_placements(
        group_costs, t_dse.ChainDesignSpace(**space), topo, 512)
    want = r_dse._search_hetero_placements(
        group_costs, r_dse.ChainDesignSpace(**space),
        RTopology.parse("cpu:2,tpu:4"), 512)
    assert got == want and len(got) == 5


def test_explore_chain_validation(tmp_path):
    chain = t_operators.build_cfd_chain(5, device="cpu")
    with pytest.raises(ValueError, match="measure_top"):
        t_dse.explore_chain(chain, target=t_channels.CPU_HOST,
                            calibrate=True)
    # a cold profile store leaves the ranking as it is
    cold = t_dse.explore_chain(chain, target=t_channels.CPU_HOST)
    warm = t_dse.explore_chain(chain, target=t_channels.CPU_HOST,
                               profile=str(tmp_path / "p.json"))
    assert [c.plan.signature for c in warm] == [
        c.plan.signature for c in cold]
    assert all(c.corrected_s_per_element is None for c in warm)


# ---------------------------------------------------------------------------
# measurement on the CPU
# ---------------------------------------------------------------------------


def _small_space(**kw):
    return t_dse.ChainDesignSpace(
        **{"backends": ("pallas",), "batch_divisors": (1,),
           "prefetch_depths": (0, 1), **kw})


def test_measure_chain_plan_runs_the_plan_or_says_why_not():
    """A positive time for a runnable plan (E = 45, a multiple of no
    kernel block: the last tile is ragged) and for one with per-stage
    batch sizes (re-blocked on the one device); None for a placement on
    two devices and for backends other than the compiled chain's."""
    chain = t_operators.build_cfd_chain(5, backends="pallas", device="cpu")
    t = t_channels.CPU_HOST
    plan = t_chain.plan_chain(chain, target=t, batch_elements=45, n_eq=90)
    got = t_dse.measure_chain_plan(chain, plan, max_batches=2, device="cpu")
    assert got is not None and got > 0
    wide = t_chain.plan_chain(chain, target=t, batch_elements=45, n_eq=90,
                              cu_count=(1, 2, 1))
    assert wide.placement.devices_used[-1] >= 1
    assert t_dse.measure_chain_plan(chain, wide, device="cpu") is None
    reblocked = t_chain.plan_chain(
        chain, target=t, batch_elements=48, n_eq=96,
        topology=TTopology.parse("cpu:1,alveo:1"), stage_groups=(0, 0, 0),
        stage_batch_elements=(16, 48, 48))
    assert not reblocked.uniform_batch
    got = t_dse.measure_chain_plan(chain, reblocked, max_batches=2,
                                   device="cpu")
    assert got is not None and got > 0
    other = t_chain.plan_chain(chain, target=t, batch_elements=45, n_eq=90,
                               backends=("xla", "pallas", "pallas"))
    assert t_dse.measure_chain_plan(chain, other, device="cpu") is None


def test_measure_chain_plan_times_a_placement_on_a_two_slot_pool():
    """The two-device placement of the test above (at an E that shards
    over its group) on two host slots: a time, not None, bitwise the
    serial one-slot outputs; an E its group does not divide gives None,
    as the reference's raising run does."""
    chain = t_operators.build_cfd_chain(5, backends="pallas", device="cpu")
    t = t_channels.CPU_HOST
    wide = t_chain.plan_chain(chain, target=t, batch_elements=48, n_eq=96,
                              cu_count=(1, 2, 1))
    got = t_dse.measure_chain_plan(chain, wide, max_batches=2,
                                   devices=["cpu", "cpu"])
    assert got is not None and got > 0
    placed = t_simulation.run_chain(chain, wide, collect_outputs=True,
                                    devices=["cpu", "cpu"])
    assert placed.placement_groups == ((0,), (1, 0), (1,))
    with pytest.warns(RuntimeWarning, match="are local"):
        one = t_simulation.run_chain(chain, wide, collect_outputs=True,
                                     device="cpu", pipeline_stages=False)
    for q, v in one.outputs.items():
        assert np.array_equal(v, placed.outputs[q]), q
    odd = t_chain.plan_chain(chain, target=t, batch_elements=45, n_eq=90,
                             cu_count=(1, 2, 1))
    assert t_dse.measure_chain_plan(chain, odd,
                                    devices=["cpu", "cpu"]) is None


def test_measure_chain_plan_skips_another_policy():
    """run_chain runs the compiled policy, so a plan at another policy is
    not measured: in a two-policy sweep only float32 candidates (the
    compiled chain's) are verified, though bfloat16 ones rank among them."""
    chain = t_operators.build_cfd_chain(5, backends="pallas", device="cpu")
    t = t_channels.CPU_HOST
    bf16 = t_chain.plan_chain(chain, target=t, batch_elements=45, n_eq=90,
                              policy="bfloat16")
    assert t_dse.measure_chain_plan(chain, bf16, device="cpu") is None
    cands = t_dse.explore_chain(
        chain, target=t, n_eq=64,
        space=_small_space(policies=("float32", "bfloat16")),
        measure_top=8, measure_batches=1, device="cpu")
    feasible = [c for c in cands if c.plan.feasible]
    assert {c.plan.policy for c in feasible} == {"float32", "bfloat16"}
    assert all(c.verified == (c.plan.policy == "float32") for c in feasible)


def test_measure_chain_plan_propagates_failures(monkeypatch):
    """A stage that fails inside run_chain is not a None: the error
    reaches the caller (the reference swallowed every exception)."""
    chain = t_operators.build_cfd_chain(5, backends="pallas", device="cpu")
    plan = t_chain.plan_chain(chain, target=t_channels.CPU_HOST,
                              batch_elements=8, n_eq=16)

    def refuse(*a, **kw):
        raise RuntimeError("gemm_chain kernel launch failed: CUDA error 1")

    from repro_torch.cfd import simulation

    monkeypatch.setattr(simulation.mempipe, "run_stage_pipelined", refuse)
    with pytest.raises(RuntimeError, match="launch failed"):
        t_dse.measure_chain_plan(chain, plan, max_batches=1, device="cpu")


def test_measure_chain_plan_propagates_a_failing_kernel(monkeypatch):
    """A kernel stage whose wrapper raises (as a refused launch does on
    the card) fails the measurement; it never turns into a None or into
    another backend."""
    from repro_torch.kernels.gemm import ops as gemm_ops

    chain = t_operators.build_cfd_chain(5, backends="pallas", device="cpu")
    plan = t_chain.plan_chain(chain, target=t_channels.CPU_HOST,
                              batch_elements=8, n_eq=16)

    def refuse(recipe, env, **kw):
        raise RuntimeError("gemm_chain kernel launch failed: CUDA error 1")

    monkeypatch.setattr(gemm_ops, "gemm_chain", refuse)
    with pytest.raises(RuntimeError, match="launch failed"):
        t_dse.measure_chain_plan(chain, plan, max_batches=1, device="cpu")


def test_explore_chain_measures_and_calibrates_on_the_cpu():
    """measure_top verifies the best candidates that match the compiled
    chain through the real run_chain; calibrate fits the correction and
    re-ranks by it, feasible first."""
    chain = t_operators.build_cfd_chain(5, backends="pallas", device="cpu")
    cands = t_dse.explore_chain(
        chain, target=t_channels.CPU_HOST, n_eq=64, space=_small_space(),
        measure_top=2, measure_batches=2, calibrate=True, device="cpu")
    measured = [c for c in cands if c.verified]
    assert len(measured) == 2
    assert all(c.measured_s_per_element > 0 for c in measured)
    assert all(c.corrected_s_per_element is not None for c in cands)
    feas = [c.plan.feasible for c in cands]
    assert feas == sorted(feas, reverse=True)
    corr = t_dse.fit_correction(cands)
    assert corr.n_samples == 2 and corr.factor > 0


def test_measure_plan_refuses_more_than_one_cu(monkeypatch):
    """A one-slot pool (``device=``) cannot replicate two CUs, however
    many cards the machine has, so such a plan is not measured there;
    a two-slot pool runs it (run_simulation shards each batch over the
    pool, as the reference over its element mesh)."""
    import torch

    plan = t_dse.make_plan(5, target=t_channels.CPU_HOST, batch_elements=8,
                           n_eq=16, cu_count=2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for device in ("cpu", "cuda"):
        assert t_dse.measure_plan(plan, 5, max_batches=1,
                                  device=device) is None
    assert t_dse.measure_plan(plan, 5, max_batches=1,
                              devices=["cpu"]) is None
    got = t_dse.measure_plan(plan, 5, max_batches=1, devices=["cpu", "cpu"])
    assert got is not None and got > 0


# ---------------------------------------------------------------------------
# flow.compile(dse=True)
# ---------------------------------------------------------------------------


DSE_FLOW_CASES = {
    "named-pallas": dict(stages=t_operators.CFD_PIPELINE_STAGES,
                         backend="pallas", target="alveo-u280"),
    "auto-schedule": dict(target="tpu-v5e"),
    "named-h100": dict(stages=t_operators.CFD_PIPELINE_STAGES,
                       backend="pallas", target="h100-sxm",
                       n_eq=2_000_000),
    "fused-h100": dict(backend="pallas", target="h100-sxm",
                       n_eq=2_000_000, fuse="auto"),
}


@pytest.mark.parametrize("case", sorted(DSE_FLOW_CASES))
def test_flow_dse_matches_reference(case, monkeypatch):
    """flow.compile(dse=True) adopts the reference's winner: equal
    report, plan signature, backends and ranking (on the H100 with the
    port's unpadded E, and its kernel stages at their CUDA tiles)."""
    kw = dict(DSE_FLOW_CASES[case])
    _plan_like_the_port(kw["target"], monkeypatch)
    src = t_operators.CFD_PIPELINE_SRC.format(p=5)
    got = t_flow.compile(src, dse=True, **kw)
    r_kw = {**kw, "target": _r_target(kw["target"])}
    want = r_flow.compile(r_operators.CFD_PIPELINE_SRC.format(p=5),
                          dse=True, **r_kw)
    assert got.backends == want.backends
    assert got.plan.signature == want.plan.signature
    if kw["target"] == "h100-sxm":
        _assert_kernel_tiles(got.plan, got.chain)
        assert _BLOCK.sub("BE=*", got.report()) == \
            _BLOCK.sub("BE=*", want.report())
    else:
        assert got.report() == want.report()
    assert [_key(c) for c in got.candidates] == \
        [_key(c) for c in want.candidates]
    assert [s.compiled.backend for s in got.chain.stages] == \
        list(got.backends)
