"""The port's cost-driven stage fusion (``repro_torch.memory.fusion``)
held against the reference's.

Both packages fuse the same chains on the same datasheets: equal
``FusionSpec`` decisions (groups, predicted times, saved handoff bytes,
``describe()`` text), equal plan signatures and equal GEMM-chain
recipes for every fused stage.  Merging stays bitwise-neutral on the
outputs, port against port, and within float32 summation order against
the reference at p = 5 on the CPU.  Every fused recipe lowers through
the GEMM-chain kernel's op table, work cubes and CTA tile at p = 5, 11
and 16 in float32 and bfloat16 (the card-side launch is in
``test_torch_cuda.py``).
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro import flow as r_flow
from repro.cfd import operators as r_operators
from repro.cfd import simulation as r_simulation
from repro.flow import patterns as r_patterns
from repro.memory import chain as r_chain
from repro.memory import channels as r_channels
from repro.memory import dse as r_dse
from repro.memory import fusion as r_fusion
from repro.memory import layout as r_layout
from repro_torch import flow as t_flow
from repro_torch.cfd import operators as t_operators
from repro_torch.cfd import simulation as t_simulation
from repro_torch.flow import patterns as t_patterns
from repro_torch.kernels.gemm import gemm as t_gemm
from repro_torch.memory import chain as t_chain
from repro_torch.memory import channels as t_channels
from repro_torch.memory import dse as t_dse
from repro_torch.memory import fusion as t_fusion

#: float32 results of both packages sum in different orders
RTOL, ATOL_FRAC = 5e-4, 5e-4


def _r_target(name):
    """The reference's datasheet of that name; the reference has no H100,
    so build the port's h100-sxm field by field."""
    if name == "h100-sxm":
        return r_channels.MemoryTarget(
            **dataclasses.asdict(t_channels.H100_SXM))
    return r_channels.resolve_target(name)


_BLOCK = re.compile(r"BE=\d+ \(vmem ws [\d.]+ MiB\)")


def _plan_like_the_port(target, monkeypatch):
    """On the H100 datasheet the port pads no batch to a VMEM block (its
    CUDA kernels walk a ragged last tile), and its kernel stages carry
    the kernel's tile: have the reference plan without the padding, and
    return the report view that masks each stage's block there."""
    if target != "h100-sxm":
        return lambda plan: plan.report()
    monkeypatch.setattr(r_layout, "pad_batch_for_block",
                        lambda e, *a, **kw: (e, 0))
    return lambda plan: _BLOCK.sub("BE=*", plan.report())


def _run(sim, chain, plan, inputs_by_var, shared, **kw):
    """Route full input arrays to whichever stage hosts each element
    stream (stage names differ between fused and unfused chains)."""
    inputs = {}
    for i, s in enumerate(chain.stages):
        for name, _ in chain.host_element_inputs(i):
            inputs[f"{s.name}.{name}"] = inputs_by_var[name]
    res = sim.run_chain(chain, plan, inputs=inputs, shared=shared,
                        collect_outputs=True, **kw)
    return {q.split(".", 1)[1]: np.asarray(v) for q, v in res.outputs.items()}


def _cfd_data(rng, p, n):
    u = rng.uniform(-1, 1, (n, p, p, p)).astype(np.float32)
    D = rng.uniform(-1, 1, (n, p, p, p)).astype(np.float32)
    shared = {
        name: rng.uniform(-1, 1, (p, p)).astype(np.float32)
        for name in ("A", "Dx", "Dy", "Dz", "S")
    }
    return {"u": u, "D": D}, shared


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_FRAC * np.abs(want).max())


# ---------------------------------------------------------------------------
# mechanical merging (fuse_chain)
# ---------------------------------------------------------------------------


def _helmholtz_on_gemm_chain(chain):
    """The chain with its Helmholtz stage run by the GEMM-chain kernel on
    the stage's own recipe, which contracts the modes in the program's
    order (0, 2, 1); the Helmholtz kernel contracts 0, 1, 2, so the two
    round differently."""
    from repro_torch.kernels.gemm import ops as gemm_ops
    from repro_torch.memory.chain import ChainStage, ProgramChain

    stages = []
    for s in chain.stages:
        compiled = s.compiled
        if s.name == "helmholtz":
            recipe = t_patterns.match_gemm_chain(s.program)
            compiled = dataclasses.replace(
                compiled, batched_fn=gemm_ops.make_pallas_impl(recipe, 1))
        stages.append(ChainStage(s.name, compiled, dict(s.bindings)))
    return ProgramChain(stages)


@pytest.mark.parametrize("backends", ["pallas", "xla"])
@pytest.mark.parametrize("groups", [[(0, 1), (2,)], [(0,), (1, 2)],
                                    [(0, 1, 2)]],
                         ids=["interp+grad", "grad+helmholtz", "all"])
def test_fuse_chain_bitwise_neutral_and_matches_reference(groups, backends,
                                                          rng):
    """Merging drops the internal handoffs and changes no output bit in
    the port: the fused chain equals the unfused one that runs the same
    arithmetic.  Where the Helmholtz stage joins a kernel group, that is
    the unfused chain with its Helmholtz stage on the GEMM-chain kernel
    (the Helmholtz kernel contracts its modes in another order, so v
    then differs from it by rounding, as in the reference).  The
    reference's fused chain agrees within float32 summation order."""
    p, E, n = 5, 8, 16
    t = t_channels.CPU_HOST
    elems, shared = _cfd_data(rng, p, n)
    chain = t_operators.build_cfd_chain(p, backends=backends, device="cpu")
    plan = t_chain.plan_chain(chain, target=t, batch_elements=E, n_eq=n)
    want = _run(t_simulation, chain, plan, elems, shared, device="cpu")

    fused = t_fusion.fuse_chain(chain, groups)
    names = ["+".join(chain.stages[i].name for i in g) for g in groups]
    assert [s.name for s in fused.stages] == names
    assert all(s.backend == backends for s in fused.stages)
    if len(groups[0]) > 1:
        assert "w" not in fused.stages[0].program.outputs
    fplan = t_chain.plan_chain(fused, target=t, batch_elements=E, n_eq=n)
    got = _run(t_simulation, fused, fplan, elems, shared, device="cpu")
    assert sorted(got) == sorted(want) == ["gy", "gz", "v"]
    if backends == "pallas" and len(groups[-1]) > 1:
        _close(got["v"], want["v"])
        want = _run(t_simulation, _helmholtz_on_gemm_chain(chain), plan,
                    elems, shared, device="cpu")
    for out_var in ("gy", "gz", "v"):
        assert np.array_equal(got[out_var], want[out_var]), out_var

    r_full = r_operators.build_cfd_chain(p, backends=backends)
    r_fused = r_fusion.fuse_chain(r_full, groups)
    r_plan = r_chain.plan_chain(r_fused, target=r_channels.CPU_HOST,
                                batch_elements=E, n_eq=n)
    assert r_plan.signature == fplan.signature
    ref = _run(r_simulation, r_fused, r_plan, elems, shared)
    for out_var in ("gy", "gz", "v"):
        _close(got[out_var], ref[out_var])
    for t_s, r_s in zip(fused.stages, r_fused.stages):
        assert t_s.backend == r_s.backend
        assert (t_patterns.program_signature(t_s.program)
                == r_patterns.program_signature(r_s.program))
        assert t_s.bindings == r_s.bindings


def test_fuse_chain_rejects_bad_groups():
    chain = t_operators.build_cfd_chain(3, device="cpu")
    with pytest.raises(ValueError, match="partition"):
        t_fusion.fuse_chain(chain, [(0,), (2, 1)])   # out of order
    with pytest.raises(ValueError, match="partition"):
        t_fusion.fuse_chain(chain, [(0, 1)])         # incomplete


def test_fused_stage_rematches_the_kernel():
    """A merged interp+grad program still fits the GEMM-chain kernel
    class, so the fused stage keeps backend 'pallas' and its callable is
    the kernel's wrapper, not plain PyTorch."""
    system = t_operators.compile_cfd_pipeline(
        5, backends="pallas", target="alveo-u280")
    assert system.backends == ("pallas",) * 3
    fused = t_fusion.fuse_chain(system.chain, [(0, 1), (2,)])
    assert fused.stages[0].backend == "pallas"
    recipe = t_patterns.match_gemm_chain(fused.stages[0].program)
    assert recipe is not None
    rng = np.random.default_rng(0)
    env = {name: torch.from_numpy(
        rng.uniform(-1, 1, ((4,) + shape) if is_elem else shape)
        .astype(np.float32)) for name, shape, is_elem in recipe.inputs}
    before = t_gemm.gemm_chain.launches
    got = fused.stages[0].compiled.batched_fn(env)
    want = t_gemm.gemm_chain_plain(recipe, env, block_elements=4)
    assert t_gemm.gemm_chain.launches == before          # CPU: plain
    for k in want:
        assert torch.equal(got[k], want[k])


def test_merged_stage_falls_back_to_xla_only_without_a_kernel_class():
    """_compile_merged keeps xla/staged members as they are and tries the
    kernels only where a member was 'pallas', as the reference does."""
    chain = t_operators.build_cfd_chain(5, backends=("xla", "staged", "xla"),
                                        device="cpu")
    fused = t_fusion.fuse_chain(chain, [(0, 1), (2,)])
    assert fused.stages[0].backend == "xla"
    staged = t_operators.build_cfd_chain(5, backends="staged", device="cpu")
    assert t_fusion.fuse_chain(staged, [(0, 1, 2)]).stages[0].backend == \
        "staged"


# ---------------------------------------------------------------------------
# the greedy decision (fuse_chain_auto), against the reference
# ---------------------------------------------------------------------------


def _chains(pkg, p, row):
    """The chain each row of the fusion table starts from."""
    if row == "auto-schedule":
        src = pkg["operators"].CFD_PIPELINE_SRC.format(p=p)
        return pkg["compile"](src, target="alveo-u280",
                              backend="pallas").chain
    return pkg["chain"](p)


T_PKG = {"operators": t_operators, "compile": t_flow.compile,
         "chain": lambda p: t_operators.build_cfd_chain(
             p, backends="pallas", device="cpu")}
R_PKG = {"operators": r_operators, "compile": r_flow.compile,
         "chain": lambda p: r_operators.build_cfd_chain(p, backends="pallas")}

#: the four rows: chain, fusion knobs
ROWS = {
    "named-auto": dict(fuse="auto"),
    "named-max2": dict(max_stages=2),
    "named-max1": dict(max_stages=1),
    "auto-schedule": dict(fuse="auto"),
}


def _spec_view(spec):
    return (spec.mode, spec.groups, spec.n_stages_before,
            spec.n_stages_after, spec.t_unfused, spec.t_fused,
            spec.saved_handoff_bytes, spec.barriers, spec.describe())


@pytest.mark.parametrize("target", ["alveo-u280", "tpu-v5e", "h100-sxm"])
@pytest.mark.parametrize("row", sorted(ROWS))
def test_fusion_decisions_match_reference(row, target, monkeypatch):
    """Equal FusionSpecs, plan signatures and fused GEMM recipes at the
    paper's p = 11 and n_eq = 2,000,000; on the H100 each fused kernel
    stage's block is its kernel's tile."""
    p, n_eq = 11, 2_000_000
    report = _plan_like_the_port(target, monkeypatch)
    t_plan = t_chain.plan_chain(
        _chains(T_PKG, p, row), target=t_channels.resolve_target(target),
        n_eq=n_eq, **ROWS[row])
    r_plan = r_chain.plan_chain(
        _chains(R_PKG, p, row), target=_r_target(target), n_eq=n_eq,
        **ROWS[row])
    assert _spec_view(t_plan.fusion) == _spec_view(r_plan.fusion)
    assert t_plan.signature == r_plan.signature
    assert report(t_plan) == report(r_plan)
    t_stages, r_stages = t_plan.fusion.chain.stages, r_plan.fusion.chain.stages
    if target == "h100-sxm":
        for sp, s in zip(t_plan.stages, t_stages):
            tile = t_patterns.kernel_tile_for(s.program, 4)
            if sp.backend == "pallas" and tile is not None:
                assert sp.block_elements == tile[0], s.name
    assert [s.name for s in t_stages] == [s.name for s in r_stages]
    for t_s, r_s in zip(t_stages, r_stages):
        assert t_s.backend == r_s.backend
        t_r = t_patterns.match_gemm_chain(t_s.program)
        r_r = r_patterns.match_gemm_chain(r_s.program)
        assert (t_r is None) == (r_r is None), t_s.name
        if t_r is not None:
            assert dataclasses.astuple(t_r) == dataclasses.astuple(r_r)


def test_fusion_on_the_h100_table():
    """What the h100-sxm datasheet decides at p = 11, n_eq = 2,000,000:
    the named cuts stay (8.831 ms a batch, E = 50,419, not padded), a
    two-stage budget merges interp+grad (12.957), a one-stage budget
    fuses all (17.306, E = 40,335), and the 13-stage auto schedule fuses
    to three stages (48.415 -> 8.831); every fused stage stays on the
    kernel."""
    p, n_eq, h100 = 11, 2_000_000, t_channels.H100_SXM
    named = T_PKG["chain"](p)
    got = {}
    for row in ("named-auto", "named-max2", "named-max1"):
        got[row] = t_chain.plan_chain(named, target=h100, n_eq=n_eq,
                                      **ROWS[row])
    src = t_operators.CFD_PIPELINE_SRC.format(p=p)
    auto = t_flow.compile(src, target=h100, backend="pallas", n_eq=n_eq)
    got["auto-schedule"] = t_chain.plan_chain(auto.chain, target=h100,
                                              n_eq=n_eq, fuse="auto")
    want = {
        "named-auto": ((("interp",), ("grad",), ("helmholtz",)), 8.831,
                       8.831, 50_419),
        "named-max2": ((("interp", "grad"), ("helmholtz",)), 8.831, 12.957,
                       50_419),
        "named-max1": ((("interp", "grad", "helmholtz"),), 8.831, 17.306,
                       40_335),
        "auto-schedule": ((("s0", "s1", "s2"),
                           ("s3", "s4", "s5", "s6", "s7"),
                           ("s8", "s9", "s10", "s11", "s12")), 48.415,
                          8.831, 50_419),
    }
    for row, (groups, t0, t1, e) in want.items():
        spec = got[row].fusion
        assert spec.groups == groups, row
        assert (round(spec.t_unfused * 1e3, 3), round(spec.t_fused * 1e3, 3)
                ) == (t0, t1), row
        assert got[row].batch_elements == e, row
        assert all(s.backend == "pallas" for s in spec.chain.stages), row
    slots = [t_gemm.op_table(t_patterns.match_gemm_chain(s.program))[1]
             for s in got["named-max1"].fusion.chain.stages]
    assert slots == [15]


def test_fuse_auto_max_stages_one_fully_fuses():
    chain = t_operators.build_cfd_chain(5, device="cpu")
    plan = t_fusion.fuse_chain_auto(
        chain, max_stages=1, target=t_channels.ALVEO_U280, n_eq=1 << 12,
    )
    assert plan.fusion is not None
    assert plan.fusion.n_stages_after == len(plan.stages) == 1
    assert plan.fusion.groups == (("interp", "grad", "helmholtz"),)
    assert plan.fusion.fused


def test_fuse_auto_never_merges_across_barrier():
    chain = t_operators.build_cfd_chain(5, device="cpu")
    plan = t_fusion.fuse_chain_auto(
        chain, max_stages=1, barriers=("interp",),
        target=t_channels.ALVEO_U280, n_eq=1 << 12,
    )
    # the boundary after 'interp' survives even under a 1-stage budget
    assert plan.fusion.groups[0] == ("interp",)
    assert len(plan.fusion.groups) == 2
    with pytest.raises(ValueError, match="unknown stages"):
        t_fusion.fuse_chain_auto(chain, barriers=("nosuch",))


def test_fuse_auto_cost_monotonic():
    """The greedy pass only adopts merges the planner prices strictly
    better, so the fused prediction never exceeds the unfused one -- and
    on the dispatch-dominated 13-stage auto schedule it does fuse."""
    system = t_flow.compile(
        t_operators.CFD_PIPELINE_SRC.format(p=5),
        target=t_channels.TPU_V5E, n_eq=1 << 14,
    )
    assert len(system.chain.stages) > 3
    plan = t_fusion.fuse_chain_auto(
        system.chain, target=t_channels.TPU_V5E, n_eq=1 << 14,
    )
    spec = plan.fusion
    assert spec.fused
    assert spec.t_fused < spec.t_unfused
    assert spec.saved_handoff_bytes > 0
    assert plan.cost.t_pipelined == spec.t_fused
    # the fused chain rides along for execution but stays out of equality
    assert spec.chain is not None
    assert len(spec.chain.stages) == spec.n_stages_after


def test_fused_chain_runs_at_its_plan_blocks(rng):
    """The fused chain a plan carries runs the plan's own batches: E = 45
    divides neither the plan's block nor the kernel's default tile, and
    the kernels walk a ragged last tile."""
    p, n = 5, 90
    chain = t_operators.build_cfd_chain(p, backends="pallas", device="cpu")
    plan = t_chain.plan_chain(chain, target=t_channels.CPU_HOST,
                              batch_elements=45, n_eq=n, max_stages=1)
    assert plan.batch_elements == 45 and 45 % 128
    elems, shared = _cfd_data(rng, p, n)
    got = _run(t_simulation, plan.fusion.chain, plan, elems, shared,
               device="cpu")
    base = t_chain.plan_chain(chain, target=t_channels.CPU_HOST,
                              batch_elements=45, n_eq=n)
    want = _run(t_simulation, _helmholtz_on_gemm_chain(chain), base, elems,
                shared, device="cpu")
    for out_var in ("gy", "gz", "v"):
        assert np.array_equal(got[out_var], want[out_var]), out_var


def test_flow_compile_runs_kernel_stages_at_plan_or_pinned_blocks(
        monkeypatch, rng):
    """flow.compile gives a kernel stage the block its plan carries -- on
    the H100 its CUDA kernel's tile -- unless the caller pinned one in
    stage_blocks, which it keeps and the H100 plan carries."""
    from repro_torch.kernels.helmholtz import helmholtz as t_hh

    p, E = 11, 16
    system = t_flow.compile(
        t_operators.CFD_PIPELINE_SRC.format(p=p),
        stages=t_operators.CFD_PIPELINE_STAGES, target=t_channels.H100_SXM,
        backend="pallas", batch_elements=E, n_eq=E,
        stage_blocks={"interp": 2})
    planned = {sp.name: sp.block_elements for sp in system.plan.stages}
    # the pin, and the kernels' default tiles at p = 11 (not E)
    assert planned == {"interp": 2, "grad": 3, "helmholtz": 3}
    calls = {}
    gemm_plain, hh_plain = t_gemm.gemm_chain_plain, t_hh.inverse_helmholtz_plain

    def gemm_spy(recipe, env, *, block_elements):
        stage = "interp" if "A" in env else "grad"
        calls.setdefault(stage, set()).add(block_elements)
        return gemm_plain(recipe, env, block_elements=block_elements)

    def hh_spy(S, D, u, *, block_elements):
        calls.setdefault("helmholtz", set()).add(block_elements)
        return hh_plain(S, D, u, block_elements=block_elements)

    monkeypatch.setattr(t_gemm, "gemm_chain_plain", gemm_spy)
    monkeypatch.setattr(t_hh, "inverse_helmholtz_plain", hh_spy)
    elems, shared = _cfd_data(rng, p, E)
    _run(t_simulation, system.chain, system.plan, elems, shared,
         device="cpu")
    assert calls == {"interp": {2}, "grad": {planned["grad"]},
                     "helmholtz": {planned["helmholtz"]}}


def test_fuse_auto_profile_needs_the_profile_store(tmp_path):
    """Fusion under a profile store: a cold store changes nothing."""
    chain = t_operators.build_cfd_chain(3, device="cpu")
    store = str(tmp_path / "p.json")
    cold = t_fusion.fuse_chain_auto(chain, target=t_channels.CPU_HOST)
    warm = t_fusion.fuse_chain_auto(chain, target=t_channels.CPU_HOST,
                                    profile=store)
    assert warm.signature == cold.signature
    assert warm.report() == cold.report()
    assert t_chain.plan_chain(chain, target=t_channels.CPU_HOST, fuse="auto",
                              profile=store).report() == cold.report()


# ---------------------------------------------------------------------------
# planner/DSE surface (plan_chain fuse=..., explore_chain fuse=...)
# ---------------------------------------------------------------------------


def test_plan_chain_fuse_param():
    chain = t_operators.build_cfd_chain(5, device="cpu")
    t = t_channels.ALVEO_U280
    off = t_chain.plan_chain(chain, target=t, n_eq=1 << 12, fuse="off")
    assert off.fusion is None
    off_budget = t_chain.plan_chain(chain, target=t, n_eq=1 << 12,
                                    fuse="off", max_stages=1)
    assert off_budget.fusion is None and len(off_budget.stages) == 3
    auto = t_chain.plan_chain(chain, target=t, n_eq=1 << 12, fuse="auto")
    assert auto.fusion is not None
    assert auto.fusion.n_stages_before == 3
    assert "fusion: mode=auto" in auto.report()
    # a stage budget below the chain length triggers fusion on its own
    budget = t_chain.plan_chain(chain, target=t, n_eq=1 << 12, max_stages=1)
    assert len(budget.stages) == 1
    with pytest.raises(ValueError, match="fuse"):
        t_chain.plan_chain(chain, target=t, n_eq=1 << 12, fuse="nosuch")
    with pytest.raises(ValueError, match="placement"):
        t_chain.plan_chain(chain, target=t, n_eq=1 << 12, fuse="auto",
                           placement=off.placement)
    with pytest.raises(ValueError, match="per-stage"):
        t_chain.plan_chain(chain, target=t, n_eq=1 << 12, fuse="auto",
                           stage_groups=(0, 0, 0))


def test_explore_chain_prefuses():
    chain = t_operators.build_cfd_chain(5, device="cpu")
    kw = dict(n_eq=1 << 14, fuse="auto")
    space = dict(backends=("xla",), batch_divisors=(1, 2),
                 prefetch_depths=(1,), max_backend_combos=1)
    cands = t_dse.explore_chain(chain, target=t_channels.TPU_V5E,
                                space=t_dse.ChainDesignSpace(**space), **kw)
    assert cands
    for c in cands:
        assert c.plan.fusion is not None
    want = r_dse.explore_chain(
        r_operators.build_cfd_chain(5), target=r_channels.TPU_V5E,
        space=r_dse.ChainDesignSpace(**space), **kw)
    assert [c.plan.signature for c in cands] == \
        [c.plan.signature for c in want]
    assert _spec_view(cands[0].plan.fusion) == _spec_view(want[0].plan.fusion)


# ---------------------------------------------------------------------------
# flow integration (flow.compile fuse=...)
# ---------------------------------------------------------------------------


def test_flow_fuse_auto_bitwise_vs_unfused(rng):
    """flow.compile(fuse='auto') on the auto-scheduled CFD pipeline
    merges stages yet reproduces the unfused outputs bitwise, on the
    kernel stages' plain versions; its report is the reference's."""
    p, E, n = 5, 16, 32
    src = t_operators.CFD_PIPELINE_SRC.format(p=p)
    t = t_channels.TPU_V5E
    kw = dict(target=t, batch_elements=E, n_eq=n, backend="pallas")
    base = t_flow.compile(src, **kw)
    fused = t_flow.compile(src, fuse="auto", **kw)
    assert fused.plan.fusion is not None and fused.plan.fusion.fused
    assert len(fused.chain.stages) < len(base.chain.stages)
    assert set(fused.backends) == {"pallas"}
    assert "fusion: auto" in fused.report()
    assert "fusion:" in fused.plan.report()
    ref = r_flow.compile(r_operators.CFD_PIPELINE_SRC.format(p=p),
                         fuse="auto", **{**kw, "target": r_channels.TPU_V5E})
    assert fused.report() == ref.report()
    assert fused.plan.signature == ref.plan.signature

    elems, shared = _cfd_data(rng, p, n)
    want = _run(t_simulation, base.chain, base.plan, elems, shared,
                device="cpu")
    got = _run(t_simulation, fused.chain, fused.plan, elems, shared,
               device="cpu")
    for out_var in ("gy", "gz", "v"):
        assert np.array_equal(got[out_var], want[out_var]), out_var


def test_flow_named_cuts_are_fusion_barriers():
    """Explicit stage cuts are promises: fuse='auto' never merges across
    them, so the named pipeline comes back structurally untouched."""
    kw = dict(stages=t_operators.CFD_PIPELINE_STAGES, target="alveo-u280",
              fuse="auto")
    system = t_flow.compile(t_operators.CFD_PIPELINE_SRC.format(p=5), **kw)
    assert system.stage_names == ("interp", "grad", "helmholtz")
    spec = system.plan.fusion
    assert spec is not None and not spec.fused
    assert set(spec.barriers) == {"interp", "grad", "helmholtz"}
    ref = r_flow.compile(r_operators.CFD_PIPELINE_SRC.format(p=5), **kw)
    assert system.report() == ref.report()


def test_flow_fuse_validation():
    with pytest.raises(t_flow.FlowError, match="fuse"):
        t_flow.compile(
            t_operators.CFD_PIPELINE_SRC.format(p=3),
            target=t_channels.CPU_HOST, fuse="nosuch",
        )


# ---------------------------------------------------------------------------
# the GEMM-chain kernel takes every fused recipe (no card needed)
# ---------------------------------------------------------------------------


def _fused_recipes(p):
    """Every recipe the reference's matcher accepts for the fused stages
    of the table's rows, on the h100-sxm datasheet at p."""
    h100 = _r_target("h100-sxm")
    named = r_operators.build_cfd_chain(p, backends="pallas")
    plans = [r_chain.plan_chain(named, target=h100, n_eq=2_000_000,
                                max_stages=k) for k in (2, 1)]
    src = r_operators.CFD_PIPELINE_SRC.format(p=p)
    auto = r_flow.compile(src, target=h100, backend="pallas",
                          n_eq=2_000_000, fuse="auto")
    stages = [s for plan in plans for s in plan.fusion.chain.stages
              if "+" in s.name] + [s for s in auto.chain.stages]
    out = {}
    for s in stages:
        r = r_patterns.match_gemm_chain(s.program)
        if r is not None:
            out[s.name] = t_gemm.GemmRecipe(*dataclasses.astuple(r))
    return out


@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("p", [5, 11, 16])
def test_gemm_kernel_lowers_every_fused_recipe(p, elem_bytes):
    """Each fused recipe lowers through op_table, buffer_table and
    kernel_tile within the kernel's static limits and one CTA's shared
    memory; the fully fused stage needs 15 element slots (the limit was
    8 before it was lifted to MAX_IN + MAX_OPS)."""
    recipes = _fused_recipes(p)
    assert "interp+grad+helmholtz" in recipes
    assert t_gemm.MAX_SLOTS == t_gemm.MAX_IN + t_gemm.MAX_OPS == 40
    for name, recipe in recipes.items():
        _, n_slots, _, ops, _, out_slot = t_gemm.op_table(recipe)
        slot_buf, n_bufs = t_gemm.buffer_table(recipe)
        assert len(slot_buf) == n_slots and n_bufs <= n_slots
        te, threads, smem = t_gemm.kernel_tile(recipe, elem_bytes)
        assert te >= 1 and smem <= t_gemm.MAX_SHARED_BYTES, name
        args = t_gemm.chain_args(recipe, [0] * len(recipe.inputs),
                                 [0] * len(recipe.outputs))
        assert (args.n_slots, args.n_ops, args.n_bufs) == (
            n_slots, len(ops), n_bufs)
    full = recipes["interp+grad+helmholtz"]
    assert t_gemm.op_table(full)[1] == 15 > 8
