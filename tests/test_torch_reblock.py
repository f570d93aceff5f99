"""Per-stage batch sizes in the port: ``memory.pipeline.reblock_batched_fn``
and ``cfd.simulation.run_chain`` on plans whose stages run their own E_s.

The reference's re-blocking property (``tests/test_hetero.py``: per-stage
divisors {1, 2, 4, 8}^3 x ring depths {0, 1, 2}^3, bitwise against the
uniform serial run) fails there under XLA's CPU path; the port's kernels
and plain versions sum in one fixed order, so here it passes bit for bit
-- on the kernel stages and on the ``xla`` stages alike.  The uniform
run itself is held against the reference's on the same numpy inputs,
and ``measure_chain_plan`` / ``explore_chain`` time per-stage-E plans on
the one device.
"""
import numpy as np
import pytest
import torch

from repro.cfd import operators as r_operators
from repro.cfd import simulation as r_simulation
from repro.memory import chain as r_chain
from repro.memory import channels as r_channels
from repro_torch.cfd import operators as t_operators
from repro_torch.cfd import simulation as t_simulation
from repro_torch.memory import chain as t_chain
from repro_torch.memory import channels as t_channels
from repro_torch.memory import dse as t_dse
from repro_torch.memory import pipeline as t_pipeline
from repro_torch.memory.placement import DeviceTopology as TTopology

#: float32 results of both packages sum in different orders
RTOL, ATOL_FRAC = 5e-4, 5e-4

_CACHE = {}


def _fixture(backend):
    """The chain at p = 5, E = 16, two batches, its numpy inputs from a
    seed, and its uniform serial outputs (K = 0)."""
    if backend not in _CACHE:
        p, E, n_b = 5, 16, 2
        n = E * n_b
        ch = t_operators.build_cfd_chain(p, backends=backend, device="cpu")
        rng = np.random.default_rng(3)
        inputs = {
            "interp.u": rng.uniform(-1, 1, (n, p, p, p)).astype(np.float32),
            "helmholtz.D": rng.uniform(-1, 1, (n, p, p, p)).astype(np.float32),
        }
        shared = {
            name: rng.uniform(-1, 1, node.shape).astype(np.float32)
            for name, node in sorted(ch.shared_operands().items())
        }
        base_plan = t_chain.plan_chain(
            ch, target=t_channels.CPU_HOST, batch_elements=E, n_eq=n,
            prefetch_depth=0)
        base = t_simulation.run_chain(
            ch, base_plan, inputs=inputs, shared=shared,
            collect_outputs=True, pipeline_stages=False, device="cpu")
        _CACHE[backend] = (ch, E, n, inputs, shared, base.outputs)
    return _CACHE[backend]


def _check_reblocked_bitwise(divs, depths, backend="pallas"):
    ch, E, n, inputs, shared, want = _fixture(backend)
    plan = t_chain.plan_chain(
        ch, target=t_channels.CPU_HOST, batch_elements=E, n_eq=n,
        prefetch_depth=list(depths),
        stage_batch_elements=[E // d for d in divs])
    assert plan.feasible
    assert plan.uniform_batch == (divs == (1, 1, 1))
    got = t_simulation.run_chain(ch, plan, inputs=inputs, shared=shared,
                                 collect_outputs=True, device="cpu")
    for q in want:
        assert np.array_equal(want[q], got.outputs[q]), (q, divs, depths)


try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - the container has hypothesis
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:

    @given(
        divs=st.tuples(*[st.sampled_from([1, 2, 4, 8])] * 3),
        depths=st.tuples(*[st.integers(0, 2)] * 3),
    )
    @settings(max_examples=10, deadline=None)
    def test_reblocked_execution_bitwise_equal_property(divs, depths):
        _check_reblocked_bitwise(divs, depths)

else:  # deterministic fallback so the property still runs everywhere

    @pytest.mark.parametrize("divs,depths", [
        ((1, 1, 1), (1, 1, 1)),
        ((2, 1, 4), (2, 0, 1)),
        ((8, 2, 1), (0, 1, 2)),
        ((4, 4, 4), (1, 1, 1)),
        ((1, 8, 2), (2, 2, 2)),
    ])
    def test_reblocked_execution_bitwise_equal_property(divs, depths):
        _check_reblocked_bitwise(divs, depths)


@pytest.mark.parametrize("backend", ["xla", "staged", "pallas"])
@pytest.mark.parametrize("divs,depths", [
    ((2, 1, 4), (2, 0, 1)),
    ((8, 2, 1), (0, 1, 2)),
    ((1, 8, 2), (2, 2, 2)),
])
def test_reblocked_execution_bitwise_on_every_backend(divs, depths, backend):
    """The property's fallback cases on each backend: re-blocking changes
    the dispatch granularity, never a bit of the outputs."""
    _check_reblocked_bitwise(divs, depths, backend)


def test_uniform_run_matches_the_reference():
    """The serial run the property compares against equals the
    reference's on the same numpy inputs, within float32 summation
    order."""
    ch, E, n, inputs, shared, want = _fixture("pallas")
    r_ch = r_operators.build_cfd_chain(5, backends="pallas")
    r_plan = r_chain.plan_chain(r_ch, target=r_channels.CPU_HOST,
                                batch_elements=E, n_eq=n, prefetch_depth=0)
    ref = r_simulation.run_chain(r_ch, r_plan, inputs=inputs, shared=shared,
                                 collect_outputs=True, pipeline_stages=False)
    assert set(ref.outputs) == set(want)
    for q, v in want.items():
        r = np.asarray(ref.outputs[q])
        np.testing.assert_allclose(v, r, rtol=RTOL,
                                   atol=ATOL_FRAC * np.abs(r).max())


def test_reblock_batched_fn_slices_element_keys_and_passes_shared_whole():
    calls = []

    def fn(env):
        calls.append({k: tuple(v.shape) for k, v in env.items()})
        return {"y": env["x"] * env["s"].sum(), "z": env["x"] + 1}

    x = torch.arange(10 * 3, dtype=torch.float32).reshape(10, 3)
    s = torch.ones(2, 2)
    whole = fn({"x": x, "s": s})
    calls.clear()
    got = t_pipeline.reblock_batched_fn(fn, ("x",), 4)({"x": x, "s": s})
    # chunks of 4, 4 and a ragged 2; the shared operand passes whole
    assert [c["x"] for c in calls] == [(4, 3), (4, 3), (2, 3)]
    assert all(c["s"] == (2, 2) for c in calls)
    for k in whole:
        assert torch.equal(got[k], whole[k])
    calls.clear()
    small = t_pipeline.reblock_batched_fn(fn, ("x",), 10)
    assert torch.equal(small({"x": x, "s": s})["y"], whole["y"])
    assert [c["x"] for c in calls] == [(10, 3)]


@pytest.mark.parametrize("stage", ["interp", "grad", "helmholtz"])
def test_reblocked_kernel_stages_write_into_the_batch_outputs(stage,
                                                              monkeypatch):
    """With ``outputs`` a kernel stage's chunks write through ``out=``
    into slices of one batch output (no torch.cat, no copy on the card),
    bitwise the whole batch's call, ragged last chunk included."""
    from repro_torch.flow import patterns as t_patterns

    ch, E, _, _, _, _ = _fixture("pallas")
    prog = {s.name: s.program for s in ch.stages}[stage]
    impl = t_patterns.pallas_impl_for(prog)
    gen = torch.Generator().manual_seed(3)
    elem = set(prog.element_vars)
    env = {n: torch.rand(((E,) if n in elem else ()) + tuple(v.shape),
                         generator=gen) * 2 - 1
           for n, v in prog.inputs.items()}
    whole = impl(env)
    slices = []

    def spy(sub_env, out=None):
        slices.append({k: v.data_ptr() for k, v in out.items()})
        return impl(sub_env, out=out)

    def no_cat(*a, **k):
        raise AssertionError("torch.cat on the out= path")

    monkeypatch.setattr(t_pipeline.torch, "cat", no_cat)
    shapes = {n: tuple(v.shape) for n, v in prog.outputs.items()}
    got = t_pipeline.reblock_batched_fn(spy, tuple(elem), 6,
                                        outputs=shapes)(env)
    assert len(slices) == 3  # 6, 6 and a ragged 4
    for q, v in whole.items():
        assert torch.equal(got[q], v), q
        step = 6 * got[q][0].numel() * got[q].element_size()
        assert [sl[q] for sl in slices] == [
            got[q].data_ptr() + i * step for i in range(3)]


def test_kernel_wrappers_write_into_out():
    """``out=`` receives the result and is returned; a wrong shape or
    dtype is refused."""
    from repro_torch.flow import patterns as t_patterns
    from repro_torch.kernels.gemm import gemm as t_gemm
    from repro_torch.kernels.helmholtz import helmholtz as t_hh

    gen = torch.Generator().manual_seed(4)
    S = torch.rand(5, 5, generator=gen)
    D, u = (torch.rand(7, 5, 5, 5, generator=gen) for _ in range(2))
    want = t_hh.inverse_helmholtz(S, D, u)
    out = torch.empty_like(u)
    assert t_hh.inverse_helmholtz(S, D, u, out=out) is out
    assert torch.equal(out, want)
    for bad in (torch.empty(6, 5, 5, 5), torch.empty_like(u, dtype=torch.float64)):
        with pytest.raises(ValueError, match="out"):
            t_hh.inverse_helmholtz(S, D, u, out=bad)
    ch, E, _, _, _, _ = _fixture("pallas")
    prog = {s.name: s.program for s in ch.stages}["grad"]
    recipe = t_patterns.match_gemm_chain(prog)
    env = {n: torch.rand(((E,) + tuple(v.shape)) if n in prog.element_vars
                         else tuple(v.shape), generator=gen)
           for n, v in prog.inputs.items()}
    want = t_gemm.gemm_chain(recipe, env)
    outs = {n: torch.empty_like(v) for n, v in want.items()}
    got = t_gemm.gemm_chain(recipe, env, out=outs)
    assert all(got[n] is outs[n] and torch.equal(outs[n], want[n])
               for n in want)
    with pytest.raises(ValueError, match="out"):
        t_gemm.gemm_chain(recipe, env, out={n: v[:1] for n, v in outs.items()})


def test_run_chain_dispatches_each_stage_at_its_batch(monkeypatch):
    """A stage at E_s = E / 4 runs four kernel calls a chain batch, the
    others one."""
    from repro_torch.kernels.gemm import gemm as t_gemm
    from repro_torch.kernels.helmholtz import helmholtz as t_hh

    ch, E, n, inputs, shared, want = _fixture("pallas")
    seen = []
    gemm_plain, hh_plain = t_gemm.gemm_chain_plain, t_hh.inverse_helmholtz_plain

    def gemm_spy(recipe, env, *, block_elements):
        seen.append(("interp" if "A" in env else "grad",
                     next(v.shape[0] for v in env.values() if v.dim() == 4)))
        return gemm_plain(recipe, env, block_elements=block_elements)

    def hh_spy(S, D, u, *, block_elements):
        seen.append(("helmholtz", u.shape[0]))
        return hh_plain(S, D, u, block_elements=block_elements)

    monkeypatch.setattr(t_gemm, "gemm_chain_plain", gemm_spy)
    monkeypatch.setattr(t_hh, "inverse_helmholtz_plain", hh_spy)
    plan = t_chain.plan_chain(ch, target=t_channels.CPU_HOST,
                              batch_elements=E, n_eq=n, prefetch_depth=0,
                              stage_batch_elements=(E, E // 4, E // 2))
    got = t_simulation.run_chain(ch, plan, inputs=inputs, shared=shared,
                                 collect_outputs=True, max_batches=1,
                                 pipeline_stages=False, device="cpu")
    assert seen == ([("interp", E)] + [("grad", E // 4)] * 4
                    + [("helmholtz", E // 2)] * 2)
    for q, v in got.outputs.items():
        assert np.array_equal(v, want[q][:E]), q


def test_measure_chain_plan_times_a_per_stage_batch_plan():
    ch, E, n, _, _, _ = _fixture("pallas")
    plan = t_chain.plan_chain(ch, target=t_channels.CPU_HOST,
                              batch_elements=E, n_eq=n,
                              stage_batch_elements=(E // 4, E, E // 2))
    assert not plan.uniform_batch
    got = t_dse.measure_chain_plan(ch, plan, max_batches=2, device="cpu")
    assert got is not None and got > 0


def test_explore_chain_measures_its_per_stage_batch_candidates():
    """On a two-kind topology the joint (group, E_s) search ranks plans
    with per-stage batch sizes; those on the first device are measured
    like any other candidate (placements on the second device are
    element-axis placement, not ported, and stay unmeasured)."""
    ch = t_operators.build_cfd_chain(3, backends="pallas", device="cpu")
    cands = t_dse.explore_chain(
        ch, target=t_channels.CPU_HOST, n_eq=64,
        topology=TTopology.parse("tpu:1,cpu:1"),
        space=t_dse.ChainDesignSpace(backends=("pallas",),
                                     batch_divisors=(1, 2, 4),
                                     prefetch_depths=(0, 1),
                                     max_placements=8),
        measure_top=12, measure_batches=1, device="cpu")
    hetero_e = [c for c in cands[:12] if not c.plan.uniform_batch
                and c.plan.placement.devices_used[-1] == 0]
    assert hetero_e and all(c.verified for c in hetero_e)
    assert all(c.measured_s_per_element > 0 for c in hetero_e)
