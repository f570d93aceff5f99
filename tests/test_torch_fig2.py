"""The paper's Fig. 2 path in the port, held against the reference on the
CPU: the single-operator builders on every backend, the staged backend's
stage callables, ``run_simulation`` over the same numpy streams, and the
single-operator design-space sweep with its measured cost correction."""
import warnings

import numpy as np
import pytest
import torch

from repro.cfd import operators as r_operators
from repro.cfd import simulation as r_simulation
from repro.core.precision import FIXED32 as R_FIXED32
from repro.core.precision import enable_x64
from repro.memory import channels as r_channels
from repro.memory import dse as r_dse
from repro_torch.cfd import operators as t_operators
from repro_torch.cfd import reference
from repro_torch.cfd import simulation as t_simulation
from repro_torch.core.precision import FIXED32
from repro_torch.kernels.helmholtz import helmholtz as t_hh
from repro_torch.memory import channels as t_channels
from repro_torch.memory import dse as t_dse

# float32 on both sides, summed in different orders (the chain tests')
RTOL, ATOL_FRAC = 5e-4, 5e-4
TOL64 = 1e-12


def _close(got, want, rtol=RTOL, atol_frac=ATOL_FRAC):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * np.abs(want).max())


def _helmholtz_env(p, E, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"S": rng.uniform(-1, 1, (p, p)).astype(dtype),
            "D": rng.uniform(-1, 1, (E, p, p, p)).astype(dtype),
            "u": rng.uniform(-1, 1, (E, p, p, p)).astype(dtype)}


BUILD_CASES = [("float32", "xla"), ("float32", "staged"), ("float32", "pallas"),
               ("float64", "xla"), ("float64", "staged")]


@pytest.mark.parametrize("policy,backend", BUILD_CASES,
                         ids=["-".join(c) for c in BUILD_CASES])
@pytest.mark.parametrize("p", [5, 7])
def test_build_inverse_helmholtz_matches_reference(p, policy, backend):
    E = 6
    dtype = np.float64 if policy == "float64" else np.float32
    env = _helmholtz_env(p, E, p, dtype)
    with enable_x64(policy == "float64"):
        r_fn = r_operators.build_inverse_helmholtz(p, policy=policy,
                                                   backend=backend)
        want = np.asarray(r_fn.batched_fn(env)["v"])
    t_fn = t_operators.build_inverse_helmholtz(
        p, policy=policy, backend=backend, block_elements=3, device="cpu")
    assert t_fn.backend == backend
    got = t_fn.batched_fn(env)["v"]
    assert got.dtype == getattr(torch, policy)
    oracle = reference.inverse_helmholtz_batch(
        *(env[k].astype(np.float64) for k in ("S", "D", "u")))
    tol = (TOL64, TOL64) if policy == "float64" else (RTOL, ATOL_FRAC)
    _close(got.numpy(), want, *tol)
    _close(got.numpy(), oracle, *tol)
    if backend == "staged":
        assert len(t_fn.stage_fns) == len(r_fn.stage_fns) == len(
            t_fn.schedule.groups)


@pytest.mark.parametrize("backend", ["xla", "staged"])
def test_build_interpolation_and_gradient_match_reference(backend, rng):
    n, m = 7, 9
    A = rng.uniform(-1, 1, (m, n)).astype(np.float32)
    u = rng.uniform(-1, 1, (3, n, n, n)).astype(np.float32)
    r_fn = r_operators.build_interpolation(n, m, backend=backend)
    t_fn = t_operators.build_interpolation(n, m, backend=backend, device="cpu")
    want = np.asarray(r_fn.batched_fn({"A": A, "u": u})["v"])
    _close(t_fn.batched_fn({"A": A, "u": u})["v"].numpy(), want)
    _close(want, reference.interpolation_batch(A.astype(np.float64),
                                               u.astype(np.float64)))
    nx, ny, nz = 8, 7, 6
    env = {"Dx": rng.uniform(-1, 1, (nx, nx)), "Dy": rng.uniform(-1, 1, (ny, ny)),
           "Dz": rng.uniform(-1, 1, (nz, nz)),
           "u": rng.uniform(-1, 1, (2, nx, ny, nz))}
    env = {k: v.astype(np.float32) for k, v in env.items()}
    r_out = r_operators.build_gradient(nx, ny, nz, backend=backend).batched_fn(env)
    t_out = t_operators.build_gradient(nx, ny, nz, backend=backend,
                                       device="cpu").batched_fn(env)
    assert set(t_out) == {"gx", "gy", "gz"}
    for k in t_out:
        _close(t_out[k].numpy(), np.asarray(r_out[k]))


def test_staged_stage_fns_thread_live_values():
    """Each stage is a plain callable, list in and list out; called by
    hand in schedule order they give batched_fn's result bit for bit, and
    element_fn runs one element through the same stages."""
    p, E = 5, 4
    c = t_operators.build_inverse_helmholtz(p, backend="staged", device="cpu")
    env = {k: torch.from_numpy(v) for k, v in _helmholtz_env(p, E, 0).items()}
    want = c.batched_fn(env)["v"]
    prog = c.program
    live = {prog.inputs[k].uid: v for k, v in env.items()}
    for fn, group in zip(c.stage_fns, c.schedule.groups):
        outs = fn([live[n.uid] for n in group.in_streams], True)
        assert isinstance(outs, list) and len(outs) == len(group.out_streams)
        live.update(zip([n.uid for n in group.out_streams], outs))
    assert live[prog.outputs["v"].uid].equal(want)
    one = c.element_fn({"S": env["S"], "D": env["D"][1], "u": env["u"][1]})
    _close(one["v"].numpy(), want[1].numpy())
    xla = t_operators.build_inverse_helmholtz(p, device="cpu").batched_fn(env)
    assert xla["v"].equal(want)


def test_pallas_block_from_plan():
    plan = t_dse.make_plan(11, target=t_channels.H100_SXM)
    r_plan = r_dse.make_plan(11, target=r_channels.ALVEO_U280)
    assert t_operators.pallas_block_elements(11, plan) == plan.block_elements
    assert r_operators.pallas_block_elements(
        11, r_plan) == t_operators.pallas_block_elements(11, r_plan)
    for kw in (dict(vmem_bytes=232_448), dict(vmem_bytes=16 << 20)):
        assert t_operators.pallas_block_elements(
            7, **kw) == r_operators.pallas_block_elements(7, **kw)
    # with neither, the reference's Pallas default (128) is no CUDA tile:
    # the port leaves the block to the kernel's own default tile
    assert t_operators.pallas_block_elements(7) is None
    assert r_operators.pallas_block_elements(7) == 128


def test_simconfig_and_plan_config_match_reference():
    for p, bps in ((11, 4), (11, 8), (7, 2)):
        assert t_simulation.SimConfig.batch_for_channel(
            p, bytes_per_scalar=bps) == r_simulation.SimConfig.batch_for_channel(
            p, bytes_per_scalar=bps)
    kw = dict(p=7, n_eq=1 << 16, batch_elements=None, prefetch_depth=2,
              policy="bfloat16", backend="staged")
    t_cfg, r_cfg = t_simulation.SimConfig(**kw), r_simulation.SimConfig(**kw)
    assert t_cfg.depth == r_cfg.depth == 2
    assert t_cfg.bytes_per_element(2) == r_cfg.bytes_per_element(2)
    with pytest.raises(ValueError, match="batch_elements"):
        t_cfg.n_batches
    t_plan = t_simulation.plan_config(t_cfg, target=t_channels.ALVEO_U280)
    r_plan = r_simulation.plan_config(r_cfg, target=r_channels.ALVEO_U280)
    assert t_plan.signature == r_plan.signature
    assert t_plan.report() == r_plan.report()
    # the h100-sxm plan of the Fig. 2 path at p = 11
    h = t_simulation.plan_config(t_simulation.SimConfig(p=11),
                                 target=t_channels.H100_SXM)
    assert (h.batch_elements, h.block_elements) == (67_226, 2)
    # on the pallas backend the block is the Helmholtz kernel's tile
    k = t_simulation.plan_config(
        t_simulation.SimConfig(p=11, backend="pallas"),
        target=t_channels.H100_SXM)
    assert (k.batch_elements, k.block_elements,
            k.block_working_set_bytes) == (67_226, 3, 49_040)


SIM_CASES = [
    pytest.param("xla", 1, id="xla-K1"),
    pytest.param("staged", 0, id="staged-K0"),
    pytest.param("pallas", 2, id="pallas-K2"),
]


@pytest.mark.parametrize("backend,depth", SIM_CASES)
def test_run_simulation_checksum_matches_reference(backend, depth):
    """Equal (p, E, seed): the same numpy streams, checksums within rel
    1e-4 (both sum float32 in their own order); K = 0 equals K bit for
    bit."""
    kw = dict(p=5, n_eq=4 * 16, batch_elements=16, backend=backend,
              prefetch_depth=depth, seed=3)
    want = r_simulation.run_simulation(r_simulation.SimConfig(**kw),
                                       max_batches=3)
    got = t_simulation.run_simulation(t_simulation.SimConfig(**kw),
                                      max_batches=3, device="cpu")
    assert (got.batches, got.elements) == (want.batches, want.elements) == (3, 48)
    assert got.device == "cpu" and got.plan.signature == want.plan.signature
    assert got.checksum == pytest.approx(want.checksum, rel=1e-4)
    serial = t_simulation.run_simulation(
        t_simulation.SimConfig(**{**kw, "prefetch_depth": 0}), max_batches=3,
        device="cpu")
    assert serial.checksum == got.checksum
    assert got.gflops == pytest.approx(got.elements * 1e-9 / got.wall_s)
    assert t_simulation.achieved_gflops(got, 5) == pytest.approx(
        got.elements * t_operators.flops_per_element(5) / got.wall_s / 1e9)


def test_run_simulation_batches_and_explicit_S():
    cfg = t_simulation.SimConfig(p=5, n_eq=512, batch_elements=128)
    assert cfg.n_batches == 4
    res = t_simulation.run_simulation(cfg, max_batches=2, device="cpu")
    assert res.elements == 256 and np.isfinite(res.checksum)
    S = np.eye(5, dtype=np.float32)
    one = t_simulation.run_simulation(
        t_simulation.SimConfig(p=5, n_eq=16, batch_elements=16),
        S=S, device="cpu")
    b0 = next(t_simulation._batch_generator(5, 16, 1, 0))
    want = reference.inverse_helmholtz_batch(S.astype(np.float64),
                                             b0["D"].astype(np.float64),
                                             b0["u"].astype(np.float64))
    assert one.checksum == pytest.approx(want.sum(), rel=1e-5)


def test_run_simulation_fixed_point_encodes_on_the_host():
    """Under Q8.24 the host encodes each batch; the checksum is the sum
    of the decoded outputs, which equal the reference's bit for bit."""
    p, E, n = 3, 8, 2
    cfg = t_simulation.SimConfig(p=p, n_eq=E * n, batch_elements=E,
                                 policy="fixed32_q8.24", seed=5)
    got = t_simulation.run_simulation(cfg, device="cpu")
    r_fn = r_operators.build_inverse_helmholtz(p, policy=R_FIXED32)
    S = np.random.default_rng(5 + 2 ** 31).uniform(-1, 1, (p, p)).astype(
        np.float32)
    total = 0.0
    with enable_x64(True):
        for b in r_simulation._batch_generator(p, E, n, 5):
            env = {k: R_FIXED32.encode(v) for k, v in {"S": S, **b}.items()}
            v = np.array(r_fn.batched_fn(env)["v"])
            total += float(FIXED32.decode(torch.from_numpy(v)).sum())
    assert got.checksum == pytest.approx(total, rel=1e-12)


def test_run_simulation_needs_the_card_unless_cpu_is_asked():
    cfg = t_simulation.SimConfig(p=3, n_eq=8, batch_elements=8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_simulation.run_simulation(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_operators.build_inverse_helmholtz(3)
    from repro_torch import trace

    tracer = trace.Tracer()
    t_simulation.run_simulation(cfg, device="cpu", tracer=tracer)
    assert [s.name for s in tracer.spans] == ["stage b0", "b0", "sync b0"]
    plan = t_simulation.plan_config(cfg, target=t_channels.CPU_HOST, cu_count=2)
    with pytest.warns(RuntimeWarning, match="2 CUs"):
        res = t_simulation.run_simulation(cfg, plan=plan, device="cpu")
    assert res.batches == 1


def test_run_simulation_runs_two_cus_on_a_two_slot_pool():
    """The plan of the test above on a pool of two host slots: no
    warning, each batch sharded over both, the checksum the one slot's
    within the per-shard summation order."""
    cfg = t_simulation.SimConfig(p=3, n_eq=8, batch_elements=8)
    plan = t_simulation.plan_config(cfg, target=t_channels.CPU_HOST, cu_count=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        res = t_simulation.run_simulation(cfg, plan=plan,
                                          devices=["cpu", "cpu"])
    assert res.batches == 1 and res.devices == ("cpu", "cpu")
    base = t_simulation.run_simulation(cfg, device="cpu")
    assert res.checksum == pytest.approx(base.checksum, rel=1e-4)


def test_pallas_path_launches_the_kernel_wrapper(monkeypatch):
    """On CPU tensors the pallas backend runs the kernel's plain version
    through the kernel's wrapper: at the plan's block on the H100, whose
    plan carries the kernel's tile, and at the kernel's default tile
    (None) on a reference datasheet, whose block is a VMEM block."""
    calls = []
    inner = t_hh.inverse_helmholtz_plain

    def spy(S, D, u, *, block_elements):
        calls.append((tuple(u.shape), block_elements))
        return inner(S, D, u, block_elements=block_elements)

    monkeypatch.setattr(t_hh, "inverse_helmholtz_plain", spy)
    cfg = t_simulation.SimConfig(p=5, n_eq=48, batch_elements=16,
                                 backend="pallas")
    for target, want in ((t_channels.H100_SXM, "plan"),
                         (t_channels.CPU_HOST, None)):
        calls.clear()
        plan = t_simulation.plan_config(cfg, target=target)
        assert plan.block_elements
        t_simulation.run_simulation(cfg, plan=plan, device="cpu")
        be = plan.block_elements if want == "plan" else None
        assert calls == [((16, 5, 5, 5), be)] * 3, target.name


EXPLORE_CASES = {
    "alveo-u280": dict(p=7, n_eq=1 << 14, space=None),
    "cpu-host": dict(p=5, n_eq=1 << 12, space=dict(
        backends=("xla", "staged", "pallas"),
        policies=("float32", "fixed32_q8.24", "fixed64_q24.40"),
        batch_divisors=(1, 3), prefetch_depths=(0, 1), cu_counts=(1, 2))),
}


@pytest.mark.parametrize("target", sorted(EXPLORE_CASES))
def test_explore_matches_reference(target):
    case = EXPLORE_CASES[target]
    kw = dict(n_eq=case["n_eq"])
    t_kw, r_kw = dict(kw), dict(kw)
    if case["space"]:
        t_kw["space"] = t_dse.DesignSpace(**case["space"])
        r_kw["space"] = r_dse.DesignSpace(**case["space"])
    want = r_dse.explore(case["p"], target=r_channels.TARGETS[target], **r_kw)
    got = t_dse.explore(case["p"], target=t_channels.TARGETS[target], **t_kw)
    assert [c.plan.signature for c in got] == [c.plan.signature for c in want]
    assert [c.predicted_s_per_element for c in got] == [
        c.predicted_s_per_element for c in want]
    assert [c.plan.feasible for c in got] == [c.plan.feasible for c in want]
    assert t_dse.format_ranking(got, 20) == r_dse.format_ranking(want, 20)
    assert [c.plan.signature for c in t_dse.pareto_front(got)] == [
        c.plan.signature for c in r_dse.pareto_front(want)]


def _measured(mod, plans, ratios):
    return [mod.Candidate(plan=pl, predicted_s_per_element=1e-6 * (i + 1),
                          measured_s_per_element=(
                              None if r is None else r * 1e-6 * (i + 1)))
            for i, (pl, r) in enumerate(zip(plans, ratios))]


def test_fit_and_apply_correction_match_reference():
    """The per-term fit and the re-rank on the same measured candidates:
    host-link, HBM and compute-bound plans, one unmeasured."""
    plans = [t_dse.make_plan(7, target=t_channels.ALVEO_U280, batch_elements=e,
                             prefetch_depth=k, policy=pol)
             for e, k, pol in ((4096, 1, "float32"), (4096, 0, "float64"),
                               (1024, 1, "fixed64_q24.40"),
                               (2048, 2, "bfloat16"))]
    assert len({pl.cost.bottleneck for pl in plans}) >= 2
    ratios = [2.0, 8.0, None, 0.5]
    t_c, r_c = _measured(t_dse, plans, ratios), _measured(r_dse, plans, ratios)
    t_fit, r_fit = t_dse.fit_correction(t_c), r_dse.fit_correction(r_c)
    for field in ("factor", "n_samples", "host_factor", "hbm_factor",
                  "compute_factor"):
        assert getattr(t_fit, field) == pytest.approx(getattr(r_fit, field))
    t_dse.apply_correction(t_c, t_fit)
    r_dse.apply_correction(r_c, r_fit)
    assert [c.predicted_s_per_element for c in t_c] == [
        c.predicted_s_per_element for c in r_c]
    assert [c.corrected_s_per_element for c in t_c] == pytest.approx(
        [c.corrected_s_per_element for c in r_c])
    assert t_dse.fit_correction(
        _measured(t_dse, plans, [None] * 4)) == t_dse.CostCorrection()
    with pytest.raises(ValueError, match="measure_top"):
        t_dse.explore(5, target=t_channels.CPU_HOST, n_eq=64, calibrate=True)


def test_explore_measures_and_calibrates_on_the_cpu():
    space = t_dse.DesignSpace(backends=("xla", "staged", "pallas"),
                              policies=("float32",), batch_divisors=(1, 2),
                              prefetch_depths=(0, 1), cu_counts=(1, 2))
    cands = t_dse.explore(5, target=t_channels.CPU_HOST, n_eq=128,
                          space=space, measure_top=3, measure_batches=2,
                          calibrate=True, device="cpu")
    measured = [c for c in cands if c.verified]
    assert len(measured) == 3
    assert all(c.plan.cu_count == 1 and c.measured_s_per_element > 0
               for c in measured)
    assert all(c.corrected_s_per_element is not None for c in cands)
    feas = [c.plan.feasible for c in cands]
    assert feas == sorted(feas, reverse=True)


def test_measure_plan_propagates_errors(monkeypatch):
    """Only a plan for more devices than there are gives None; a failing
    run (here an injected kernel error) propagates."""
    plan = t_dse.make_plan(5, target=t_channels.CPU_HOST, batch_elements=16,
                           backend="pallas")
    assert t_dse.measure_plan(plan, 5, max_batches=1, device="cpu") > 0
    wide = t_dse.make_plan(5, target=t_channels.CPU_HOST, batch_elements=16,
                           cu_count=2)
    assert t_dse.measure_plan(wide, 5, device="cpu") is None

    def broken(*args, **kwargs):
        raise RuntimeError("helmholtz: kernel launch failed")

    monkeypatch.setattr(t_hh, "inverse_helmholtz_plain", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        t_dse.measure_plan(plan, 5, max_batches=1, device="cpu")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        t_dse.explore(5, target=t_channels.CPU_HOST, n_eq=64, device="cpu",
                      space=t_dse.DesignSpace(backends=("pallas",),
                                              policies=("float32",)),
                      measure_top=1, measure_batches=1)


def test_measure_plan_times_two_cus_on_a_two_slot_pool(monkeypatch):
    """The wide plan of test_measure_plan_propagates_errors on two host
    slots: a time, not None; the kernel's error still propagates there."""
    wide = t_dse.make_plan(5, target=t_channels.CPU_HOST, batch_elements=16,
                           cu_count=2, backend="pallas")
    got = t_dse.measure_plan(wide, 5, max_batches=1, devices=["cpu", "cpu"])
    assert got is not None and got > 0

    def broken(*args, **kwargs):
        raise RuntimeError("helmholtz: kernel launch failed")

    monkeypatch.setattr(t_hh, "inverse_helmholtz_plain", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        t_dse.measure_plan(wide, 5, max_batches=1, devices=["cpu", "cpu"])
