"""The slice end to end on the CPU: the paper's interp -> grad ->
Helmholtz pipeline compiled with kernel stages and run by both packages
on the same numpy inputs and shared operands, against each other and
the float64 numpy oracles; pipelined and serial schedules bitwise equal."""
import numpy as np
import pytest
import torch

from repro.cfd import operators as r_operators
from repro_torch.cfd import operators as t_operators
from repro_torch.cfd import reference, simulation
from repro_torch.kernels.gemm import gemm as t_gemm
from repro_torch.kernels.helmholtz import helmholtz as t_hh

P, E, N_BATCHES = 5, 16, 3
COMPILE = dict(backends="pallas", target="cpu-host", batch_elements=E,
               n_eq=E * N_BATCHES)
# both sum in float32 in different orders
RTOL, ATOL_FRAC = 5e-4, 5e-4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    n = E * N_BATCHES
    inputs = {q: rng.uniform(-1, 1, (n, P, P, P)).astype(np.float32)
              for q in ("interp.u", "helmholtz.D")}
    shared = {k: rng.uniform(-1, 1, (P, P)).astype(np.float32)
              for k in ("A", "Dx", "Dy", "Dz", "S")}
    return inputs, shared


@pytest.fixture(scope="module")
def port_system():
    return t_operators.compile_cfd_pipeline(P, **COMPILE)


@pytest.fixture(scope="module")
def port_run(port_system, data):
    inputs, shared = data
    return port_system.run(inputs=inputs, shared=shared, collect_outputs=True,
                           device="cpu")


def _oracle(inputs, shared):
    f = {k: v.astype(np.float64) for k, v in shared.items()}
    w = reference.interpolation_batch(f["A"], inputs["interp.u"].astype(np.float64))
    gx = np.einsum("al,elyz->eayz", f["Dx"], w)
    return {
        "grad.gy": np.einsum("am,exmz->eaxz", f["Dy"], w),
        "grad.gz": np.einsum("an,exyn->eaxy", f["Dz"], w),
        "helmholtz.v": reference.inverse_helmholtz_batch(
            f["S"], inputs["helmholtz.D"].astype(np.float64), gx),
    }


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_FRAC * np.abs(want).max())


def test_slice_matches_reference_package(port_system, port_run, data):
    inputs, shared = data
    r_system = r_operators.compile_cfd_pipeline(P, **COMPILE)
    want = r_system.run(inputs=inputs, shared=shared, collect_outputs=True)
    assert port_system.backends == r_system.backends == ("pallas",) * 3
    assert port_run.batches == want.batches == N_BATCHES
    assert port_run.elements == want.elements == E * N_BATCHES
    assert set(port_run.outputs) == set(want.outputs)
    for q, ref in want.outputs.items():
        assert port_run.outputs[q].shape == ref.shape
        _close(port_run.outputs[q], np.asarray(ref))
    assert port_run.pipelined_stages == want.pipelined_stages


def test_slice_matches_numpy_oracles(port_run, data):
    for q, ref in _oracle(*data).items():
        _close(port_run.outputs[q], ref)


def test_pipelined_equals_serial_bitwise(port_system, port_run, data):
    inputs, shared = data
    serial = port_system.run(inputs=inputs, shared=shared,
                             collect_outputs=True, device="cpu",
                             pipeline_stages=False)
    assert port_run.pipelined_stages and not serial.pipelined_stages
    for q in port_run.outputs:
        np.testing.assert_array_equal(port_run.outputs[q], serial.outputs[q])
    summed = port_system.run(inputs=inputs, shared=shared, device="cpu")
    serial_sums = port_system.run(inputs=inputs, shared=shared, device="cpu",
                                  pipeline_stages=False)
    assert summed.checksums == serial_sums.checksums


def test_cpu_run_launches_no_kernel(port_system, data):
    inputs, shared = data
    before = (t_gemm.gemm_chain.launches, t_hh.inverse_helmholtz.launches)
    port_system.run(inputs=inputs, shared=shared, device="cpu")
    assert (t_gemm.gemm_chain.launches, t_hh.inverse_helmholtz.launches) == before


def test_kernel_and_xla_backends_agree(port_run, data):
    inputs, shared = data
    xla = t_operators.compile_cfd_pipeline(
        P, **{**COMPILE, "backends": "xla"})
    assert xla.backends == ("xla",) * 3
    got = xla.run(inputs=inputs, shared=shared, collect_outputs=True,
                  device="cpu")
    for q, ref in port_run.outputs.items():
        _close(got.outputs[q], ref)


def test_synthetic_streams_match_reference(port_system):
    """Without inputs both packages synthesize the same data (seed + b per
    batch, seed + 2**31 + k per shared operand), so checksums agree."""
    r_system = r_operators.compile_cfd_pipeline(P, **COMPILE)
    want = r_system.run(seed=3, max_batches=2)
    got = port_system.run(seed=3, max_batches=2, device="cpu")
    assert set(got.checksums) == set(want.checksums)
    for q, v in want.checksums.items():
        assert got.checksums[q] == pytest.approx(v, rel=1e-4, abs=1e-3)


def test_to_device_and_default_device():
    arrays = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}
    got = simulation.to_device(arrays, "cpu")
    assert got["a"].dtype == torch.float32 and got["a"].device.type == "cpu"
    np.testing.assert_array_equal(got["a"].numpy(), arrays["a"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            simulation.to_device(arrays, None)


def test_run_chain_rejects_observers_not_ported(port_system):
    """The observers are ported: a traced, metered, monitored run gives
    the unobserved run's checksums, bit for bit."""
    from repro_torch import metrics, trace
    from repro_torch.runtime.monitor import StepMonitor

    plain = port_system.run(device="cpu", max_batches=2)
    observed = port_system.run(device="cpu", max_batches=2,
                               tracer=trace.Tracer(), monitor=StepMonitor(),
                               metrics=metrics.MetricsRegistry())
    assert observed.checksums == plain.checksums
