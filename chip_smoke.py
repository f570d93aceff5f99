#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

  1. versions, the card's name and power limit, and the build of every
     CUDA kernel from ``src/repro_torch/csrc`` (nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the slice gives it (p = 11, the planner's E, its blocks):
     float32 within rtol 5e-4 / atol 5e-4 max|plain|, the Helmholtz
     kernel also in bfloat16 within rtol 0.15 / atol 0.3 max|plain|, and
     bitwise equality of one E-element call with two E/2 calls; times of
     kernel, plain version and (where one PyTorch call computes the same
     function) that call, beside the least time the card could take;
  3. the slice: ``compile_cfd_pipeline(11, backends="pallas")`` and
     ``.run()`` over 8 batches of E elements, with the launch counters
     zeroed just before and read just after; pipelined and serial
     checksums bitwise equal; 64 elements of batch 0 against the float64
     numpy oracles;
  4. one JSON line describing every kernel, then the result line.

Without a CUDA device, or without the repository beside it, it exits
with a non-zero code before printing any result.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
SRC = REPO / "src"

#: H100 SXM datasheet peaks the bounds are computed against
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
N_BATCHES = 8
CHECK_ELEMENTS = 64
F32_RTOL, F32_ATOL_FRAC = 5e-4, 5e-4
BF16_RTOL, BF16_ATOL_FRAC = 0.15, 0.3


class SmokeFailure(RuntimeError):
    """A phase found the port wrong or unable to run."""


def fail(msg: str) -> None:
    raise SmokeFailure(msg)


def compare(got, want, rtol: float, atol_frac: float, what: str) -> float:
    """Elementwise ``|got - want| <= atol + rtol |want|`` with ``atol =
    atol_frac * max|want|``; returns max|got - want|, fails otherwise."""
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite values")
    err = (got - want).abs()
    atol = atol_frac * want.abs().max().item()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        fail(f"{what}: {int(bad.sum())} entries off, max |err| "
             f"{err.max().item():.3e} (atol {atol:.3e}, rtol {rtol})")
    return err.max().item()


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, flops: float):
    """The least time (ms) the card could take: bytes over the memory rate
    or f32 operations over the CUDA-core peak, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_setup():
    import torch

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"device {torch.cuda.get_device_name(0)} | count "
          f"{torch.cuda.device_count()}")
    from repro_torch.kernels import _cuda

    _cuda.library()
    print(f"kernels built in {_cuda.build_seconds:.1f} s "
          f"({_cuda.nvcc_path()}, sm_90a)")
    for line in "\n".join(_cuda.build_log).splitlines():
        if "Used" in line or line.startswith("=="):
            print(f"  {line.strip()}")
    return card


def phase_kernels(system):
    """Each kernel against its plain version at the slice's shapes."""
    import torch

    from repro_torch.flow import patterns
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.helmholtz import helmholtz
    from repro_torch.memory.layout import largest_divisor_leq

    dev = torch.device("cuda", 0)
    plan = system.plan
    E = plan.batch_elements
    p = system.program.inputs["u"].shape[0]
    blocks = {sp.name: sp.block_elements for sp in plan.stages}
    progs = {s.name: s.program for s in system.chain.stages}
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 2 - 1

    rows = {}

    def split_calls(fn, E, be):
        """fn(lo, hi, be) on both halves, concatenated (bitwise check)."""
        half = E // 2
        be2 = largest_divisor_leq(half, be)
        return be2, lambda: fn(0, half, be2), lambda: fn(half, E, be2)

    # -- helmholtz -----------------------------------------------------------
    be = blocks["helmholtz"]
    S, D, u = uniform(p, p), uniform(E, p, p, p), uniform(E, p, p, p)
    got = helmholtz.inverse_helmholtz(S, D, u, block_elements=be)
    want = helmholtz.inverse_helmholtz_plain(S, D, u, block_elements=be)
    torch.cuda.synchronize()
    err = compare(got, want, F32_RTOL, F32_ATOL_FRAC, "helmholtz f32")
    Sb, Db, ub = S.bfloat16(), D.bfloat16(), u.bfloat16()
    got_b = helmholtz.inverse_helmholtz(Sb, Db, ub, block_elements=be)
    want_b = helmholtz.inverse_helmholtz_plain(Sb, Db, ub, block_elements=be)
    err_b = compare(got_b, want_b, BF16_RTOL, BF16_ATOL_FRAC, "helmholtz bf16")
    be2, lo, hi = split_calls(
        lambda a, b, k: helmholtz.inverse_helmholtz(
            S, D[a:b], u[a:b], block_elements=k), E, be)
    if not torch.equal(got, torch.cat([lo(), hi()])):
        fail(f"helmholtz: E={E} (BE={be}) differs bitwise from two E/2 "
             f"calls (BE={be2})")
    ms = time_ms(lambda: helmholtz.inverse_helmholtz(S, D, u, block_elements=be), 20)
    plain_ms = time_ms(
        lambda: helmholtz.inverse_helmholtz_plain(S, D, u, block_elements=be), 3)
    b_ms, b_by = bound(nbytes(S, D, u, got), E * progs["helmholtz"].total_flops())
    rows["helmholtz"] = [dict(stage="helmholtz", block_elements=be, ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              library_ms=None, max_abs_err=err,
                              max_abs_err_bf16=err_b)]
    print(f"helmholtz  E={E} BE={be}: f32 max|err| {err:.3e}, bf16 "
          f"{err_b:.3e}, split bitwise ok | kernel {ms:.3f} ms  plain "
          f"{plain_ms:.3f} ms  bound {b_ms:.3f} ms ({b_by})")
    del D, u, got, want, Sb, Db, ub, got_b, want_b

    # -- gemm chain: interpolation and gradient ------------------------------
    rows["gemm_chain"] = []
    for stage in ("interp", "grad"):
        recipe = patterns.match_gemm_chain(progs[stage])
        if recipe is None:
            fail(f"stage {stage} does not match the GEMM-chain kernel")
        be = blocks[stage]
        env = {
            name: (uniform(E, *shape) if is_elem else uniform(*shape))
            for name, shape, is_elem in recipe.inputs
        }
        got = gemm.gemm_chain(recipe, env, block_elements=be)
        want = gemm.gemm_chain_plain(recipe, env, block_elements=be)
        torch.cuda.synchronize()
        err = max(compare(got[k], want[k], F32_RTOL, F32_ATOL_FRAC,
                          f"gemm_chain {stage} {k}") for k in got)
        elem_names = [n for n, _, is_elem in recipe.inputs if is_elem]

        def half(a, b, k, env=env, recipe=recipe, elem_names=elem_names):
            sub = {n: (v[a:b] if n in elem_names else v) for n, v in env.items()}
            return gemm.gemm_chain(recipe, sub, block_elements=k)

        be2, lo, hi = split_calls(half, E, be)
        parts = (lo(), hi())
        for k in got:
            if not torch.equal(got[k], torch.cat([parts[0][k], parts[1][k]])):
                fail(f"gemm_chain {stage}: output {k} at E={E} (BE={be}) "
                     f"differs bitwise from two E/2 calls (BE={be2})")
        ms = time_ms(lambda: gemm.gemm_chain(recipe, env, block_elements=be), 20)
        plain_ms = time_ms(
            lambda: gemm.gemm_chain_plain(recipe, env, block_elements=be), 3)
        b_ms, b_by = bound(nbytes(*env.values(), *got.values()),
                           E * progs[stage].total_flops())
        library_ms = None
        if stage == "interp":
            # one PyTorch call computes w_ijk = sum A_il A_jm A_kn u_lmn
            (mat,) = [n for n, _, is_elem in recipe.inputs if not is_elem]
            A, x = env[mat], env[elem_names[0]]
            lib = torch.einsum("il,jm,kn,elmn->eijk", A, A, A, x)
            compare(lib, want[recipe.outputs[0][0]], F32_RTOL, F32_ATOL_FRAC,
                    "einsum interp")
            library_ms = time_ms(
                lambda: torch.einsum("il,jm,kn,elmn->eijk", A, A, A, x), 20)
        rows["gemm_chain"].append(dict(
            stage=stage, block_elements=be, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
            max_abs_err=err))
        lib_txt = f"  einsum {library_ms:.3f} ms" if library_ms else ""
        print(f"gemm_chain {stage} E={E} BE={be}: f32 max|err| {err:.3e}, "
              f"split bitwise ok | kernel {ms:.3f} ms  plain {plain_ms:.3f} "
              f"ms{lib_txt}  bound {b_ms:.3f} ms ({b_by})")
        del env, got, want, parts
    torch.cuda.empty_cache()
    return rows


def phase_slice(system):
    """The main path: the whole pipeline over N_BATCHES batches."""
    import numpy as np
    import torch

    from repro_torch.cfd import operators, reference, simulation
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.helmholtz import helmholtz
    from repro_torch.memory import pipeline as mempipe

    if system.backends != ("pallas",) * 3:
        fail(f"effective backends {system.backends}, want pallas x3")
    E = system.plan.batch_elements
    n_eq = N_BATCHES * E
    p = system.program.inputs["u"].shape[0]

    gemm.gemm_chain.launches = 0
    helmholtz.inverse_helmholtz.launches = 0
    res = system.run(n_eq=n_eq)
    torch.cuda.synchronize()
    launches = {"gemm_chain": gemm.gemm_chain.launches,
                "helmholtz": helmholtz.inverse_helmholtz.launches}
    n = res.batches
    if n != N_BATCHES or launches != {"gemm_chain": 2 * n, "helmholtz": n}:
        fail(f"main path ran {n} batches with launches {launches}; want "
             f"{N_BATCHES} batches, 2n gemm_chain and n helmholtz")
    if not res.pipelined_stages:
        fail("the plan's pipeline mode did not run stage-pipelined")
    eps = res.elements / res.wall_s
    gflops = res.elements * operators.flops_per_element(p) / res.wall_s / 1e9
    print(f"slice: {n} batches x {E} elements in {res.wall_s:.3f} s "
          f"(stage-pipelined): {eps:.0f} elements/s, {gflops:.1f} GFLOPS "
          f"(Eq. 2) | launches {launches}")
    for q, v in sorted(res.checksums.items()):
        if not np.isfinite(v):
            fail(f"checksum {q} is not finite")
        print(f"  checksum {q} = {v!r}")

    serial = system.run(n_eq=n_eq, pipeline_stages=False)
    if serial.checksums != res.checksums:
        fail(f"serial checksums {serial.checksums} != pipelined "
             f"{res.checksums}")
    print(f"serial schedule: {serial.wall_s:.3f} s, checksums bitwise equal")

    one = system.run(n_eq=E, max_batches=1, collect_outputs=True)
    chain = system.chain
    shared = {k: v.astype(np.float64)
              for k, v in simulation._shared_host(chain, 0, None).items()}
    # where a batch's wall time goes: host synthesis of its inputs, then
    # pinning and copying them to the card (the kernels' share is phase 2's)
    t = time.perf_counter()
    b0 = next(simulation._chain_batch_inputs(chain, E, 1, 0, None))
    synth_s = time.perf_counter() - t
    stager = mempipe.HostStager(torch.device("cuda", 0), slots=1)
    stager(b0).arrays()  # the first call also allocates the pinned slot
    torch.cuda.synchronize()
    t = time.perf_counter()
    stager(b0).arrays()
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t
    print(f"one batch: {res.wall_s / n:.3f} s wall, host synthesis "
          f"{synth_s:.3f} s, pin + copy to the card {stage_s:.3f} s "
          f"({sum(v.nbytes for v in b0.values()) / 2**20:.1f} MiB)")
    m = CHECK_ELEMENTS
    u = b0["interp.u"][:m].astype(np.float64)
    D = b0["helmholtz.D"][:m].astype(np.float64)
    w = reference.interpolation_batch(shared["A"], u)
    gx = np.einsum("al,elyz->eayz", shared["Dx"], w)
    want = {
        "grad.gy": np.einsum("am,exmz->eaxz", shared["Dy"], w),
        "grad.gz": np.einsum("an,exyn->eaxy", shared["Dz"], w),
        "helmholtz.v": reference.inverse_helmholtz_batch(shared["S"], D, gx),
    }
    for q, ref in want.items():
        got = torch.from_numpy(one.outputs[q][:m])
        if got.shape != ref.shape:
            fail(f"{q}: shape {tuple(got.shape)} != {ref.shape}")
        err = compare(got.double(), torch.from_numpy(ref), F32_RTOL,
                      F32_ATOL_FRAC, f"slice {q} vs float64 oracle")
        print(f"  {q}[:{m}] vs float64 oracle: max|err| {err:.3e}")
    return res, launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("error: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: no CUDA device; the chip smoke runs on the GPU only",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"error: {SRC / 'repro_torch'} not found; run from the "
              "repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    try:
        card = phase_setup()
        from repro_torch.cfd import operators

        system = operators.compile_cfd_pipeline(11, backends="pallas")
        if system.target.name != "h100-sxm":
            fail(f"planned for {system.target.name}, want h100-sxm")
        print(f"plan: E={system.plan.batch_elements}  blocks "
              f"{[sp.block_elements for sp in system.plan.stages]}  "
              f"host stream {system.plan.host_stream_bytes / 2**20:.1f} "
              "MiB/batch")
        rows = phase_kernels(system)
        _, launches = phase_slice(system)
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1

    sources = {
        "helmholtz": ("src/repro_torch/csrc/helmholtz.cu",
                      "src/repro/kernels/helmholtz/helmholtz.py:92"),
        "gemm_chain": ("src/repro_torch/csrc/gemm_chain.cu",
                       "src/repro/kernels/gemm/gemm.py:204"),
    }
    kernels = []
    for name, shapes in rows.items():
        # one main-path batch: the kernel's calls at each of its shapes
        b_ms = sum(r["bound_ms"] for r in shapes)
        libs = [r["library_ms"] for r in shapes]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": sum(r["ms"] for r in shapes),
            "plain_ms": sum(r["plain_ms"] for r in shapes),
            "bound_ms": b_ms,
            "bound_by": max(shapes, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": sum(libs) if all(x is not None for x in libs) else None,
            "shapes": shapes,
        })
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
