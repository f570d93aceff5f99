"""Measured block tuning in the port: ``kernels.gemm.cdse_cdac`` and
``flow.compile(tune_blocks=True)`` (``--tune-blocks`` on the CLI).

``tile_candidates`` is held against the reference's for the reference's
recipes and arguments.  On the H100 datasheet the candidates are the
CUDA kernels' own tiles (``te = 1 .. max_tile``; 3 at p = 11, 15 at
p = 5, float32), so no block is timed that the card cannot launch.  On
the CPU the tuner times the kernels' plain versions: it must pick a
winner among the candidates, run every stage at it, and leave the
outputs bitwise those of the untuned compile and within float32
summation order of the reference's.
"""
import dataclasses

import numpy as np
import pytest

from repro import flow as r_flow
from repro.kernels import gemm as r_gemm
from repro.memory import channels as r_channels
from repro_torch import flow as t_flow
from repro_torch.cfd import operators as t_operators
from repro_torch.flow import build as t_build
from repro_torch.flow import patterns as t_patterns
from repro_torch.kernels import _cube
from repro_torch.kernels import gemm as t_gemm
from repro_torch.memory import channels as t_channels
from test_torch_cuda import gemm_recipes

#: float32 results of both packages sum in different orders
RTOL, ATOL_FRAC = 5e-4, 5e-4


def _r_target(name):
    """The reference's datasheet of that name (it has no H100: the
    port's, field by field)."""
    if name == "h100-sxm":
        return r_channels.MemoryTarget(
            **dataclasses.asdict(t_channels.H100_SXM))
    return r_channels.resolve_target(name)


# ---------------------------------------------------------------------------
# the candidates
# ---------------------------------------------------------------------------

TILE_ARGS = {
    "p11-16MiB": (11, dict(vmem_bytes=16 * 2 ** 20, peak_flops=1e12,
                           hbm_bandwidth=400e9)),
    "p5-batch96": (5, dict(vmem_bytes=64 * 2 ** 20, peak_flops=1e12,
                           hbm_bandwidth=400e9, batch_elements=96)),
    "p11-too-small": (11, dict(vmem_bytes=4096, peak_flops=1e12,
                               hbm_bandwidth=400e9)),
    "p7-bf16-h100": (7, dict(vmem_bytes=232_448, peak_flops=67e12,
                             hbm_bandwidth=3.35e12, bytes_per_scalar=2,
                             overhead_s=5e-6, max_block=512,
                             batch_elements=1024)),
}


@pytest.mark.parametrize("recipe_name", ["interp", "perm", "ewise"])
@pytest.mark.parametrize("args", sorted(TILE_ARGS))
def test_tile_candidates_match_reference(recipe_name, args):
    """Equal classes, blocks, working sets and ranking as the
    reference's CHARM-style candidates."""
    p, kw = TILE_ARGS[args]
    got = t_gemm.tile_candidates(gemm_recipes(t_gemm, p)[recipe_name], **kw)
    want = r_gemm.tile_candidates(gemm_recipes(r_gemm, p)[recipe_name], **kw)
    assert [dataclasses.astuple(c) for c in got] == \
        [dataclasses.astuple(c) for c in want]
    assert (len(got) == 0) == (args == "p11-too-small")
    assert t_gemm.LARGE_CLASS_FRACTION == r_gemm.LARGE_CLASS_FRACTION


@pytest.mark.parametrize("p,max_te", [(5, 15), (11, 3)])
@pytest.mark.parametrize("kernel", ["helmholtz", "interp", "grad"])
def test_card_candidates_are_the_kernels_legal_tiles(kernel, p, max_te):
    """te = 1 .. the largest tile the kernel launches with (2 x 192
    fibers over p^2: 15 at p = 5, 3 at p = 11), in te order, each with
    the shared bytes that follow from it, classed by its CTA's share of
    one block's shared memory; the default tile is among them."""
    src = t_operators.CFD_PIPELINE_SRC.format(p=p)
    system = t_flow.compile(src, stages=t_operators.CFD_PIPELINE_STAGES,
                            target="h100-sxm", backend="pallas",
                            device="cpu", n_eq=1 << 12)
    prog = {s.name: s.program for s in system.chain.stages}[kernel]
    default_te, _, _, top = t_patterns.kernel_tile_for(prog, 4)
    assert top == max_te and default_te <= top
    cands = t_gemm.card_tile_candidates(
        lambda te: t_patterns.kernel_tile_for(prog, 4, te)[:3], top)
    assert [te for te, _, _ in cands] == list(range(1, top + 1))
    for te, klass, smem in cands:
        _, threads, want, _ = t_patterns.kernel_tile_for(prog, 4, te)
        assert threads <= _cube.CUBE_MAX_THREADS
        assert smem == want <= _cube.MAX_SHARED_BYTES
        assert klass == ("cdse" if smem > _cube.MAX_SHARED_BYTES
                         * t_gemm.LARGE_CLASS_FRACTION else "cdac")
    # a batch smaller than the largest tile bounds the candidates
    few = t_gemm.card_tile_candidates(
        lambda te: t_patterns.kernel_tile_for(prog, 4, te)[:3], top,
        batch_elements=2)
    assert [te for te, _, _ in few] == [1, 2][:top]


def test_max_tile_is_the_launch_limit():
    """The largest te keeps a CTA within 192 threads and one block's
    shared memory; one more breaks a limit; the wrappers' check refuses
    a block outside 1 .. max before any launch."""
    for p in range(1, _cube.MAX_P + 1):
        for eb in (4, 2):
            top = _cube.helmholtz_max_tile(p, eb)
            te, threads, smem = _cube.helmholtz_tile(p, eb, top)
            assert threads <= _cube.CUBE_MAX_THREADS
            assert smem <= _cube.MAX_SHARED_BYTES
            _, threads2, smem2 = _cube.helmholtz_tile(p, eb, top + 1)
            assert (threads2 > _cube.CUBE_MAX_THREADS
                    or smem2 > _cube.MAX_SHARED_BYTES)
            assert _cube.helmholtz_tile(p, eb)[0] <= top
    assert _cube.helmholtz_max_tile(11, 4) == 3
    assert _cube.helmholtz_max_tile(5, 4) == 15
    for bad in (0, 4):
        with pytest.raises(ValueError, match="1..3 elements"):
            _cube.check_te("Inverse-Helmholtz", 11, bad,
                           _cube.helmholtz_max_tile(11, 4))
    # eight element inputs at p = 16 in float32: not even one element fits
    inputs = tuple((f"x{j}", (16, 16, 16), True) for j in range(8))
    wide = t_gemm.GemmRecipe(p=16, inputs=inputs, ops=(),
                             outputs=(("y", 0),))
    assert t_gemm.gemm.kernel_max_tile(wide, 4) == 0
    assert t_gemm.gemm.kernel_max_tile(wide, 2) >= 1


# ---------------------------------------------------------------------------
# flow.compile(tune_blocks=True)
# ---------------------------------------------------------------------------

def _data(p, n, seed=0):
    rng = np.random.default_rng(seed)
    elems = {"u": rng.uniform(-1, 1, (n, p, p, p)).astype(np.float32),
             "D": rng.uniform(-1, 1, (n, p, p, p)).astype(np.float32)}
    shared = {k: rng.uniform(-1, 1, (p, p)).astype(np.float32)
              for k in ("A", "Dx", "Dy", "Dz", "S")}
    return elems, shared


def _outputs(system, elems, shared, **kw):
    chain = system.chain
    inputs = {f"{s.name}.{name}": elems[name]
              for i, s in enumerate(chain.stages)
              for name, _ in chain.host_element_inputs(i)}
    res = system.run(inputs=inputs, shared=shared, collect_outputs=True,
                     **kw)
    return {q.split(".", 1)[1]: np.asarray(v) for q, v in res.outputs.items()}


@pytest.mark.parametrize("target", ["h100-sxm", "alveo-u280"])
def test_tune_blocks_picks_a_winner_and_keeps_the_bits(target):
    p, E, n = 5, 32, 64
    src = t_operators.CFD_PIPELINE_SRC.format(p=p)
    kw = dict(stages=t_operators.CFD_PIPELINE_STAGES, target=target,
              backend="pallas", batch_elements=E, n_eq=n)
    tuned = t_flow.compile(src, tune_blocks=True, device="cpu", **kw)
    plain = t_flow.compile(src, device="cpu", **kw)
    assert set(tuned.tuning) == {"interp", "grad", "helmholtz"}
    for sp, st in zip(tuned.plan.stages, tuned.chain.stages):
        t = tuned.tuning[sp.name]
        blocks = [be for be, _, _ in t.candidates]
        assert t.block_elements in blocks and sp.block_elements == \
            t.block_elements
        assert all(s > 0 for _, _, s in t.candidates)
        if target == "h100-sxm":
            # the kernel's own tiles, and the winner's CTA bytes
            assert blocks == list(range(1, 16))
            tile = t_patterns.kernel_tile_for(st.program, 4,
                                              t.block_elements)
            assert sp.block_working_set_bytes == tile[2]
        else:
            assert all(E % be == 0 for be in blocks)
    text = tuned.report()
    assert "tuned blocks" in text and "tuned blocks" not in plain.report()
    elems, shared = _data(p, n)
    got = _outputs(tuned, elems, shared, device="cpu")
    want = _outputs(plain, elems, shared, device="cpu")
    for q in want:
        assert np.array_equal(got[q], want[q]), q
    ref = r_flow.compile(src, stages=t_operators.CFD_PIPELINE_STAGES,
                         target=_r_target(target), backend="pallas",
                         batch_elements=E, n_eq=n)
    r_out = _outputs(ref, elems, shared)
    for q, r in r_out.items():
        np.testing.assert_allclose(got[q], r, rtol=RTOL,
                                   atol=ATOL_FRAC * np.abs(r).max())


def test_tune_blocks_runs_every_stage_at_its_winner(monkeypatch):
    """Each kernel stage of the tuned chain launches at the block the
    tuner chose (the CPU wrapper passes it to the plain version)."""
    from repro_torch.kernels.gemm import gemm as t_gemm_mod
    from repro_torch.kernels.helmholtz import helmholtz as t_hh

    p, E = 5, 16
    system = t_flow.compile(
        t_operators.CFD_PIPELINE_SRC.format(p=p),
        stages=t_operators.CFD_PIPELINE_STAGES, target="h100-sxm",
        backend="pallas", batch_elements=E, n_eq=E, tune_blocks=True,
        device="cpu")
    seen = {}
    gemm_plain, hh_plain = t_gemm_mod.gemm_chain_plain, \
        t_hh.inverse_helmholtz_plain

    def gemm_spy(recipe, env, *, block_elements):
        seen["interp" if "A" in env else "grad"] = block_elements
        return gemm_plain(recipe, env, block_elements=block_elements)

    def hh_spy(S, D, u, *, block_elements):
        seen["helmholtz"] = block_elements
        return hh_plain(S, D, u, block_elements=block_elements)

    monkeypatch.setattr(t_gemm_mod, "gemm_chain_plain", gemm_spy)
    monkeypatch.setattr(t_hh, "inverse_helmholtz_plain", hh_spy)
    elems, shared = _data(p, E)
    _outputs(system, elems, shared, device="cpu")
    assert seen == {name: t.block_elements
                    for name, t in system.tuning.items()}


def test_reference_target_kernels_launch_at_their_default_tile(monkeypatch):
    """On a reference datasheet the plan's blocks are VMEM blocks (512 to
    1024 at p = 11 on alveo-u280), which no CUDA kernel launches with:
    the plan keeps them and every kernel stage gets ``block_elements``
    None, its default tile, tuned off the card or not.  Tuning on the
    card times the kernel's tiles there instead."""
    from repro_torch.kernels.gemm import gemm as t_gemm_mod
    from repro_torch.kernels.helmholtz import helmholtz as t_hh

    p, E = 11, 512
    src = t_operators.CFD_PIPELINE_SRC.format(p=p)
    kw = dict(stages=t_operators.CFD_PIPELINE_STAGES, target="alveo-u280",
              backend="pallas", batch_elements=E, n_eq=E, device="cpu")
    plain = t_flow.compile(src, **kw)
    assert [sp.block_elements for sp in plain.plan.stages] == [512] * 3
    seen = []
    gemm_plain, hh_plain = t_gemm_mod.gemm_chain_plain, \
        t_hh.inverse_helmholtz_plain

    def gemm_spy(recipe, env, *, block_elements):
        seen.append(block_elements)
        return gemm_plain(recipe, env, block_elements=block_elements)

    def hh_spy(S, D, u, *, block_elements):
        seen.append(block_elements)
        return hh_plain(S, D, u, block_elements=block_elements)

    monkeypatch.setattr(t_gemm_mod, "gemm_chain_plain", gemm_spy)
    monkeypatch.setattr(t_hh, "inverse_helmholtz_plain", hh_spy)
    elems, shared = _data(p, E)
    _outputs(plain, elems, shared, device="cpu")
    assert seen == [None] * 3
    # the Fig. 2 operator built from an alveo-u280 plan: its kernel too
    from repro_torch.cfd import simulation as t_simulation

    plan = t_simulation.plan_config(
        t_simulation.SimConfig(p=p, backend="pallas", n_eq=E),
        target=t_channels.ALVEO_U280)
    assert plan.block_elements == 512
    seen.clear()
    t_operators.build_inverse_helmholtz(
        p, backend="pallas", plan=plan, device="cpu").batched_fn(
        {k: elems[k][:2] for k in ("u", "D")} | {"S": shared["S"]})
    assert seen == [None]
    # on the card the candidates are the kernel's tiles on any datasheet
    prog = {s.name: s.program for s in plain.chain.stages}["grad"]
    pol = t_build.get_policy("float32")
    assert t_build._block_candidates(
        prog, t_channels.ALVEO_U280, pol, E, card=True) == [
        (1, "cdac"), (2, "cdac"), (3, "cdac")]
    assert all(E % be == 0 for be, _ in t_build._block_candidates(
        prog, t_channels.ALVEO_U280, pol, E, card=False))


def test_a_candidate_that_fails_raises(monkeypatch):
    """The tuner skips no candidate: a block whose kernel fails raises
    out of flow.compile."""
    inner = t_patterns.pallas_impl_for

    def failing(prog, *, block_elements=None):
        impl = inner(prog, block_elements=block_elements)
        if block_elements == 2:
            def impl(env):
                raise RuntimeError("launch failed at block 2")
        return impl

    monkeypatch.setattr(t_patterns, "pallas_impl_for", failing)
    with pytest.raises(RuntimeError, match="block 2"):
        t_flow.compile(t_operators.CFD_PIPELINE_SRC.format(p=5),
                       stages=t_operators.CFD_PIPELINE_STAGES,
                       target="h100-sxm", backend="pallas",
                       batch_elements=8, n_eq=8, tune_blocks=True,
                       device="cpu")


def test_tuner_times_on_the_host_clock_on_the_cpu(monkeypatch):
    """On the CPU a candidate's time is the host clock around a call
    whose outputs are ready on return; each candidate gets one warm-up
    and three timed calls."""
    calls = []
    real = t_build._timed

    def spy(fn, env, dev):
        calls.append(dev.type)
        return real(fn, env, dev)

    monkeypatch.setattr(t_build, "_timed", spy)
    system = t_flow.compile(
        t_operators.CFD_PIPELINE_SRC.format(p=11),
        stages=t_operators.CFD_PIPELINE_STAGES, target="h100-sxm",
        backend="pallas", batch_elements=4, n_eq=4, tune_blocks=True,
        device="cpu")
    # three stages, three candidate tiles each at p = 11
    assert {n: [be for be, _, _ in t.candidates]
            for n, t in system.tuning.items()} == {
        "interp": [1, 2, 3], "grad": [1, 2, 3], "helmholtz": [1, 2, 3]}
    assert calls == ["cpu"] * (3 * 3 * 4)


def test_cli_tune_blocks_prints_every_candidate(capsys):
    from pathlib import Path

    from repro_torch.flow import cli as t_cli

    src = str(Path(__file__).resolve().parents[1] / "examples"
              / "cfd_pipeline.cfd")
    assert t_cli.main([src, "--target", "h100-sxm", "--backend", "pallas",
                       "--n-eq", "16", "--device", "cpu", "--tune-blocks",
                       "--run", "--max-batches", "1"]) == 0
    out = capsys.readouterr().out
    assert "tuned blocks" in out and "ran 1 batches x 16" in out
    assert out.count("*(") >= 1
