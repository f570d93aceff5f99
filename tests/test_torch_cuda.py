"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither ``jax`` nor ``repro``, so it runs on a machine
with a CUDA card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips.  Tolerances: float32 within rtol 5e-4
and atol 5e-4 max|plain| (both sum in float32, the plain version in
another association of the same ascending-l order); bfloat16 within one
bfloat16 step, rtol 2^-7, plus atol 1e-3 max|plain| (both compute in
float32 from the same bfloat16 inputs and round once, so two results
differ only where their float32 values straddle a rounding boundary).
The CFD kernels are also held to bitwise equality across every tile they
launch with (te = 1 .. max_tile elements a CTA step), batch splits,
ragged batches and input alignments, and over batches large enough that
every CTA of their persistent grids walks several tiles; a tile above
max_tile is refused before the launch.
The fixed-point formats are integer arithmetic: their contractions,
limb products and whole operators on the card equal the CPU's bit for
bit.  run_simulation's checksums on the card match the CPU's within
rel 1e-4 (float32 sums in other orders), K = 0 and K = 1 bitwise.
Flash attention: float32 within the same rtol 5e-4 / atol 5e-4
max|plain|; bfloat16 per element within 8e-3 |plain| (one bfloat16 step
of the output, where the two float32 values straddle a rounding
boundary) + 1e-4 max|plain| (their float32 difference near zero) + the
plain version's p bound, 2^-8 sum_j p_j |v_j| / l, on the wgmma route:
it rounds p to bfloat16 for the PV product, and scores summed in another
float32 order can round a p to the other bfloat16 neighbour.
The flash launches as PyTorch ops (``repro_torch::flash_fwd``,
``repro_torch::flash_bwd``) give bitwise the launch functions' outputs,
each counted once on its route.
Placement: a chain placed over the pool [cuda:0, cuda:0] gives the
one-slot run's bits, each kernel launched once a shard; with two cards
the kernels launch on their tensors' card and the chain over [cuda:0,
cuda:1] gives the same bits (skipped with one card).
MoE: ``moe_apply`` on the card equals the CPU's within rtol 1e-5 and
atol 1e-5 max|CPU| (float32 sums in another order; the scatter mode's
atomic adds in none) with the same kept assignments, so the sort, search
and gathers of the dispatch behave on CUDA as on the CPU.
xLSTM: ``mlstm_apply``, ``mlstm_apply_chunked`` and ``slstm_apply`` on the
card equal the CPU's within the same rtol 1e-5 / atol 1e-5 max|CPU|, with
and without a carried state (float32 sums and scans in another order).
Jamba: ``mamba_apply`` on the card equals the CPU's within the same
rtol 1e-5 / atol 1e-5 max|CPU|, with and without a carried state; the
smoke hybrid's forward (the flash kernel on its fma route at d = 16 on
the card, plain attention on the CPU), prefill and a decode step within
rtol 1e-4 / atol 1e-4 max|CPU| (float32 through four layers in another
order).
Whisper: the smoke encoder-decoder on the card (flash on the fma route
at head dim 16, the encoder at one whole-axis block) equals the CPU's
within rtol 1e-4 / atol 1e-4 max|CPU|: forward, prefill, a decode step,
the encoder output and the caches.
Training: every family's smoke step (float32) on the card equals the
CPU's within rtol 1e-5 on the loss and 1e-4 x the tree's largest
|gradient| on each gradient leaf (float32 through two layers in another
order); the sharded step on a one-rank mesh (nccl, in a subprocess:
``tests/torch_dist_worker.py cuda1``) is bitwise the unsharded one on
both flash routes.
"""
import pytest
import torch

from repro_torch.cfd import simulation as t_simulation
from repro_torch.core import api, dsl as t_dsl
from repro_torch.core import precision as t_prec
from repro_torch.core.precision import FIXED32, FIXED64, matmul_f32
from repro_torch.kernels import _cube
from repro_torch.kernels import gemm as t_gemm
from repro_torch.kernels.attention import attention as t_attn
from repro_torch.kernels.attention import ref as t_attn_ref
from repro_torch.kernels.helmholtz import helmholtz as t_hh


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is none (decided per test,
    never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def gemm_recipes(mod, p):
    """The three recipes of tests/test_kernels.py, built in ``mod`` (the
    reference's or the port's ``kernels.gemm``)."""
    inputs = (("A", (p, p), False), ("u", (p, p, p), True))
    return {
        "interp": mod.GemmRecipe(
            p=p, inputs=inputs,
            ops=(
                ("contract", 1, 0, 0, 0, (0, 1, 2)),
                ("contract", 2, 0, 1, 0, (0, 1, 2)),
                ("contract", 3, 0, 2, 0, (0, 1, 2)),
            ),
            outputs=(("w", 4),),
        ),
        "perm": mod.GemmRecipe(
            p=p, inputs=inputs,
            ops=(("contract", 1, 0, 1, 0, (1, 0, 2)),),
            outputs=(("y", 2),),
        ),
        "ewise": mod.GemmRecipe(
            p=p, inputs=inputs,
            ops=(
                ("contract", 1, 0, 0, 0, (0, 1, 2)),
                ("ewise", "mul", 2, 1, None),
                ("ewise", "scale", 3, -1, 0.5),
            ),
            outputs=(("w", 2), ("z", 4)),
        ),
    }


def _uniform(gen, device, *shapes):
    return [torch.rand(s, generator=gen, device=device) * 2 - 1 for s in shapes]


def _close(got, want, dtype):
    """float32 within rtol 5e-4 / atol 5e-4 max|plain|, bfloat16 within
    rtol 2^-7 / atol 1e-3 max|plain| (see the module docstring)."""
    rtol, frac = (5e-4, 5e-4) if dtype == torch.float32 else (2 ** -7, 1e-3)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=frac * want.float().abs().max().item())


def _tiles(p, dtype, recipe=None):
    """Every tile the kernel launches with: te = 1 .. its largest."""
    size = torch.tensor([], dtype=dtype).element_size()
    top = (_cube.helmholtz_max_tile(p, size) if recipe is None
           else t_gemm.gemm.kernel_max_tile(recipe, size))
    return range(1, top + 1)


def _off_alignment(t):
    """A copy of t whose data starts one value past an allocation's
    alignment (the kernels' staging copies 16-byte chunks and takes the
    head and tail by plain loads)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


CFD_P = [5, 7, 11, 16]
CFD_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CFD_DTYPES)
@pytest.mark.parametrize("p", CFD_P)
def test_helmholtz_kernel_matches_plain(cuda, p, dtype):
    """Against the plain version, and bitwise the same whatever the tile
    (every te the kernel launches with), split into two calls of E/2, or
    with inputs off their 16-byte alignment."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    E = 16
    S, D, u = (x.to(dtype) for x in
               _uniform(gen, cuda, (p, p), (E, p, p, p), (E, p, p, p)))
    before = t_hh.inverse_helmholtz.launches
    got = t_hh.inverse_helmholtz(S, D, u)
    want = t_hh.inverse_helmholtz_plain(S, D, u)
    torch.cuda.synchronize()
    assert t_hh.inverse_helmholtz.launches == before + 1
    assert got.dtype == dtype
    _close(got, want, dtype)
    for be in _tiles(p, dtype):
        assert torch.equal(got, t_hh.inverse_helmholtz(S, D, u, block_elements=be))
    halves = torch.cat([t_hh.inverse_helmholtz(S, D[a:a + E // 2],
                                               u[a:a + E // 2])
                        for a in (0, E // 2)])
    assert torch.equal(got, halves)
    shifted = t_hh.inverse_helmholtz(S, _off_alignment(D), _off_alignment(u))
    assert torch.equal(got, shifted)


def _chain_bitwise(recipe, env, got, E):
    """got equals the same recipe at every tile the kernel launches with,
    split into two calls of E/2, and with element inputs off their
    alignment, bit for bit."""
    elem = {n for n, _, is_elem in recipe.inputs if is_elem}
    dtype = next(iter(env.values())).dtype
    for be in _tiles(recipe.p, dtype, recipe):
        other = t_gemm.gemm_chain(recipe, env, block_elements=be)
        assert all(torch.equal(got[k], other[k]) for k in got)
    parts = [t_gemm.gemm_chain(
        recipe, {n: (v[a:a + E // 2] if n in elem else v)
                 for n, v in env.items()})
        for a in (0, E // 2)]
    for k in got:
        assert torch.equal(got[k], torch.cat([parts[0][k], parts[1][k]]))
    shifted = t_gemm.gemm_chain(
        recipe, {n: (_off_alignment(v) if n in elem else v)
                 for n, v in env.items()})
    assert all(torch.equal(got[k], shifted[k]) for k in got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CFD_DTYPES)
@pytest.mark.parametrize("p", CFD_P)
@pytest.mark.parametrize("kind", ["interp", "perm", "ewise"])
def test_gemm_chain_kernel_matches_plain(cuda, kind, p, dtype):
    E = 8
    gen = torch.Generator(device=cuda).manual_seed(0)
    A, u = (x.to(dtype) for x in _uniform(gen, cuda, (p, p), (E, p, p, p)))
    env = {"A": A, "u": u}
    recipe = gemm_recipes(t_gemm, p)[kind]
    before = t_gemm.gemm_chain.launches
    got = t_gemm.gemm_chain(recipe, env)
    want = t_gemm.gemm_chain_plain(recipe, env)
    torch.cuda.synchronize()
    assert t_gemm.gemm_chain.launches == before + 1
    for k in want:
        assert got[k].dtype == dtype
        _close(got[k], want[k], dtype)
    _chain_bitwise(recipe, env, got, E)


def mixed_recipe(p):
    """Two element inputs and two matrices, perms on contractions whose
    results later ops read, ewise ops on staged inputs and on work
    cubes, one slot feeding two outputs and an input fed straight out."""
    inputs = (("A", (p, p), False), ("u", (p, p, p), True),
              ("B", (p, p), False), ("x", (p, p, p), True))
    return t_gemm.GemmRecipe(p=p, inputs=inputs, ops=(
        ("contract", 1, 0, 2, 1, (2, 0, 1)), ("ewise", "add", 4, 1, None),
        ("contract", 5, 2, 0, 0, (1, 2, 0)), ("ewise", "div", 6, 3, None),
        ("ewise", "neg", 7, -1, None), ("contract", 3, 0, 1, 1, (0, 1, 2))),
        outputs=(("a", 4), ("b", 5), ("c", 1), ("d", 5), ("f", 8), ("g", 9)))


def _recipe_env(recipe, E, dtype, gen, device):
    """Uniform inputs in [-1, 1), the divisor x of the mixed recipe in
    [1, 3)."""
    return {name: (torch.rand((E, *shape) if is_elem else shape, generator=gen,
                              device=device) * 2 - 1 + (2 if name == "x" else 0)
                   ).to(dtype)
            for name, shape, is_elem in recipe.inputs}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CFD_DTYPES)
def test_gemm_chain_kernel_takes_mixed_recipes(cuda, dtype):
    """The mixed recipe (mixed_recipe) at p = 5."""
    p, E = 5, 8
    recipe = mixed_recipe(p)
    env = _recipe_env(recipe, E, dtype,
                      torch.Generator(device=cuda).manual_seed(2), cuda)
    got = t_gemm.gemm_chain(recipe, env)
    want = t_gemm.gemm_chain_plain(recipe, env)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], dtype)
    assert torch.equal(got["c"], env["u"])
    _chain_bitwise(recipe, env, got, E)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CFD_DTYPES)
@pytest.mark.parametrize("stage", ["interp", "grad"])
def test_gemm_chain_kernel_runs_the_pipeline_recipes(cuda, stage, dtype):
    """The CFD pipeline's own interp and grad recipes at p = 11, as
    chip_smoke.py's phase 2 gets them."""
    from repro_torch.cfd import operators
    from repro_torch.flow import patterns

    system = operators.compile_cfd_pipeline(11, backends="pallas")
    (program,) = [s.program for s in system.chain.stages if s.name == stage]
    recipe = patterns.match_gemm_chain(program)
    E = 12
    gen = torch.Generator(device=cuda).manual_seed(1)
    env = {name: (torch.rand((E, *shape) if is_elem else shape, generator=gen,
                             device=cuda) * 2 - 1).to(dtype)
           for name, shape, is_elem in recipe.inputs}
    got = t_gemm.gemm_chain(recipe, env)
    want = t_gemm.gemm_chain_plain(recipe, env)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], dtype)
    _chain_bitwise(recipe, env, got, E)


def fused_recipes(p):
    """The GEMM-chain recipes of the fused stages the planner makes on the
    h100-sxm datasheet at p (n_eq = 2,000,000): a two-stage budget on the
    named cuts, and the fully fused chain (15 element slots)."""
    from repro_torch.cfd import operators
    from repro_torch.flow import patterns
    from repro_torch.memory import chain as mchain
    from repro_torch.memory.channels import H100_SXM

    named = operators.build_cfd_chain(p, backends="pallas", target=H100_SXM)
    out = {}
    for k in (2, 1):
        plan = mchain.plan_chain(named, target=H100_SXM, n_eq=2_000_000,
                                 max_stages=k)
        for s in plan.fusion.chain.stages:
            if "+" in s.name:
                out[s.name] = patterns.match_gemm_chain(s.program)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CFD_DTYPES)
@pytest.mark.parametrize("p", [5, 11, 16])
def test_gemm_chain_kernel_runs_the_fused_recipes(cuda, p, dtype):
    """Every fused stage's recipe launches (the fully fused one needs 15
    element slots) and matches the plain version, bitwise the same
    across blocks, splits and alignments."""
    recipes = fused_recipes(p)
    assert "interp+grad+helmholtz" in recipes
    E = 12
    gen = torch.Generator(device=cuda).manual_seed(3)
    for name, recipe in recipes.items():
        env = _recipe_env(recipe, E, dtype, gen, cuda)
        before = t_gemm.gemm_chain.launches
        got = t_gemm.gemm_chain(recipe, env)
        want = t_gemm.gemm_chain_plain(recipe, env)
        torch.cuda.synchronize()
        assert t_gemm.gemm_chain.launches == before + 1, name
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], dtype)
        _chain_bitwise(recipe, env, got, E)


@pytest.mark.cuda
def test_fused_chains_on_the_card_are_bitwise_the_unfused(cuda):
    """At p = 11 on the card: interp+grad fused gives gy, gz and v bit
    for bit as the unfused chain; the fully fused chain gives gy and gz
    so, and v bit for bit as the unfused chain whose Helmholtz stage runs
    its own recipe on the GEMM-chain kernel (the Helmholtz kernel
    contracts the modes in another order)."""
    import dataclasses

    import numpy as np

    from repro_torch.cfd import operators
    from repro_torch.flow import patterns
    from repro_torch.kernels.gemm import ops as gemm_ops
    from repro_torch.memory import chain as mchain
    from repro_torch.memory import fusion
    from repro_torch.memory.channels import H100_SXM

    p, E = 11, 64
    named = operators.build_cfd_chain(p, backends="pallas", target=H100_SXM)
    rng = np.random.default_rng(0)
    elems = {q: rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32)
             for q in ("u", "D")}

    def run(chain, plan):
        inputs = {f"{s.name}.{n}": elems[n]
                  for i, s in enumerate(chain.stages)
                  for n, _ in chain.host_element_inputs(i)}
        res = t_simulation.run_chain(chain, plan, inputs=inputs,
                                     collect_outputs=True)
        return {q.split(".", 1)[1]: v for q, v in res.outputs.items()}

    base = mchain.plan_chain(named, target=H100_SXM, batch_elements=E,
                             n_eq=E)
    want = run(named, base)
    hh = named.stages[2]
    on_chain = mchain.ProgramChain(list(named.stages[:2]) + [mchain.ChainStage(
        hh.name, dataclasses.replace(
            hh.compiled, batched_fn=gemm_ops.make_pallas_impl(
                patterns.match_gemm_chain(hh.program), 1)),
        dict(hh.bindings))])
    want_gemm = run(on_chain, base)
    for groups, ref in (([(0, 1), (2,)], want), ([(0, 1, 2)], want_gemm)):
        fused = fusion.fuse_chain(named, groups)
        plan = mchain.plan_chain(fused, target=H100_SXM, batch_elements=E,
                                 n_eq=E)
        before = t_gemm.gemm_chain.launches
        got = run(fused, plan)
        assert t_gemm.gemm_chain.launches == before + 1
        for q in ("gy", "gz", "v"):
            assert np.array_equal(got[q], ref[q]), (groups, q)


@pytest.mark.cuda
def test_cfd_kernel_tiles_match_the_wrappers_model(cuda):
    """The tile (elements a step, threads, shared bytes) each built kernel
    launches with, by default and at every te up to one past its largest,
    and that largest te (``max_tile``), equal the wrappers' pure mirror."""
    import ctypes

    from repro_torch.kernels import _cuda

    lib = _cuda.library()
    got = (ctypes.c_int * 4)()
    for dtype in CFD_DTYPES:
        code, size = _cuda.dtype_code(dtype), torch.tensor([], dtype=dtype).element_size()
        for p in range(1, _cube.MAX_P + 1):
            top = _cube.helmholtz_max_tile(p, size)
            for te in [None, *range(1, top + 2)]:
                lib.repro_helmholtz_tile(p, code, te or 0, got)
                assert tuple(got) == (*_cube.helmholtz_tile(p, size, te),
                                      top), (p, dtype, te)
            for kind, recipe in gemm_recipes(t_gemm, p).items():
                args = t_gemm.gemm.chain_args(
                    recipe, [0] * len(recipe.inputs), [0] * len(recipe.outputs))
                top = t_gemm.gemm.kernel_max_tile(recipe, size)
                for te in [None, *range(1, top + 2)]:
                    lib.repro_gemm_chain_tile(ctypes.addressof(args), code,
                                              te or 0, got)
                    assert tuple(got) == (
                        *t_gemm.gemm.kernel_tile(recipe, size, te), top), (
                        p, kind, dtype, te)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    """Bad inputs raise in the wrapper before any launch: a block above
    the kernel's largest tile among them (p = 16 takes te = 1 only: 256
    fibers fill 128 threads), and what the shared-memory model refuses
    (at p = 16, eight float32 element inputs), which runs in bfloat16."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    p, E = 5, 4
    S, D, u = _uniform(gen, cuda, (p, p), (E, p, p, p), (E, p, p, p))
    before = t_hh.inverse_helmholtz.launches
    with pytest.raises(ValueError, match="contiguous"):
        t_hh.inverse_helmholtz(S, D, u.transpose(1, 2), block_elements=2)
    with pytest.raises(TypeError, match="one dtype"):
        t_hh.inverse_helmholtz(S, D.bfloat16(), u, block_elements=2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_hh.inverse_helmholtz(S.double(), D.double(), u.double(),
                               block_elements=2)
    S17, D17 = _uniform(gen, cuda, (17, 17), (2, 17, 17, 17))
    with pytest.raises(ValueError, match="p <= 16"):
        t_hh.inverse_helmholtz(S17, D17, D17, block_elements=2)
    assert t_hh.inverse_helmholtz.launches == before
    big = 16
    Sb, Db, ub = _uniform(gen, cuda, (big, big), (64, big, big, big),
                          (64, big, big, big))
    before = t_hh.inverse_helmholtz.launches
    for bad in (2, 64):
        with pytest.raises(ValueError, match="1..1 elements"):
            t_hh.inverse_helmholtz(Sb, Db, ub, block_elements=bad)
    assert t_hh.inverse_helmholtz.launches == before
    got = t_hh.inverse_helmholtz(Sb, Db, ub, block_elements=1)
    _close(got, t_hh.inverse_helmholtz_plain(Sb, Db, ub), torch.float32)
    recipe = gemm_recipes(t_gemm, p)["interp"]
    before = t_gemm.gemm_chain.launches
    with pytest.raises(TypeError, match="one dtype"):
        t_gemm.gemm_chain(recipe, {"A": S.bfloat16(), "u": u},
                          block_elements=2)
    with pytest.raises(ValueError, match="p <= 16"):
        t_gemm.gemm_chain(gemm_recipes(t_gemm, 17)["interp"],
                          {"A": S17, "u": D17}, block_elements=2)
    wide = t_gemm.GemmRecipe(
        p=big, inputs=tuple((f"x{j}", (big,) * 3, True) for j in range(8)),
        ops=(), outputs=tuple((f"y{j}", j) for j in range(8)))
    env = {f"x{j}": x for j, x in
           enumerate(_uniform(gen, cuda, *[(2, big, big, big)] * 8))}
    with pytest.raises(ValueError, match="262400 B of shared memory"):
        t_gemm.gemm_chain(wide, env, block_elements=2)
    assert t_gemm.gemm_chain.launches == before
    env = {k: v.bfloat16() for k, v in env.items()}
    with pytest.raises(ValueError, match="1..1 elements"):
        t_gemm.gemm_chain(wide, env, block_elements=2)
    assert t_gemm.gemm_chain.launches == before
    got = t_gemm.gemm_chain(wide, env)
    assert all(torch.equal(got[f"y{j}"], env[f"x{j}"]) for j in range(8))


def _many_tiles_E(te):
    """An even E whose halves each give every CTA of the largest possible
    grid (16 CTAs on each SM: at least 128 threads a CTA, at most 2,048
    an SM) two tiles of te elements, and one CTA a third, ragged one."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 2 * (2 * 16 * sms * te + 1)


#: (kernel or recipe, p): the test recipes, the mixed one, one with an
#: input fed straight out, and the pipeline's gradient at p = 11
MANY_TILE_CASES = [(kind, p) for kind in
                   ("helmholtz", "interp", "perm", "ewise", "mixed", "pass")
                   for p in CFD_P] + [("grad", 11)]


def _many_tiles_recipe(kind, p):
    if kind == "mixed":
        return mixed_recipe(p)
    if kind == "pass":
        recipe = gemm_recipes(t_gemm, p)["perm"]
        return t_gemm.GemmRecipe(p=p, inputs=recipe.inputs, ops=recipe.ops,
                                 outputs=(("c", 1),) + recipe.outputs)
    if kind == "grad":
        from repro_torch.cfd import operators
        from repro_torch.flow import patterns

        system = operators.compile_cfd_pipeline(p, backends="pallas")
        (program,) = [s.program for s in system.chain.stages if s.name == kind]
        return patterns.match_gemm_chain(program)
    return gemm_recipes(t_gemm, p)[kind]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CFD_DTYPES)
@pytest.mark.parametrize("kind,p", MANY_TILE_CASES)
def test_cfd_kernels_walk_many_tiles_per_cta(cuda, kind, p, dtype):
    """Every CTA of the persistent grid walks two or more tiles (double
    buffers alternating, staged heads and tails held across tiles, the
    Helmholtz kernel refilling u and D mid-tile, a ragged last tile on a
    later pass): against the plain version, inputs fed straight out
    equal to themselves, and bitwise equal to two calls of E/2."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    size = torch.tensor([], dtype=dtype).element_size()
    if kind == "helmholtz":
        E = _many_tiles_E(_cube.helmholtz_tile(p, size)[0])
        S, D, u = (x.to(dtype) for x in
                   _uniform(gen, cuda, (p, p), (E, p, p, p), (E, p, p, p)))
        got = t_hh.inverse_helmholtz(S, D, u)
        _close(got, t_hh.inverse_helmholtz_plain(S, D, u), dtype)
        halves = torch.cat([t_hh.inverse_helmholtz(
            S, D[a:a + E // 2], u[a:a + E // 2], block_elements=1)
            for a in (0, E // 2)])
        assert torch.equal(got, halves)
        return
    recipe = _many_tiles_recipe(kind, p)
    E = _many_tiles_E(t_gemm.gemm.kernel_tile(recipe, size)[0])
    env = _recipe_env(recipe, E, dtype, gen, cuda)
    got = t_gemm.gemm_chain(recipe, env)
    want = t_gemm.gemm_chain_plain(recipe, env)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], dtype)
    names = [n for n, _, _ in recipe.inputs]
    for k, slot in recipe.outputs:
        if slot < len(names):
            assert torch.equal(got[k], env[names[slot]])
    elem = {n for n, _, is_elem in recipe.inputs if is_elem}
    parts = [t_gemm.gemm_chain(
        recipe, {n: (v[a:a + E // 2] if n in elem else v)
                 for n, v in env.items()}, block_elements=1)
        for a in (0, E // 2)]
    for k in got:
        assert torch.equal(got[k], torch.cat([parts[0][k], parts[1][k]]))


FLASH_CASES = [
    # B, Hq, Hkv, Tq, Tk, d, causal  (the reference's sweep, then edges)
    (2, 4, 2, 64, 64, 32, True),
    (1, 8, 2, 32, 128, 16, True),
    (2, 2, 2, 64, 64, 64, False),
    (1, 4, 1, 128, 128, 32, True),
    (1, 2, 2, 16, 16, 128, True),
    (1, 2, 1, 64, 32, 16, True),      # Tq > Tk: fully masked rows
    (1, 2, 1, 192, 64, 64, True),     # query tiles that visit no key
    (2, 4, 2, 96, 96, 128, True),     # ragged last tile
    (2, 4, 2, 96, 160, 64, False),
]


def _flash_inputs(gen, device, B, Hq, Hkv, Tq, Tk, d):
    return [torch.randn(s, generator=gen, device=device)
            for s in ((B * Hq, Tq, d), (B * Hkv, Tk, d), (B * Hkv, Tk, d))]


def flash_close(got, q, k, v, **kw):
    """Kernel output against the plain version within the bound stated
    above; returns max |got - plain|."""
    want, p_bound = t_attn_ref.flash_attention_plain(
        q, k, v, return_p_bound=True, **kw)
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    if q.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=5e-4,
                                   atol=5e-4 * want.abs().max().item())
    else:
        err = (got - want).abs()
        bound = 8e-3 * want.abs() + 1e-4 * want.abs().max() + p_bound
        assert (err <= bound).all(), (
            f"{int((err > bound).sum())} entries off, max |err| "
            f"{err.max().item():.3e}")
    return (got - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    B, Hq, Hkv, Tq, Tk, d, causal = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (x.to(dtype) for x in _flash_inputs(gen, cuda, B, Hq, Hkv, Tq, Tk, d))
    kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=causal, block_q=32,
              block_k=32)
    before = t_attn.flash_attention.launches
    kernel = t_attn_ref.route(dtype, d)
    by_route = t_attn.flash_attention.launches_by_route[kernel]
    got = t_attn.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert t_attn.flash_attention.launches == before + 1
    assert t_attn.flash_attention.launches_by_route[kernel] == by_route + 1
    assert got.dtype == dtype and got.shape == q.shape
    flash_close(got, q, k, v, **kw)
    if B > 1:  # bitwise the same when the batch is split across calls
        half_q, half_kv = B // 2 * Hq, B // 2 * Hkv
        parts = [t_attn.flash_attention(q[a:a + half_q], k[b:b + half_kv],
                                        v[b:b + half_kv], **kw)
                 for a, b in ((0, 0), (half_q, half_kv))]
        assert torch.equal(got, torch.cat(parts))


WGMMA_CASES = [
    # B, Hq, Hkv, Tq, Tk, d, causal, block_q, block_k
    (2, 4, 4, 256, 256, 128, True, 512, 512),    # GQA group 1
    (2, 4, 2, 256, 256, 64, True, 64, 64),       # group 2
    (2, 8, 1, 384, 384, 128, False, 128, 128),   # group 8, non-causal
    (2, 16, 2, 128, 128, 64, False, 128, 128),   # group 8
    (2, 4, 2, 128, 640, 128, True, 128, 128),    # Tq < Tk
    (2, 4, 2, 320, 96, 64, True, 512, 512),      # Tq > Tk, default blocks
    (2, 4, 2, 320, 96, 128, True, 64, 32),       # Tq > Tk, other blocks
    (2, 4, 2, 200, 200, 128, True, 200, 200),    # ragged: 128 divides no T
    (2, 4, 2, 200, 200, 64, False, 200, 200),
    # whisper-tiny's encoder (1,500 frames, one whole-axis block) and
    # decoder (448 tokens) at batch 2
    (2, 6, 6, 1500, 1500, 64, False, 1500, 1500),
    (2, 6, 6, 448, 448, 64, True, 512, 512),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES)
def test_flash_attention_wgmma_route_matches_plain(cuda, case):
    """bfloat16 at d = 64 and 128 runs the tensor-core kernel: against its
    plain version, G heads bitwise equal to two calls of G/2, and the
    route named in launches_by_route."""
    B, Hq, Hkv, Tq, Tk, d, causal, bq, bk = case
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (x.bfloat16() for x in _flash_inputs(gen, cuda, B, Hq, Hkv, Tq, Tk, d))
    kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=causal, block_q=bq,
              block_k=bk)
    counts = dict(t_attn.flash_attention.launches_by_route)
    got = t_attn.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert t_attn.flash_attention.launches_by_route == {
        "wgmma": counts["wgmma"] + 1, "fma": counts["fma"]}
    flash_close(got, q, k, v, **kw)
    # bitwise the same when the batch is split across two calls
    parts = [t_attn.flash_attention(q[a * Hq:(a + 1) * Hq],
                                    k[a * Hkv:(a + 1) * Hkv],
                                    v[a * Hkv:(a + 1) * Hkv], **kw)
             for a in range(B)]
    assert torch.equal(got, torch.cat(parts))


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(512, 512), (32, 16)])
def test_flash_attention_wgmma_fully_masked_rows_are_the_mean(cuda, blocks):
    """Causal, Tq > Tk: a row that sees no key takes p = 1 on every key
    below its K_lim, so it is the mean of V over [0, K_lim) (0 when
    K_lim = 0), as in the reference."""
    Hq, Hkv, Tq, Tk, d = 4, 2, 320, 96, 128
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (x.bfloat16() for x in _flash_inputs(gen, cuda, 1, Hq, Hkv, Tq, Tk, d))
    kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, block_q=blocks[0], block_k=blocks[1])
    got = t_attn.flash_attention(q, k, v, **kw).float()
    lim = t_attn_ref.key_limits(Tq, Tk, *t_attn_ref.check_blocks(Tq, Tk, *blocks),
                                True, cuda)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=0)      # (G, Tk, d)
    csum = torch.cat([torch.zeros_like(vf[:, :1]), vf.cumsum(1)], dim=1)
    for row in range(Tq - Tk):
        n = int(lim[row])
        want = csum[:, n] / n if n else torch.zeros_like(csum[:, 0])
        torch.testing.assert_close(got[:, row], want, rtol=4e-3, atol=1e-5)


@pytest.mark.cuda
def test_flash_attention_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _flash_inputs(gen, cuda, 1, 2, 1, 64, 64, 32)
    kw = dict(n_q_heads=2, n_kv_heads=1)
    before = t_attn.flash_attention.launches
    with pytest.raises(ValueError, match="contiguous"):
        t_attn.flash_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                               v, **kw)
    with pytest.raises(TypeError, match="one dtype"):
        t_attn.flash_attention(q, k.bfloat16(), v, **kw)
    with pytest.raises(ValueError, match="head dims"):
        q48, k48 = (torch.randn(n, 64, 48, device=cuda) for n in (2, 1))
        t_attn.flash_attention(q48, k48, k48, **kw)
    with pytest.raises(ValueError, match="not divisible"):
        t_attn.flash_attention(q, k, v, block_q=48, **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_attn.flash_attention(q.half(), k.half(), v.half(), **kw)
    with pytest.raises(ValueError, match="head dims"):
        q48, k48 = (torch.randn(n, 64, 48, device=cuda).bfloat16() for n in (2, 1))
        t_attn.flash_attention(q48, k48, k48, **kw)
    with pytest.raises(ValueError, match="16-byte alignment"):
        qb = torch.randn(2 * 64 * 64 + 1, device=cuda).bfloat16()[1:].view(2, 64, 64)
        kb = torch.randn(1, 64, 64, device=cuda).bfloat16()
        t_attn.flash_attention(qb, kb, kb, **kw)
    assert t_attn.flash_attention.launches == before


BWD_CASES = [
    # B, Hq, Hkv, Tq, Tk, d, causal
    (2, 4, 2, 128, 128, 16, True),    # GQA 2:1
    (1, 4, 1, 96, 160, 32, True),     # Tq < Tk, ragged tiles
    (2, 2, 2, 64, 64, 64, False),
    (1, 8, 2, 200, 200, 128, True),   # group 4, ragged last tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(cuda, case, dtype):
    """The backward kernel of the case's route against its plain version
    on the same (q, k, v, o, lse, do): float32 within rtol 5e-4 / atol
    5e-4 max|plain|, bfloat16 within one bfloat16 step (rtol 8e-3) + 1e-3
    max|plain| (both compute in float32 from the same inputs, in other
    orders, round p and ds where the route's kernel does -- only on the
    wgmma route, bf16 at d 64/128 -- and round each gradient once);
    bitwise repeatable and the same when the batch is split across calls;
    one count a call; the forward kernel's LSE against the plain
    version's."""
    B, Hq, Hkv, Tq, Tk, d, causal = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (x.to(dtype) for x in _flash_inputs(gen, cuda, B, Hq, Hkv, Tq, Tk, d))
    do = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
    kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=causal)
    o, lse = t_attn._forward_kernel(q, k, v, scale=d ** -0.5, block_q=512,
                                    block_k=512, with_lse=True, **kw)
    _, want_lse = t_attn_ref.flash_attention_plain(q, k, v, return_lse=True,
                                                   **kw)
    torch.testing.assert_close(lse, want_lse, rtol=5e-4,
                               atol=5e-4 * want_lse.abs().max().item())
    before = t_attn.flash_attention_bwd.launches
    got = t_attn.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert t_attn.flash_attention_bwd.launches == before + 1
    want = t_attn_ref.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    rtol, frac = (5e-4, 5e-4) if dtype == torch.float32 else (8e-3, 1e-3)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=frac * w.float().abs().max().item())
    again = t_attn.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if B > 1:
        hq, hk = B // 2 * Hq, B // 2 * Hkv
        parts = [t_attn.flash_attention_bwd(
            q[a:a + hq], k[b:b + hk], v[b:b + hk], o[a:a + hq],
            lse[a:a + hq], do[a:a + hq], **kw)
            for a, b in ((0, 0), (hq, hk))]
        for i, g in enumerate(got):
            assert torch.equal(g, torch.cat([pt[i] for pt in parts]))


WGMMA_BWD_CASES = [
    # B, Hq, Hkv, Tq, Tk, d, causal
    (2, 4, 2, 256, 256, 128, True),   # GQA 2:1
    (2, 8, 1, 192, 192, 128, True),   # GQA 8:1
    (2, 4, 2, 96, 320, 128, True),    # Tq < Tk
    (2, 2, 1, 200, 200, 128, True),   # ragged last query and key tiles
    (2, 3, 3, 160, 224, 64, False),   # d 64, non-causal, Tq < Tk, ragged
    (16, 6, 6, 448, 448, 64, True),   # whisper-tiny's decoder self-attention
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_BWD_CASES)
def test_flash_attention_bwd_wgmma_route_matches_plain(cuda, case):
    """The tensor-core backward (bfloat16 at d 64 and 128) against its
    plain version on the same (q, k, v, o, lse, do), per element within
    rtol 8e-3 + 1e-3 max|plain|: both round p and ds to bfloat16 at the
    same places and sum in float32 in other orders, so they differ by a
    bfloat16 step of an output, or of a p or ds whose float32 values
    straddle a rounding boundary.  Bitwise repeatable, a batch split
    across two calls gives the same bits, one count on the wgmma route."""
    B, Hq, Hkv, Tq, Tk, d, causal = case
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (x.bfloat16() for x in _flash_inputs(gen, cuda, B, Hq, Hkv, Tq, Tk, d))
    do = torch.randn(q.shape, generator=gen, device=cuda).bfloat16()
    kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=causal)
    assert t_attn_ref.route(q.dtype, d) == "wgmma"
    o, lse = t_attn._forward_kernel(q, k, v, scale=d ** -0.5, block_q=512,
                                    block_k=512, with_lse=True, **kw)
    by_route = dict(t_attn.flash_attention_bwd.launches_by_route)
    got = t_attn.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert t_attn.flash_attention_bwd.launches_by_route == dict(
        by_route, wgmma=by_route["wgmma"] + 1)
    want = t_attn_ref.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), w.float(), rtol=8e-3,
                                   atol=1e-3 * w.float().abs().max().item())
    again = t_attn.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    hq, hk = B // 2 * Hq, B // 2 * Hkv
    parts = [t_attn.flash_attention_bwd(
        q[a:a + hq], k[b:b + hk], v[b:b + hk], o[a:a + hq], lse[a:a + hq],
        do[a:a + hq], **kw) for a, b in ((0, 0), (hq, hk))]
    for i, g in enumerate(got):
        assert torch.equal(g, torch.cat([pt[i] for pt in parts]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_on_the_card(cuda, dtype):
    """multi_head_attention(impl="pallas") differentiated on the card: one
    forward launch (with LSE) and one backward call, the gradients those
    of the plain versions on the same card."""
    from repro_torch.kernels.attention import ops as t_ops

    gen = torch.Generator(device=cuda).manual_seed(1)
    B, Hq, Hkv, T, d = 2, 4, 2, 128, 64
    leaves = [torch.randn(s, generator=gen, device=cuda).to(dtype)
              .requires_grad_() for s in ((B, Hq, T, d), (B, Hkv, T, d),
                                          (B, Hkv, T, d))]
    do = torch.randn(B, Hq, T, d, generator=gen, device=cuda).to(dtype)
    fwd, bwd = t_attn.flash_attention.launches, t_attn.flash_attention_bwd.launches
    o = t_ops.multi_head_attention(*leaves, impl="pallas")
    got = torch.autograd.grad(o, leaves, do)
    assert t_attn.flash_attention.launches == fwd + 1
    assert t_attn.flash_attention_bwd.launches == bwd + 1
    o2 = t_ops.multi_head_attention(*leaves, impl="interpret")
    want = torch.autograd.grad(o2, leaves, do)
    assert t_attn.flash_attention.launches == fwd + 1   # plain: no kernel
    rtol, frac = (5e-4, 5e-4) if dtype == torch.float32 else (2e-2, 1e-2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=frac * w.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 4, 2, 128, 128, 64, True),
                                  (1, 8, 1, 96, 160, 128, True),
                                  (2, 4, 2, 96, 160, 64, False)])
def test_flash_custom_ops_launch_the_kernels_directly(cuda, case, dtype):
    """``repro_torch::flash_fwd`` and ``repro_torch::flash_bwd`` on the
    card: the same launch, counted once on the same route as calling the
    kernels' launch functions, and outputs bitwise equal to theirs."""
    B, Hq, Hkv, Tq, Tk, d, causal = case
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (t.to(dtype) for t in _flash_inputs(gen, cuda, B, Hq, Hkv,
                                                  Tq, Tk, d))
    do = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
    kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=causal, scale=d ** -0.5)
    route = t_attn_ref.route(dtype, d)
    fwd = dict(t_attn.flash_attention.launches_by_route)
    o, lse = torch.ops.repro_torch.flash_fwd(
        q, k, v, Hq, Hkv, causal, kw["scale"], 32, 32, True)
    o_k, lse_k = t_attn._forward_kernel(q, k, v, block_q=32, block_k=32,
                                        with_lse=True, **kw)
    fwd[route] += 2
    assert t_attn.flash_attention.launches_by_route == fwd
    assert torch.equal(o, o_k) and torch.equal(lse, lse_k)
    bwd = dict(t_attn.flash_attention_bwd.launches_by_route)
    got = torch.ops.repro_torch.flash_bwd(q, k, v, o, lse, do, Hq, Hkv,
                                          causal, kw["scale"])
    want = t_attn._backward_kernel(q, k, v, o, lse, do, **kw)
    bwd[route] += 2
    assert t_attn.flash_attention_bwd.launches_by_route == bwd
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_flash_attention_bwd_refuses_what_the_kernel_cannot_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _flash_inputs(gen, cuda, 1, 2, 1, 64, 32, 32)
    lse = torch.zeros(2, 64, device=cuda)
    kw = dict(n_q_heads=2, n_kv_heads=1)
    before = t_attn.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="Tq <= Tk"):
        t_attn.flash_attention_bwd(q, k, v, q, lse, q, **kw)
    q, k, v = _flash_inputs(gen, cuda, 1, 2, 1, 64, 64, 32)
    with pytest.raises(TypeError, match="one dtype"):
        t_attn.flash_attention_bwd(q, k, v, q, lse, q.bfloat16(), **kw)
    with pytest.raises(ValueError, match="lse"):
        t_attn.flash_attention_bwd(q, k, v, q, lse.double(), q, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        t_attn.flash_attention_bwd(q, k, v, q, lse, q.transpose(1, 2)
                                   .contiguous().transpose(1, 2), **kw)
    assert t_attn.flash_attention_bwd.launches == before


@pytest.mark.cuda
def test_matmul_f32_gradient_on_the_card(cuda):
    """The bfloat16 product's Function on the card: its gradients are the
    float32 products of the bfloat16-rounded cotangent with the other
    operand, rounded once to bfloat16."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(2, 3, 64, 96, generator=gen, device=cuda).bfloat16()
    for b in (torch.randn(96, 80, generator=gen, device=cuda).bfloat16(),
              torch.randn(2, 3, 96, 40, generator=gen, device=cuda).bfloat16()):
        a_, b_ = a.clone().requires_grad_(), b.clone().requires_grad_()
        out = matmul_f32(a_, b_)
        g = torch.randn(out.shape, generator=gen, device=cuda)
        da, db = torch.autograd.grad(out, (a_, b_), g)
        assert da.dtype == db.dtype == torch.bfloat16
        gr = g.bfloat16().double()
        want_a = torch.matmul(gr, b.double().transpose(-1, -2))
        want_b = torch.matmul(a.double().transpose(-1, -2), gr)
        if b.dim() == 2:
            want_b = want_b.sum(dim=(0, 1))
        for got, want in ((da, want_a), (db, want_b)):
            torch.testing.assert_close(got.double(), want, rtol=2 ** -7,
                                       atol=1e-3 * want.abs().max().item())


@pytest.mark.cuda
def test_matmul_f32_keeps_bf16_products_in_float32(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(2, 3, 64, 96, generator=gen, device=cuda).bfloat16()
    w = torch.randn(96, 80, generator=gen, device=cuda).bfloat16()
    bt = torch.randn(2, 3, 96, 40, generator=gen, device=cuda).bfloat16()
    for b in (w, bt):
        got = matmul_f32(a, b)
        want = torch.matmul(a.double(), b.double())
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="neither 2-D nor batched"):
        matmul_f32(a, bt[0])
    with pytest.raises(TypeError, match="operands of"):
        matmul_f32(a, w.float())


def _limb_edges():
    """Q24.40 values at the 64-bit multiply's limb edges: high limb
    +-(2**31 - 1) and -2**31, low limb 2**32 - 1, the int64 extremes."""
    hi = [2 ** 31 - 1, -(2 ** 31 - 1), -2 ** 31, 0, 1, -1]
    lo = [2 ** 32 - 1, 0, 1, 2 ** 31]
    vals = {(h << 32) | l for h in hi for l in lo} | {2 ** 63 - 1, -2 ** 63}
    return torch.tensor(sorted(vals), dtype=torch.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("pol", [FIXED32, FIXED64], ids=lambda p: p.name)
def test_fixed_point_contract_on_the_card_equals_cpu(cuda, pol, monkeypatch):
    """Limb products, shifts and wrapping integer sums on CUDA tensors
    give the CPU's bits, whole and in chunks."""
    gen = torch.Generator().manual_seed(5)
    a = pol.encode(torch.rand(64, 11, 11, 11, generator=gen, dtype=torch.float64) * 2 - 1)
    b = pol.encode(torch.rand(11, 11, generator=gen, dtype=torch.float64) * 2 - 1)
    want = pol.contract(a, b, "Zabc,da->Zdbc")
    got = pol.contract(a.to(cuda), b.to(cuda), "Zabc,da->Zdbc")
    assert got.device.type == "cuda" and got.cpu().equal(want)
    monkeypatch.setattr(t_prec, "CONTRACT_CHUNK_VALUES", 1 << 12)
    assert pol.contract(a.to(cuda), b.to(cuda), "Zabc,da->Zdbc").cpu().equal(want)
    if pol is FIXED64:
        x, y = torch.meshgrid(_limb_edges(), _limb_edges(), indexing="ij")
        assert pol.fmul(x.to(cuda), y.to(cuda)).cpu().equal(pol.fmul(x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["xla", "staged"])
@pytest.mark.parametrize("pol", [FIXED32, FIXED64], ids=lambda p: p.name)
def test_fixed_point_helmholtz_on_the_card_equals_cpu(cuda, pol, backend):
    src = t_dsl.INVERSE_HELMHOLTZ_SRC.format(p=7)
    gen = torch.Generator().manual_seed(6)
    env = {k: pol.encode(torch.rand(*shape, generator=gen, dtype=torch.float64) * 2 - 1)
           for k, shape in (("S", (7, 7)), ("D", (40, 7, 7, 7)), ("u", (40, 7, 7, 7)))}
    kw = dict(element_vars=("u", "D", "v"), policy=pol, backend=backend)
    got = api.compile_cfdlang(src, **kw).batched_fn(env)["v"]
    want = api.compile_cfdlang(src, device="cpu", **kw).batched_fn(env)["v"]
    assert got.device.type == "cuda" and got.cpu().equal(want)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "xla", "staged"])
def test_run_simulation_on_the_card_matches_cpu(cuda, backend):
    cfg = t_simulation.SimConfig(p=5, n_eq=3 * 96, batch_elements=96,
                                 backend=backend, seed=2)
    got = t_simulation.run_simulation(cfg)
    serial = t_simulation.run_simulation(
        t_simulation.SimConfig(**{**cfg.__dict__, "prefetch_depth": 0}))
    want = t_simulation.run_simulation(cfg, device="cpu")
    assert got.device.startswith("cuda") and got.batches == 3
    assert serial.checksum == got.checksum
    assert got.checksum == pytest.approx(want.checksum, rel=1e-4)


def _pipeline_programs(p):
    """The pipeline's three stage programs at p, by stage name."""
    from repro_torch.cfd import operators

    system = operators.compile_cfd_pipeline(p, backends="pallas",
                                            device="cpu")
    return {s.name: s.program for s in system.chain.stages}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CFD_DTYPES)
@pytest.mark.parametrize("p", [5, 11])
@pytest.mark.parametrize("stage", ["interp", "grad", "helmholtz"])
def test_cfd_kernels_at_every_legal_tile_equal_the_default(cuda, stage, p,
                                                            dtype):
    """Each CFD kernel on its pipeline stage launches at every te from 1
    to its largest (3 at p = 11, 15 at p = 5, float32) on a ragged E, and
    each gives the default tile's bits; one past the largest is refused
    before the launch."""
    from repro_torch.flow import patterns

    prog = _pipeline_programs(p)[stage]
    size = torch.tensor([], dtype=dtype).element_size()
    default_te, _, _, top = patterns.kernel_tile_for(prog, size)
    E = 4 * top + 3
    gen = torch.Generator(device=cuda).manual_seed(4)
    elem = set(prog.element_vars)
    env = {n: (torch.rand(((E,) if n in elem else ()) + tuple(v.shape),
                          generator=gen, device=cuda) * 2 - 1).to(dtype)
           for n, v in prog.inputs.items()}
    counter = (t_hh.inverse_helmholtz if stage == "helmholtz"
               else t_gemm.gemm_chain)
    before = counter.launches
    want = patterns.pallas_impl_for(prog)(env)
    for te in range(1, top + 1):
        got = patterns.pallas_impl_for(prog, block_elements=te)(env)
        assert all(torch.equal(got[k], want[k]) for k in want), te
    torch.cuda.synchronize()
    assert counter.launches == before + 1 + top
    with pytest.raises(ValueError, match=f"1..{top} elements"):
        patterns.pallas_impl_for(prog, block_elements=top + 1)(env)
    assert counter.launches == before + 1 + top
    if (p, dtype) == (11, torch.float32):
        assert (default_te, top) == (3, 3)
    if (p, dtype) == (5, torch.float32):
        assert top == 15


@pytest.mark.cuda
def test_tune_blocks_on_the_card_picks_a_legal_tile(cuda):
    """flow.compile(tune_blocks=True) on the card times each stage's
    legal tiles with CUDA events and runs the winners, bitwise the
    untuned chain's outputs."""
    import numpy as np

    from repro_torch import flow
    from repro_torch.cfd import operators

    p, E = 11, 256
    src = operators.CFD_PIPELINE_SRC.format(p=p)
    kw = dict(stages=operators.CFD_PIPELINE_STAGES, target="h100-sxm",
              backend="pallas", batch_elements=E, n_eq=E)
    tuned = flow.compile(src, tune_blocks=True, **kw)
    plain = flow.compile(src, **kw)
    for sp in tuned.plan.stages:
        t = tuned.tuning[sp.name]
        assert [be for be, _, _ in t.candidates] == [1, 2, 3]
        assert sp.block_elements == t.block_elements in (1, 2, 3)
        assert all(s > 0 for _, _, s in t.candidates)
    rng = np.random.default_rng(0)
    inputs = {"interp.u": rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32),
              "helmholtz.D": rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32)}
    got = tuned.run(inputs=inputs, collect_outputs=True).outputs
    want = plain.run(inputs=inputs, collect_outputs=True).outputs
    assert all(np.array_equal(got[q], want[q]) for q in want)


@pytest.mark.cuda
def test_reference_target_plans_run_and_tune_on_the_card(cuda):
    """A plan for alveo-u280 (VMEM blocks of 512 at p = 11, no CUDA
    tile) compiles, runs and is measured on the card, its kernels at
    their default tile; tune_blocks times the kernels' tiles there and
    leaves the plan's blocks; run_simulation takes such a plan."""
    import numpy as np

    from repro_torch import flow
    from repro_torch.cfd import operators
    from repro_torch.memory import dse
    from repro_torch.memory.channels import ALVEO_U280

    p, E = 11, 512
    src = operators.CFD_PIPELINE_SRC.format(p=p)
    kw = dict(stages=operators.CFD_PIPELINE_STAGES, target="alveo-u280",
              backend="pallas", batch_elements=E, n_eq=E)
    plain = flow.compile(src, **kw)
    tuned = flow.compile(src, tune_blocks=True, **kw)
    blocks = [sp.block_elements for sp in plain.plan.stages]
    assert blocks == [512] * 3
    assert [sp.block_elements for sp in tuned.plan.stages] == blocks
    for t in tuned.tuning.values():
        assert t.kernel_tile
        assert [be for be, _, _ in t.candidates] == [1, 2, 3]
        assert t.block_elements in (1, 2, 3)
    rng = np.random.default_rng(0)
    inputs = {"interp.u": rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32),
              "helmholtz.D": rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32)}
    got = tuned.run(inputs=inputs, collect_outputs=True).outputs
    want = plain.run(inputs=inputs, collect_outputs=True).outputs
    assert all(np.array_equal(got[q], want[q]) for q in want)
    secs = dse.measure_chain_plan(plain.chain, plain.plan, max_batches=1)
    assert secs is not None and secs > 0
    cfg = t_simulation.SimConfig(p=p, backend="pallas", n_eq=E)
    plan = t_simulation.plan_config(cfg, target=ALVEO_U280)
    assert plan.block_elements == 512
    res = t_simulation.run_simulation(cfg, plan=plan, max_batches=1)
    assert res.elements == E and np.isfinite(res.checksum)


@pytest.mark.cuda
def test_per_stage_batches_on_the_card_are_bitwise_uniform(cuda):
    """run_chain at per-stage E (E, E/2, E/4) and (E/4, E, E/2) on the
    card gives the uniform serial run's bits; measure_chain_plan times
    such a plan."""
    import numpy as np

    from repro_torch.cfd import operators
    from repro_torch.memory import chain as mchain
    from repro_torch.memory import dse
    from repro_torch.memory.channels import H100_SXM

    p, E = 11, 96
    chain = operators.build_cfd_chain(p, backends="pallas", target=H100_SXM)
    rng = np.random.default_rng(1)
    inputs = {"interp.u": rng.uniform(-1, 1, (2 * E, p, p, p)).astype(np.float32),
              "helmholtz.D": rng.uniform(-1, 1, (2 * E, p, p, p)).astype(np.float32)}
    base = mchain.plan_chain(chain, target=H100_SXM, batch_elements=E,
                             n_eq=2 * E, prefetch_depth=0)
    want = t_simulation.run_chain(chain, base, inputs=inputs,
                                  collect_outputs=True,
                                  pipeline_stages=False).outputs
    for es in ((E, E // 2, E // 4), (E // 4, E, E // 2)):
        plan = mchain.plan_chain(chain, target=H100_SXM, batch_elements=E,
                                 n_eq=2 * E, stage_batch_elements=es)
        assert plan.stage_batch_elements == es
        got = t_simulation.run_chain(chain, plan, inputs=inputs,
                                     collect_outputs=True).outputs
        assert all(np.array_equal(got[q], want[q]) for q in want), es
        secs = dse.measure_chain_plan(chain, plan, max_batches=2)
        assert secs is not None and secs > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pol", [FIXED32, FIXED64], ids=lambda p: p.name)
def test_fixed_point_contract_peak_falls_with_chunked_widening(cuda, pol):
    """The chunked widening holds no widened copy of the whole batched
    operand: the peak above the inputs falls below that of widening the
    whole operand first, with the same bits."""
    gen = torch.Generator().manual_seed(6)
    a = pol.encode(torch.rand(4096, 11, 11, 11, generator=gen,
                              dtype=torch.float64) * 2 - 1).to(cuda)
    b = pol.encode(torch.rand(11, 11, generator=gen,
                              dtype=torch.float64) * 2 - 1).to(cuda)
    spec = "Zabc,da->Zdbc"

    def whole(x, y):
        """``contract`` as it was before: the whole operands widened (an
        int64 cast, or limbs) first, then the products in chunks."""
        in_spec, out_spec = spec.split("->")
        sa, sb = in_spec.split(",")
        union = sa + "".join(c for c in sb if c not in sa)
        dims = {**dict(zip(sa, x.shape)), **dict(zip(sb, y.shape))}

        def expand(t, s_):
            return t.permute([s_.index(c) for c in union if c in s_]).reshape(
                tuple(dims[c] if c in s_ else 1 for c in union))

        if pol.total_bits == 32:
            ea, eb = expand(x.to(torch.int64), sa), expand(y.to(torch.int64), sb)
        else:
            ea, eb = t_prec._split64(expand(x, sa)), t_prec._split64(expand(y, sb))
        kept = [i for i, c in enumerate(union) if c in out_spec]
        sums = [i for i, c in enumerate(union) if c not in out_spec]
        axis = max(kept, key=lambda i: dims[union[i]])
        extent = dims[union[axis]]
        n_union = 1
        for c in union:
            n_union *= dims[c]
        step = max(1, t_prec.CONTRACT_CHUNK_VALUES // (n_union // extent))
        out = torch.empty([dims[union[i]] for i in kept],
                          dtype=pol.storage_dtype, device=x.device)

        def part(t, i0, n):
            if isinstance(t, torch.Tensor):
                return t if t.shape[axis] == 1 else t.narrow(axis, i0, n)
            return [part(u, i0, n) for u in t]

        for i0 in range(0, extent, step):
            n = min(step, extent - i0)
            pa, pb = part(ea, i0, n), part(eb, i0, n)
            if pol.total_bits == 32:
                prod = pa * pb
                prod += 1 << (pol.frac_bits - 1)
                prod >>= pol.frac_bits
            else:
                prod = t_prec._fmul64(pa, pb, pol.frac_bits)
            out.narrow(kept.index(axis), i0, n).copy_(prod.sum(dim=sums))
        remaining = [c for c in union if c in out_spec]
        return out.permute([remaining.index(c) for c in out_spec])

    def peak(fn):
        torch.cuda.synchronize(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        out = fn()
        torch.cuda.synchronize(cuda)
        return torch.cuda.max_memory_allocated(cuda) - base, out

    chunked, got = peak(lambda: pol.contract(a, b, spec))
    widened, want = peak(lambda: whole(a, b))
    assert torch.equal(got, want)
    operand = a.numel() * 8 * (1 if pol.total_bits == 32 else 2)
    assert chunked + operand // 2 < widened, (chunked, widened, operand)


@pytest.mark.cuda
@pytest.mark.parametrize("pol", [FIXED32, FIXED64], ids=lambda p: p.name)
def test_fixed_point_fmul_peak_falls_with_slices(cuda, pol, monkeypatch):
    """The elementwise multiply widens a slice at a time: the peak above
    the inputs falls below that of widening both whole operands (one
    slice as large as the tensor), with the same bits."""
    gen = torch.Generator().manual_seed(7)
    a, b = (pol.encode(torch.rand(16384, 11, 11, 11, generator=gen,
                                  dtype=torch.float64) * 2 - 1).to(cuda)
            for _ in range(2))

    def peak():
        torch.cuda.synchronize(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        out = pol.fmul(a, b)
        torch.cuda.synchronize(cuda)
        return torch.cuda.max_memory_allocated(cuda) - base, out

    monkeypatch.setattr(t_prec, "CONTRACT_CHUNK_VALUES", 1 << 22)
    sliced, got = peak()
    monkeypatch.setattr(t_prec, "CONTRACT_CHUNK_VALUES", 1 << 40)
    whole, want = peak()
    assert torch.equal(got, want)
    assert 2 * sliced < whole, (sliced, whole)


def _card_chain(cuda, p=5, e=64, n=3):
    import numpy as np

    from repro_torch.cfd import operators
    from repro_torch.memory import chain as mchain
    from repro_torch.memory.channels import H100_SXM

    chain = operators.build_cfd_chain(p, backends="pallas", target=H100_SXM)
    plan = mchain.plan_chain(chain, target=H100_SXM, batch_elements=e,
                             n_eq=n * e, prefetch_depth=1)
    rng = np.random.default_rng(4)
    inputs = {q: rng.uniform(-1, 1, (n * e, p, p, p)).astype(np.float32)
              for q in ("interp.u", "helmholtz.D")}
    return chain, plan, inputs


@pytest.mark.cuda
def test_traced_spans_carry_cuda_event_durations(cuda):
    """With a tracer on the card every slot and dispatch span holds the
    CUDA events' interval (the host clock's duration kept as host_s),
    the trace stays schema-valid, and the attribution sums device time."""
    from repro_torch import trace
    from repro_torch.trace.attribution import CAT_DISPATCH, CAT_SLOT

    chain, plan, inputs = _card_chain(cuda)
    tracer = trace.Tracer()
    t_simulation.run_chain(chain, plan, inputs=inputs, tracer=tracer,
                           pipeline_stages=True)
    assert trace.validate(trace.to_chrome(tracer)) == []
    slots = [s for s in tracer.spans if s.cat == CAT_SLOT]
    disp = [s for s in tracer.spans if s.cat == CAT_DISPATCH]
    assert len(slots) == len(disp) == 3 * len(plan.stages)
    for s, d in zip(slots, disp):
        assert "host_s" in s.args and "host_s" in d.args
        assert (s.t0, s.t1) == (d.t0, d.t1) and d.duration > 0
    for i in range(len(plan.stages)):   # one stream: a stage's spans in order
        mine = sorted((s.t0, s.t1) for s in disp if s.args["stage"] == i)
        assert all(a[1] <= b[0] for a, b in zip(mine, mine[1:]))
    a = trace.attribute(tracer, plan)
    assert [st.measured_s for st in a.stages] == pytest.approx(
        [sum(d.duration for d in disp if d.args["stage"] == i)
         for i in range(len(plan.stages))])
    assert [s["clock"] for s in trace.samples_from_trace(tracer, plan)
            if s["scope"].startswith("stage:")] == ["device"] * 3


@pytest.mark.cuda
def test_tracer_off_is_bitwise_identical_on_the_card(cuda):
    from repro_torch import metrics, trace
    from repro_torch.runtime.monitor import StepMonitor

    chain, plan, inputs = _card_chain(cuda)
    kw = dict(inputs=inputs, collect_outputs=True, pipeline_stages=True)
    plain = t_simulation.run_chain(chain, plan, **kw)
    seen = t_simulation.run_chain(chain, plan, tracer=trace.Tracer(),
                                  monitor=StepMonitor(),
                                  metrics=metrics.MetricsRegistry(), **kw)
    for q, v in plain.outputs.items():
        assert (seen.outputs[q] == v).all(), q


@pytest.mark.cuda
def test_engine_stage_error_poisons_only_its_wave_on_the_card(cuda):
    """A host-side stage error on the card is captured for its wave (the
    card reports no fault); the other requests are served bitwise equal
    to serial runs."""
    import numpy as np

    from repro_torch.cfd import operators
    from repro_torch.serve import ServeEngine

    e = 32
    system = operators.compile_cfd_pipeline(5, backends="pallas",
                                            batch_elements=e, n_eq=2 * e)
    eng = ServeEngine(system, seed=0)
    q0 = sorted(eng.in_specs)[0]
    orig = eng.driver.stage_fns[0]

    def boom(staged, carry):
        if float(staged.arrays()[q0][0].flatten()[0]) == 777.0:
            raise RuntimeError("injected stage failure")
        return orig(staged, carry)

    eng.driver.stage_fns[0] = boom
    rng = np.random.default_rng(2)
    reqs = [{q: rng.uniform(-1, 1, (e,) + s).astype(np.float32)
             for q, s in sorted(eng.in_specs.items())} for _ in range(3)]
    reqs[1][q0][:] = 777.0
    served = [eng.submit(r) for r in reqs]
    eng.drain()
    assert "injected" in str(served[1].error)
    serial = ServeEngine(system, seed=0)
    for i in (0, 2):
        assert served[i].error is None
        one = serial.submit(reqs[i])
        serial.drain()
        for q in eng.out_names:
            assert np.array_equal(served[i].outputs[q], one.outputs[q])


# ---------------------------------------------------------------------------
# element-axis placement over a device pool
# ---------------------------------------------------------------------------


@pytest.fixture
def two_cards():
    """Two CUDA cards, or a skip where there are fewer."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _placed_plan(chain, e, n):
    from repro_torch.memory import chain as mchain
    from repro_torch.memory.channels import H100_SXM
    from repro_torch.memory.placement import DeviceTopology

    return mchain.plan_chain(chain, target=H100_SXM, batch_elements=e,
                             n_eq=n * e, prefetch_depth=1,
                             cu_count=(1, 2, 1),
                             topology=DeviceTopology.homogeneous(2))


@pytest.mark.cuda
def test_two_slot_chain_on_one_card_is_bitwise_one_slot(cuda):
    """A placement over the pool [cuda:0, cuda:0] (grad sharded over both
    slots, each handoff re-sharded) gives the one-slot serial run's bits,
    launches each kernel once a shard, and traces its handoffs in device
    time."""
    import numpy as np

    from repro_torch import trace
    from repro_torch.memory import chain as mchain
    from repro_torch.memory.channels import H100_SXM

    chain, _, inputs = _card_chain(cuda)
    e, n = 64, 3
    plan = _placed_plan(chain, e, n)
    base = mchain.plan_chain(chain, target=H100_SXM, batch_elements=e,
                             n_eq=n * e, prefetch_depth=0)
    want = t_simulation.run_chain(chain, base, inputs=inputs,
                                  collect_outputs=True, devices=[cuda],
                                  pipeline_stages=False).outputs
    t_gemm.gemm_chain.launches = t_hh.inverse_helmholtz.launches = 0
    tracer = trace.Tracer()
    got = t_simulation.run_chain(chain, plan, inputs=inputs,
                                 collect_outputs=True, devices=[cuda, cuda],
                                 tracer=tracer)
    torch.cuda.synchronize()
    assert got.placement_groups == ((0,), (1, 0), (1,))
    assert (t_gemm.gemm_chain.launches, t_hh.inverse_helmholtz.launches) == (
        3 * n, n)
    for q in want:
        assert np.array_equal(got.outputs[q], want[q]), q
    assert trace.validate(trace.to_chrome(tracer)) == []
    hand = [s for s in tracer.spans if s.cat == "handoff"]
    assert len(hand) == 2 * n and all("host_s" in s.args for s in hand)


@pytest.mark.cuda
def test_launch_guard_yields_the_current_stream(cuda):
    """Inside a side stream's context a launch takes that stream, on the
    tensors' card."""
    from repro_torch.kernels import _cuda

    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        with _cuda.launch_on(cuda) as handle:
            assert handle.value == side.cuda_stream
            assert torch.cuda.current_device() == cuda.index


@pytest.mark.cuda
def test_device_guard_launches_on_the_tensors_card(two_cards):
    """With cuda:0 current, the CFD kernels on tensors of cuda:1 launch
    there (their grids sized by that card, its stream) and equal the
    plain version; the current device is left as it was.  The chain over
    the pool [cuda:0, cuda:1] gives the one-card run's bits."""
    import numpy as np

    from repro_torch.memory import chain as mchain
    from repro_torch.memory.channels import H100_SXM

    c0, c1 = two_cards
    torch.cuda.set_device(c0)
    p, e = 11, 96
    gen = torch.Generator().manual_seed(5)
    S, D, u = (torch.rand(sh, generator=gen) * 2 - 1
               for sh in ((p, p), (e, p, p, p), (e, p, p, p)))
    want = t_hh.inverse_helmholtz_plain(S, D, u)
    got = t_hh.inverse_helmholtz(S.to(c1), D.to(c1), u.to(c1))
    assert got.device == c1 and torch.cuda.current_device() == c0.index
    torch.testing.assert_close(got.cpu(), want, rtol=5e-4,
                               atol=5e-4 * want.abs().max().item())
    rec = gemm_recipes(t_gemm, p)["interp"]
    env = {"A": S, "u": u}
    plain = t_gemm.gemm_chain_plain(rec, env)
    on1 = t_gemm.gemm_chain(rec, {k: v.to(c1) for k, v in env.items()})
    assert on1["w"].device == c1
    torch.testing.assert_close(on1["w"].cpu(), plain["w"], rtol=5e-4,
                               atol=5e-4 * plain["w"].abs().max().item())

    chain, _, inputs = _card_chain(c0)
    plan = _placed_plan(chain, 64, 3)
    base = mchain.plan_chain(chain, target=H100_SXM, batch_elements=64,
                             n_eq=192, prefetch_depth=0)
    want = t_simulation.run_chain(chain, base, inputs=inputs,
                                  collect_outputs=True, devices=[c0],
                                  pipeline_stages=False).outputs
    got = t_simulation.run_chain(chain, plan, inputs=inputs,
                                 collect_outputs=True, devices=[c0, c1])
    assert got.placement_groups == ((0,), (1, 0), (1,))
    for q in want:
        assert np.array_equal(got.outputs[q], want[q]), q


@pytest.mark.cuda
def test_moe_apply_on_the_card_matches_the_cpu(cuda):
    """olmoe's smoke config in float32, the same params and tokens on the
    card and the CPU, a capacity that drops about half of the
    assignments, 1 and 4 groups and both combine modes: the same kept
    assignments and outputs within rtol 1e-5 / atol 1e-5 max|CPU|."""
    from repro_torch import configs
    from repro_torch.models import moe

    cfg = configs.get_smoke("olmoe-1b-7b")
    gen = torch.Generator().manual_seed(0)
    p_cpu = moe.moe_init(gen, cfg, torch.float32)
    p_dev = {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(cuda))
             for k, v in p_cpu.items()}
    x = torch.randn(4, 64, cfg.d_model, generator=gen)
    capacity, made = 32, 4 * 64 * cfg.moe.top_k
    saved = (moe._NUM_GROUPS, moe._EP_SPEC, moe.COMBINE_MODE)
    tf32, torch.backends.cuda.matmul.allow_tf32 = (
        torch.backends.cuda.matmul.allow_tf32, False)
    try:
        for groups in (1, 4):
            moe.set_ep_sharding(None, (), num_groups=groups)
            xt = x.reshape(groups, -1, cfg.d_model)
            kept = moe._route(p_cpu, xt, cfg, capacity)[4]
            kept_dev = moe._route(p_dev, xt.to(cuda), cfg, capacity)[4]
            assert torch.equal(kept_dev.cpu(), kept)
            assert 0.3 < kept.sum().item() / made < 0.8
            for mode in ("gather", "scatter"):
                moe.COMBINE_MODE = mode
                want = moe.moe_apply(p_cpu, x, cfg, capacity=capacity)
                got = moe.moe_apply(p_dev, x.to(cuda), cfg, capacity=capacity)
                assert got.device == cuda
                torch.testing.assert_close(
                    got.cpu(), want, rtol=1e-5,
                    atol=1e-5 * want.abs().max().item())
    finally:
        moe._NUM_GROUPS, moe._EP_SPEC, moe.COMBINE_MODE = saved
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("fn", ["mlstm", "chunked", "slstm"])
def test_xlstm_blocks_on_the_card_match_the_cpu(cuda, fn, with_state):
    """xlstm-125m's smoke config in float32, the same params and inputs
    on the card and the CPU, T = 128 (two chunks of 64), and a carried
    state made by a first call on the CPU: outputs and new states within
    rtol 1e-5 / atol 1e-5 max|CPU|."""
    import functools

    from repro_torch import configs
    from repro_torch.models import ssm

    cfg = configs.get_smoke("xlstm-125m")
    gen = torch.Generator().manual_seed(0)
    kind = "slstm" if fn == "slstm" else "mlstm"
    init = ssm.slstm_init if kind == "slstm" else ssm.mlstm_init
    apply = {"mlstm": ssm.mlstm_apply, "slstm": ssm.slstm_apply,
             "chunked": functools.partial(ssm.mlstm_apply_chunked,
                                          chunk=64)}[fn]
    p_cpu = init(gen, cfg, torch.float32)
    p_dev = {k: {kk: vv.to(cuda) for kk, vv in v.items()}
             for k, v in p_cpu.items()}
    x = torch.randn(2, 128, cfg.d_model, generator=gen)
    st = None
    if with_state:
        _, st = apply(p_cpu, torch.randn(2, 64, cfg.d_model, generator=gen),
                      cfg, state=ssm.xlstm_init_state(cfg, 2, kind))
    tf32, torch.backends.cuda.matmul.allow_tf32 = (
        torch.backends.cuda.matmul.allow_tf32, False)
    try:
        want, want_st = apply(p_cpu, x, cfg, state=st)
        got, got_st = apply(p_dev, x.to(cuda), cfg, state=None if st is None
                            else {k: v.to(cuda) for k, v in st.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    pairs = [(got, want)] + ([] if st is None else
                             [(got_st[k], want_st[k]) for k in want_st])
    for g, w in pairs:
        assert g.device == cuda
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5,
                                   atol=1e-5 * w.abs().max().item())


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_on_the_card_matches_the_cpu(cuda, with_state):
    """jamba's smoke config in float32, the same params and (2, 128)
    inputs on the card and the CPU, and a carried state made by a first
    (2, 64) call on the CPU: output and new state within rtol 1e-5 /
    atol 1e-5 max|CPU|."""
    from repro_torch import configs
    from repro_torch.models import ssm

    cfg = configs.get_smoke("jamba-1.5-large-398b")
    gen = torch.Generator().manual_seed(0)
    p_cpu = ssm.mamba_init(gen, cfg, torch.float32)
    x = torch.randn(2, 128, cfg.d_model, generator=gen)
    st = None
    if with_state:
        _, st = ssm.mamba_apply(
            p_cpu, torch.randn(2, 64, cfg.d_model, generator=gen), cfg,
            state=ssm.mamba_init_state(cfg, 2))
    tf32, torch.backends.cuda.matmul.allow_tf32 = (
        torch.backends.cuda.matmul.allow_tf32, False)
    try:
        want, want_st = ssm.mamba_apply(p_cpu, x, cfg, state=st)
        got, got_st = ssm.mamba_apply(_to(p_cpu, cuda), x.to(cuda), cfg,
                                      state=None if st is None
                                      else _to(st, cuda))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    pairs = [(got, want)] + ([] if st is None else
                             [(got_st[k], want_st[k]) for k in want_st])
    for g, w in pairs:
        assert g.device == cuda
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5,
                                   atol=1e-5 * w.abs().max().item())


@pytest.mark.cuda
def test_smoke_hybrid_on_the_card_matches_the_cpu(cuda):
    """The smoke hybrid (one period: three Mamba mixers, attention, two
    MoE layers) with the same params on the card and the CPU: the
    forward on (2, 128) tokens -- one flash launch, on the fma route --
    then prefill of 8 tokens and a decode step, logits within rtol 1e-4 /
    atol 1e-4 max|CPU|."""
    from repro_torch import configs
    from repro_torch.models import build_model

    cfg = configs.get_smoke("jamba-1.5-large-398b")
    cpu, card = build_model(cfg, device="cpu"), build_model(cfg)
    assert card.device.type == "cuda"
    params = cpu.init(torch.Generator().manual_seed(0))
    p_dev = _to(params, cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 128),
                           generator=torch.Generator().manual_seed(1))
    tf32, torch.backends.cuda.matmul.allow_tf32 = (
        torch.backends.cuda.matmul.allow_tf32, False)
    before = dict(t_attn.flash_attention.launches_by_route)
    try:
        want = cpu.forward(params, {"tokens": tokens})
        got = card.forward(p_dev, {"tokens": tokens.to(cuda)})
        torch.cuda.synchronize()
        after = dict(t_attn.flash_attention.launches_by_route)
        w_lg, w_cache = cpu.prefill(params, {"tokens": tokens[:, :8]},
                                    cpu.init_cache(2, 9))
        g_lg, g_cache = card.prefill(p_dev, {"tokens": tokens[:, :8]},
                                     card.init_cache(2, 9))
        w_dec, _ = cpu.decode_step(params, tokens[:, 8], w_cache, 8)
        g_dec, _ = card.decode_step(p_dev, tokens[:, 8].to(cuda), g_cache, 8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert after["fma"] == before["fma"] + 1
    assert after["wgmma"] == before["wgmma"]
    for g, w in ((got, want), (g_lg, w_lg), (g_dec, w_dec)):
        assert g.device == cuda
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4,
                                   atol=1e-4 * w.abs().max().item())


@pytest.mark.cuda
def test_smoke_whisper_on_the_card_matches_the_cpu(cuda):
    """The smoke encoder-decoder (2 + 2 layers, head dim 16) with the same
    params on the card and the CPU: the forward on 64 frames and 16
    tokens -- four flash launches, on the fma route: two encoder layers
    at one whole-axis block, two causal decoder layers -- then prefill
    of 8 tokens (two launches, the encoder's) and a decode step (none),
    logits, the encoder output and the caches within rtol 1e-4 / atol
    1e-4 max|CPU|."""
    from repro_torch import configs
    from repro_torch.models import build_model

    cfg = configs.get_smoke("whisper-tiny")
    cpu, card = build_model(cfg, device="cpu"), build_model(cfg)
    assert card.device.type == "cuda"
    params = cpu.init(torch.Generator().manual_seed(0))
    p_dev = _to(params, cuda)
    gen = torch.Generator().manual_seed(1)
    frames = torch.randn(2, 64, cfg.d_model, generator=gen)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    batch = {"frames": frames, "tokens": tokens}
    prompt = {"frames": frames, "tokens": tokens[:, :8]}
    tf32, torch.backends.cuda.matmul.allow_tf32 = (
        torch.backends.cuda.matmul.allow_tf32, False)
    counts = []
    try:
        want = cpu.forward(params, batch)
        counts.append(dict(t_attn.flash_attention.launches_by_route))
        got = card.forward(p_dev, _to(batch, cuda))
        torch.cuda.synchronize()
        counts.append(dict(t_attn.flash_attention.launches_by_route))
        w_lg, w_cache = cpu.prefill(params, prompt, cpu.init_cache(2, 9))
        g_lg, g_cache = card.prefill(p_dev, _to(prompt, cuda),
                                     card.init_cache(2, 9))
        torch.cuda.synchronize()
        counts.append(dict(t_attn.flash_attention.launches_by_route))
        w_dec, w_cache = cpu.decode_step(params, tokens[:, 8], w_cache, 8)
        g_dec, g_cache = card.decode_step(p_dev, tokens[:, 8].to(cuda),
                                          g_cache, 8)
        torch.cuda.synchronize()
        counts.append(dict(t_attn.flash_attention.launches_by_route))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert [c["fma"] - counts[0]["fma"] for c in counts] == [0, 4, 6, 6]
    assert all(c["wgmma"] == counts[0]["wgmma"] for c in counts)
    pairs = [(got, want), (g_lg, w_lg), (g_dec, w_dec),
             (g_cache["enc"], w_cache["enc"])] + [
        (g[k], w[k]) for g, w in zip(g_cache["self"], w_cache["self"])
        for k in ("k", "v")]
    for g, w in pairs:
        assert g.device == cuda
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4,
                                   atol=1e-4 * w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [
    "whisper-tiny", "command-r-plus-104b", "internlm2-1.8b", "qwen3-14b",
    "qwen2-7b", "dbrx-132b", "olmoe-1b-7b", "xlstm-125m",
    "jamba-1.5-large-398b", "chameleon-34b"])
def test_train_step_on_the_card_matches_the_cpu_every_family(cuda, arch):
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.runtime.train import (init_train_state, make_loss_fn,
                                           value_and_grad)
    from repro_torch.tree import named_leaves, tree_map

    cfg = configs.get_smoke(arch)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)) for k in ("tokens", "labels")}
    if cfg.is_encdec:
        batch["frames"] = torch.as_tensor(rng.normal(
            size=(2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    params = init_train_state(build_model(cfg, device="cpu"),
                              torch.Generator().manual_seed(0))["params"]
    out = {}
    for d in ("cpu", cuda):
        loss, grads = value_and_grad(
            make_loss_fn(build_model(cfg, device=d)),
            tree_map(lambda t: t.to(d), params),
            {k: v.to(d) for k, v in batch.items()})
        out[str(d)] = (loss.item(), dict(named_leaves(grads)))
    (l_card, g_card), (l_cpu, g_cpu) = out[str(cuda)], out["cpu"]
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    scale = max(g.abs().max().item() for g in g_cpu.values())
    for n, g in g_card.items():
        assert (g.cpu() - g_cpu[n]).abs().max().item() <= 1e-4 * scale, n


@pytest.mark.cuda
def test_sharded_step_on_a_one_rank_mesh_is_bitwise_on_the_card(cuda,
                                                                 tmp_path):
    import json
    import os
    import subprocess
    import sys

    worker = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
    res = subprocess.run([sys.executable, worker, "cuda1", str(tmp_path)],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads((tmp_path / "cuda1.json").read_text())
    assert "error" not in out, out["error"]
    for route in ("fma", "wgmma"):
        r = out[route]
        assert r["loss_equal"] and r["gnorm_equal"], route
        assert r["unequal_leaves"] == [], (route, r["unequal_leaves"])
        # two steps of two layers, each layer's backward on this route
        assert r["bwd_launches"] == [4, 4], (route, r["bwd_launches"])
