"""The port's kernels held against the reference's Pallas kernels.

On the CPU each kernel wrapper runs its plain PyTorch version, which
repeats the CUDA kernel's arithmetic (ascending-l float32 sums); it is
compared with the reference kernel in Pallas interpret mode and the
float64 numpy oracles.  The kernel-against-plain cases, which need a
CUDA card, are in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.cfd import reference
from repro.kernels import gemm as r_gemm
from repro.kernels.helmholtz import ops as r_hh_ops
from repro_torch.kernels import _cube
from repro_torch.kernels import gemm as t_gemm
from repro_torch.kernels.gemm import gemm as t_gemm_mod
from repro_torch.kernels.helmholtz import helmholtz as t_hh
from repro_torch.kernels.helmholtz import ops as t_hh_ops
from test_torch_cuda import gemm_recipes


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# helmholtz
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [3, 5, 7, 11])
@pytest.mark.parametrize("be", [2, 4])
def test_helmholtz_plain_matches_reference_kernel(p, be, rng):
    E = 8
    S = rng.uniform(-1, 1, (p, p)).astype(np.float32)
    D = rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32)
    u = rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32)
    want = np.asarray(r_hh_ops.inverse_helmholtz(
        S, D, u, impl="interpret", block_elements=be))
    got = t_hh.inverse_helmholtz_plain(_t(S), _t(D), _t(u), block_elements=be)
    assert got.dtype == torch.float32
    # both float32 with float32 sums in different orders
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4,
                               atol=5e-4 * np.abs(want).max())
    oracle = reference.inverse_helmholtz_batch(
        S.astype(np.float64), D.astype(np.float64), u.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=5e-4, atol=5e-4)


def test_helmholtz_plain_bf16(rng):
    import jax.numpy as jnp

    p, E = 7, 4
    S = rng.uniform(-1, 1, (p, p)).astype(np.float32)
    D = rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32)
    u = rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32)
    want = np.asarray(r_hh_ops.inverse_helmholtz(
        jnp.asarray(S, jnp.bfloat16), jnp.asarray(D, jnp.bfloat16),
        jnp.asarray(u, jnp.bfloat16), impl="interpret", block_elements=4,
    ).astype(jnp.float32))
    got = t_hh.inverse_helmholtz_plain(
        _t(S).bfloat16(), _t(D).bfloat16(), _t(u).bfloat16(), block_elements=4)
    assert got.dtype == torch.bfloat16
    oracle = reference.inverse_helmholtz_batch(
        S.astype(np.float64), D.astype(np.float64), u.astype(np.float64))
    # bf16 storage, f32 accumulation: the bounds tests/test_kernels.py uses
    for arr in (got.float().numpy(), want):
        np.testing.assert_allclose(arr, oracle, rtol=0.15, atol=0.3)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0.15,
                               atol=0.3 * np.abs(want).max())


def test_helmholtz_rejects_ragged_blocks(rng):
    """A block that does not divide E is no longer refused: the kernel
    walks a ragged last tile, and E = 6 at block 4 gives the bits of the
    whole batch at every block."""
    p = 5
    S = _t(rng.uniform(-1, 1, (p, p)).astype(np.float32))
    D = _t(rng.uniform(-1, 1, (6, p, p, p)).astype(np.float32))
    u = _t(rng.uniform(-1, 1, (6, p, p, p)).astype(np.float32))
    whole = t_hh.inverse_helmholtz_plain(S, D, u)
    for fn in (t_hh.inverse_helmholtz_plain, t_hh.inverse_helmholtz):
        for be in (4, 5, 6, 15):
            assert torch.equal(fn(S, D, u, block_elements=be), whole)


def test_helmholtz_wrapper_on_cpu_runs_plain_without_launch(rng):
    p, E = 5, 4
    S = _t(rng.uniform(-1, 1, (p, p)).astype(np.float32))
    D = _t(rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32))
    u = _t(rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32))
    before = t_hh.inverse_helmholtz.launches
    got = t_hh.inverse_helmholtz(S, D, u, block_elements=2)
    assert t_hh.inverse_helmholtz.launches == before
    assert torch.equal(got, t_hh.inverse_helmholtz_plain(S, D, u, block_elements=2))
    impl = t_hh_ops.make_pallas_impl(block_elements=2)
    assert torch.equal(impl({"S": S, "D": D, "u": u})["v"], got)


def test_helmholtz_plain_is_batch_invariant(rng):
    """An element's result never depends on E or the block: one call on
    8 elements equals two calls on 4, bit for bit."""
    p, E = 5, 8
    S = _t(rng.uniform(-1, 1, (p, p)).astype(np.float32))
    D = _t(rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32))
    u = _t(rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32))
    whole = t_hh.inverse_helmholtz_plain(S, D, u, block_elements=4)
    halves = [t_hh.inverse_helmholtz_plain(S, D[a:a + 4], u[a:a + 4],
                                           block_elements=2) for a in (0, 4)]
    assert torch.equal(whole, torch.cat(halves))


def test_helmholtz_block_sizing_matches_reference():
    for p in (5, 7, 11):
        for be in (1, 4):
            assert (t_hh_ops.block_working_set_bytes(p, be)
                    == r_hh_ops.block_working_set_bytes(p, be))
        for vmem in (232_448, 16 * 2 ** 20):
            assert (t_hh_ops.block_elements_for_vmem(p, vmem)
                    == r_hh_ops.block_elements_for_vmem(p, vmem))
    # the H100's per-block shared memory holds a 4-element block at p = 11
    assert t_hh_ops.block_elements_for_vmem(11, 232_448) == 4


# ---------------------------------------------------------------------------
# gemm chain
# ---------------------------------------------------------------------------

CASES = [("interp", 3, 2), ("interp", 5, 4), ("interp", 11, 2),
         ("perm", 5, 2), ("ewise", 4, 4)]


@pytest.mark.parametrize("kind,p,be", CASES)
def test_gemm_chain_plain_matches_reference_kernel(kind, p, be, rng):
    E = 8
    A = rng.uniform(-1, 1, (p, p)).astype(np.float32)
    u = rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32)
    r_recipe = gemm_recipes(r_gemm, p)[kind]
    t_recipe = gemm_recipes(t_gemm, p)[kind]
    want = r_gemm.gemm_chain(r_recipe, {"A": A, "u": u}, impl="interpret",
                             block_elements=be)
    got = t_gemm.gemm_chain_plain(t_recipe, {"A": _t(A), "u": _t(u)},
                                  block_elements=be)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].is_contiguous() and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), w, rtol=5e-4,
                                   atol=5e-4 * np.abs(w).max())
    assert t_recipe.flops_per_element() == r_recipe.flops_per_element()


def test_gemm_chain_plain_is_block_and_batch_invariant(rng):
    p, E = 5, 8
    A = _t(rng.uniform(-1, 1, (p, p)).astype(np.float32))
    u = _t(rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32))
    recipe = gemm_recipes(t_gemm, p)["interp"]
    outs = [t_gemm.gemm_chain_plain(recipe, {"A": A, "u": u},
                                    block_elements=be)["w"]
            for be in (1, 2, 8)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    halves = [t_gemm.gemm_chain_plain(recipe, {"A": A, "u": u[a:a + 4]},
                                      block_elements=4)["w"] for a in (0, 4)]
    assert torch.equal(torch.cat(halves), outs[0])


def test_gemm_chain_rejects_ragged_blocks(rng):
    """A block that does not divide E is no longer refused: the kernel
    walks a ragged last tile, and E = 6 at block 4 gives the bits of the
    whole batch at every block."""
    p = 3
    A = _t(rng.uniform(-1, 1, (p, p)).astype(np.float32))
    u = _t(rng.uniform(-1, 1, (6, p, p, p)).astype(np.float32))
    recipe = gemm_recipes(t_gemm, p)["interp"]
    whole = t_gemm.gemm_chain_plain(recipe, {"A": A, "u": u})["w"]
    for fn in (t_gemm.gemm_chain_plain, t_gemm.gemm_chain):
        for be in (4, 5, 6, 42):
            got = fn(recipe, {"A": A, "u": u}, block_elements=be)["w"]
            assert torch.equal(got, whole)


def test_gemm_chain_wrapper_on_cpu_runs_plain_without_launch(rng):
    p, E = 4, 4
    A = _t(rng.uniform(-1, 1, (p, p)).astype(np.float32))
    u = _t(rng.uniform(-1, 1, (E, p, p, p)).astype(np.float32))
    recipe = gemm_recipes(t_gemm, p)["ewise"]
    before = t_gemm.gemm_chain.launches
    got = t_gemm.make_pallas_impl(recipe, block_elements=2)({"A": A, "u": u})
    assert t_gemm.gemm_chain.launches == before
    want = t_gemm.gemm_chain_plain(recipe, {"A": A, "u": u})
    for k in want:
        assert torch.equal(got[k], want[k])


def test_gemm_op_table_lowering():
    p = 11
    in_index, n_slots, n_mats, ops, consts, out_slot = t_gemm_mod.op_table(
        gemm_recipes(t_gemm, p)["ewise"])
    assert (in_index, n_slots, n_mats) == ([0, 0], 4, 1)
    assert ops[0][:9] == [0, 1, 0, 0, 0, 0, 0, 1, 2]      # contract u -> 1
    assert ops[1][:4] == [1 + t_gemm.EWISE_OPS.index("mul"), 2, 1, 0]
    assert ops[2][:4] == [1 + t_gemm.EWISE_OPS.index("scale"), 3, 2, -1]
    assert consts == [0.0, 0.0, 0.5] and out_slot == [1, 3]
    assert all(len(row) == t_gemm_mod.OP_WIDTH for row in ops)
    # 4 element slots for interpolation: 21 KB per element at p = 11
    _, n_slots, n_mats, _, _, _ = t_gemm_mod.op_table(
        gemm_recipes(t_gemm, p)["interp"])
    assert (n_slots, n_mats) == (4, 1)
    assert 4 * n_slots * p ** 3 == 21_296


def _live_readers(ops):
    """For each op-table slot, the index of its last reader."""
    last = {}
    for k, row in enumerate(ops):
        for s in ([row[2]] if row[0] == 0 else [row[2], row[3]]):
            if s >= 0:
                last[s] = k
    return last


def _chain_recipes(p):
    """The test recipes and the CFD pipeline's interp and grad stages."""
    from repro_torch.cfd import operators
    from repro_torch.flow import patterns

    system = operators.compile_cfd_pipeline(p, backends="pallas",
                                            device="cpu")
    out = dict(gemm_recipes(t_gemm, p))
    for stage in system.chain.stages:
        recipe = patterns.match_gemm_chain(stage.program)
        if stage.name in ("interp", "grad"):
            out[f"pipeline {stage.name}"] = recipe
    return out


@pytest.mark.parametrize("p", [5, 11])
def test_gemm_buffer_table_reuses_only_dead_cubes(p):
    """Interpolation holds 1 work cube (its contractions run in place),
    the gradient none (w is read where it is staged and gx, gy, gz go out
    from registers); no op writes a cube that holds a slot still to be
    read after it, nor, unless it writes in place (ewise, or a
    contraction without a perm), one it reads; a result that only feeds
    outputs gets no cube (a direct store)."""
    recipes = _chain_recipes(p)
    counts = {k: t_gemm_mod.buffer_table(r)[1] for k, r in recipes.items()}
    assert counts["interp"] == counts["pipeline interp"] == 1
    assert counts["pipeline grad"] == 0 and counts["perm"] == 0
    for name, recipe in recipes.items():
        _, n_slots, _, ops, _, out_slot = t_gemm_mod.op_table(recipe)
        slot_buf, n_bufs = t_gemm_mod.buffer_table(recipe)
        n_elem = sum(1 for _, _, is_elem in recipe.inputs if is_elem)
        last = _live_readers(ops)
        assert len(slot_buf) == n_slots
        assert slot_buf[:n_elem] == [-1] * n_elem          # staged inputs
        for k, row in enumerate(ops):
            dst = row[1]
            if last.get(dst, -1) <= k:                      # output only
                assert slot_buf[dst] == -1, name
                assert dst in out_slot or last.get(dst, -1) < 0
                continue
            assert 0 <= slot_buf[dst] < n_bufs
            in_place = row[0] != 0 or list(row[6:9]) == [0, 1, 2]
            for s in range(n_elem, dst):                    # earlier results
                if s == dst or slot_buf[s] != slot_buf[dst]:
                    continue
                still_read = last.get(s, -1)
                assert still_read < k or (still_read == k and in_place), (
                    name, k, s)


def test_gemm_buffer_table_frees_a_cube_after_its_last_reader():
    """A cube is free once its slot's last reader has run, and for that
    reader too where it writes in place."""
    p = 3
    chain = t_gemm.GemmRecipe(
        p=p, inputs=(("A", (p, p), False), ("u", (p, p, p), True)),
        ops=(("contract", 1, 0, 0, 0, (0, 1, 2)),     # table slot 1
             ("contract", 2, 0, 1, 0, (0, 1, 2)),     # 2 <- 1
             ("ewise", "add", 3, 2, None),            # 3 <- 2, 1
             ("ewise", "neg", 4, -1, None),           # 4 <- 3
             ("ewise", "mul", 5, 3, None)),           # 5 <- 4, 2
        outputs=(("y", 6),),
    )
    slot_buf, n_bufs = t_gemm_mod.buffer_table(chain)
    # slots 1-4 of the op table are read later, 5 is only the output; the
    # second contraction cannot write in place (the add reads slot 1
    # too), the add takes slot 1's cube in place (its last reader), the
    # neg slot 3's
    assert slot_buf == [-1, 0, 1, 0, 0, -1] and n_bufs == 2


def test_kernel_tiles_mirror_the_shared_memory_model():
    """The Helmholtz kernel's default tile fits one CTA at every p it
    takes (3 elements, 192 threads, 49,040 B at p = 11, f32: four CTAs
    an SM), so its wrapper has nothing to refuse without a block."""
    for elem_bytes in (4, 2):
        for p in range(1, _cube.MAX_P + 1):
            te, threads, smem = _cube.helmholtz_tile(p, elem_bytes)
            assert te >= 1 and 128 <= threads <= 192 and threads % 32 == 0
            assert smem <= _cube.MAX_SHARED_BYTES
            assert smem == _cube.cube_smem(p, te, 2, elem_bytes, 1, 2)
            assert te == 1 or smem <= _cube.CUBE_CTA_TARGET
            assert te * p * p <= 2 * threads
    assert _cube.helmholtz_tile(11, 4) == (3, 192, 49_040)
    interp = gemm_recipes(t_gemm, 11)["interp"]
    assert t_gemm_mod.kernel_tile(interp, 4) == (
        3, 192, _cube.cube_smem(11, 3, 2, 4, 1, 2))


def _largest_recipe(p, n_elem, n_mats, n_bufs):
    """A recipe with n_elem element inputs, n_mats matrices and ewise ops
    that hold n_bufs (0, 1 or 2) work cubes at once; with n_bufs None, no
    op at all, every element input fed straight out."""
    inputs = tuple((f"M{j}", (p, p), False) for j in range(n_mats)) + tuple(
        (f"x{j}", (p, p, p), True) for j in range(n_elem))
    x0, first = n_mats, len(inputs)
    if n_bufs is None:
        return t_gemm.GemmRecipe(
            p=p, inputs=inputs, ops=(),
            outputs=tuple((f"y{j}", x0 + j) for j in range(n_elem)))
    ops = [("ewise", "neg", x0, -1, None) for _ in range(n_bufs)]
    if n_bufs < 2:          # out = x0 + (-x0), or -x0 alone
        ops.append(("ewise", "add", x0, first, None) if n_bufs
                   else ("ewise", "neg", x0, -1, None))
    else:                   # out = (-x0) + (-x0): both held at once
        ops.append(("ewise", "add", first, first + 1, None))
    return t_gemm.GemmRecipe(p=p, inputs=inputs, ops=tuple(ops),
                             outputs=(("y", first + len(ops) - 1),))


@pytest.mark.parametrize("n_elem,n_mats,n_bufs",
                         [(7, 1, 0), (6, 2, 1), (5, 1, 1), (4, 4, 2),
                          (8, 0, None)])
def test_gemm_kernel_tile_refuses_at_the_shared_memory_limit(
        n_elem, n_mats, n_bufs):
    """The kernel's shared bytes are the model's (cube_smem) and the
    wrapper refuses exactly above the 232,448-B limit.  At p = 16, one
    element a tile: seven float32 inputs (two staging buffers of 16,400 B
    each) and a matrix (2,048 B) fit, at 231,648 B; eight float32 inputs
    fed straight out take 262,400 B and are refused, and fit in
    bfloat16."""
    p = 16
    recipe = _largest_recipe(p, n_elem, n_mats, n_bufs)
    t_gemm_mod.op_table(recipe)                      # within the limits
    assert t_gemm_mod.buffer_table(recipe)[1] == (n_bufs or 0)
    smem = _cube.cube_smem(p, 1, 2 * n_elem, 4, n_bufs or 0, 2 * n_mats)
    assert (smem > _cube.MAX_SHARED_BYTES) == (n_elem == 8)
    if smem <= _cube.MAX_SHARED_BYTES:
        assert smem <= 231_648
        assert t_gemm_mod.kernel_tile(recipe, 4) == (1, 128, smem)
    else:
        assert smem == 262_400
        with pytest.raises(ValueError, match=f"needs {smem} B of shared memory"):
            t_gemm_mod.kernel_tile(recipe, 4)
    half = _cube.cube_smem(p, 1, 2 * n_elem, 2, n_bufs or 0, 2 * n_mats)
    assert t_gemm_mod.kernel_tile(recipe, 2) == (1, 128, half)
    assert half <= _cube.MAX_SHARED_BYTES


def test_gemm_op_table_rejects_what_the_kernel_cannot_run():
    """Every element input and op result has an element slot, and the
    slot limit is MAX_IN + MAX_OPS, so a recipe is refused only for its
    inputs, outputs, ops or matrices: 32 ops (33 slots) lower, 33 do
    not."""
    p = 3

    def chain(n_ops):
        return t_gemm.GemmRecipe(
            p=p, inputs=(("A", (p, p), False), ("u", (p, p, p), True)),
            ops=tuple(("ewise", "neg", k + 1, -1, None)
                      for k in range(n_ops)),
            outputs=(("y", n_ops + 1),),
        )

    assert t_gemm_mod.MAX_SLOTS == t_gemm_mod.MAX_IN + t_gemm_mod.MAX_OPS
    assert t_gemm_mod.op_table(chain(32))[1] == 33
    with pytest.raises(ValueError, match="static limits"):
        t_gemm_mod.op_table(chain(33))
    rank2 = t_gemm.GemmRecipe(
        p=p, inputs=(("A", (p, p), False), ("u", (p, p), True)),
        ops=(("ewise", "neg", 1, -1, None),), outputs=(("y", 2),),
    )
    with pytest.raises(ValueError, match="rank-3"):
        t_gemm_mod.op_table(rank2)


def test_gemm_block_sizing_matches_reference():
    for p in (5, 7, 11):
        t_r = gemm_recipes(t_gemm, p)["interp"]
        r_r = gemm_recipes(r_gemm, p)["interp"]
        for vmem in (232_448, 2 ** 20, 2 ** 24):
            assert (t_gemm.block_elements_for_vmem(t_r, vmem)
                    == r_gemm.block_elements_for_vmem(r_r, vmem))
        assert (t_gemm.block_working_set_bytes(t_r, 4)
                == r_gemm.block_working_set_bytes(r_r, 4))
