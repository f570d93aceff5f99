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
    p = 5
    S = _t(rng.uniform(-1, 1, (p, p)).astype(np.float32))
    D = _t(rng.uniform(-1, 1, (6, p, p, p)).astype(np.float32))
    u = _t(rng.uniform(-1, 1, (6, p, p, p)).astype(np.float32))
    with pytest.raises(ValueError, match="not divisible"):
        t_hh.inverse_helmholtz_plain(S, D, u, block_elements=4)
    with pytest.raises(ValueError, match="not divisible"):
        t_hh.inverse_helmholtz(S, D, u, block_elements=4)


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
    p = 3
    A = _t(rng.uniform(-1, 1, (p, p)).astype(np.float32))
    u = _t(rng.uniform(-1, 1, (6, p, p, p)).astype(np.float32))
    recipe = gemm_recipes(t_gemm, p)["interp"]
    for fn in (t_gemm.gemm_chain_plain, t_gemm.gemm_chain):
        with pytest.raises(ValueError, match="not divisible"):
            fn(recipe, {"A": A, "u": u}, block_elements=4)


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


def test_gemm_op_table_rejects_what_the_kernel_cannot_run():
    p = 3
    long_chain = t_gemm.GemmRecipe(
        p=p, inputs=(("A", (p, p), False), ("u", (p, p, p), True)),
        ops=tuple(("ewise", "neg", k + 1, -1, None) for k in range(8)),
        outputs=(("y", 9),),
    )
    with pytest.raises(ValueError, match="static limits"):
        t_gemm_mod.op_table(long_chain)
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
