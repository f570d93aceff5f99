"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither ``jax`` nor ``repro``, so it runs on a machine
with a CUDA card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips.  Tolerances: float32 within rtol 5e-4
and atol 5e-4 max|plain| (both sum in float32, the plain version in
another association of the same ascending-l order); bfloat16 within the
bounds ``tests/test_kernels.py`` uses (rtol 0.15, atol 0.3 max|plain|).
"""
import pytest
import torch

from repro_torch.kernels import gemm as t_gemm
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


@pytest.mark.cuda
@pytest.mark.parametrize("p,be", [(5, 2), (11, 4)])
def test_helmholtz_kernel_matches_plain(cuda, p, be):
    gen = torch.Generator(device=cuda).manual_seed(0)
    E = 16
    S, D, u = _uniform(gen, cuda, (p, p), (E, p, p, p), (E, p, p, p))
    before = t_hh.inverse_helmholtz.launches
    got = t_hh.inverse_helmholtz(S, D, u, block_elements=be)
    want = t_hh.inverse_helmholtz_plain(S, D, u, block_elements=be)
    torch.cuda.synchronize()
    assert t_hh.inverse_helmholtz.launches == before + 1
    torch.testing.assert_close(got, want, rtol=5e-4,
                               atol=5e-4 * want.abs().max().item())
    halves = torch.cat([t_hh.inverse_helmholtz(S, D[a:a + E // 2],
                                               u[a:a + E // 2], block_elements=2)
                        for a in (0, E // 2)])
    assert torch.equal(got, halves)
    got_b = t_hh.inverse_helmholtz(S.bfloat16(), D.bfloat16(), u.bfloat16(),
                                   block_elements=be)
    want_b = t_hh.inverse_helmholtz_plain(S.bfloat16(), D.bfloat16(),
                                          u.bfloat16(), block_elements=be)
    torch.testing.assert_close(got_b.float(), want_b.float(), rtol=0.15,
                               atol=0.3 * want_b.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["interp", "perm", "ewise"])
def test_gemm_chain_kernel_matches_plain(cuda, kind):
    p, E = 5, 8
    gen = torch.Generator(device=cuda).manual_seed(0)
    A, u = _uniform(gen, cuda, (p, p), (E, p, p, p))
    env = {"A": A, "u": u}
    recipe = gemm_recipes(t_gemm, p)[kind]
    before = t_gemm.gemm_chain.launches
    got = t_gemm.gemm_chain(recipe, env, block_elements=2)
    want = t_gemm.gemm_chain_plain(recipe, env, block_elements=2)
    torch.cuda.synchronize()
    assert t_gemm.gemm_chain.launches == before + 1
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=5e-4,
                                   atol=5e-4 * want[k].abs().max().item())


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    """Bad inputs raise in the wrapper before any launch."""
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
    big = 16
    Sb, Db, ub = _uniform(gen, cuda, (big, big), (64, big, big, big),
                          (64, big, big, big))
    with pytest.raises(ValueError, match="shared memory"):
        t_hh.inverse_helmholtz(Sb, Db, ub, block_elements=64)
    assert t_hh.inverse_helmholtz.launches == before
    recipe = gemm_recipes(t_gemm, p)["interp"]
    with pytest.raises(TypeError, match="one dtype"):
        t_gemm.gemm_chain(recipe, {"A": S.bfloat16(), "u": u},
                          block_elements=2)
