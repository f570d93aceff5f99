"""Public wrappers for the GEMM-chain kernel.

``make_pallas_impl(recipe)`` returns the batched callable
``repro_torch.core.emit.compile_program(backend='pallas')`` expects: the
CUDA kernel on CUDA tensors, its plain PyTorch version on CPU tensors --
the same dispatch contract as the Helmholtz kernel's ``ops``.  Block
sizing mirrors the reference's working-set model, fed the card's
per-block shared memory in place of a TPU core's VMEM.
"""
from __future__ import annotations

import math
from typing import Optional

from .gemm import GemmRecipe, gemm_chain


def block_working_set_bytes(
    recipe: GemmRecipe, block_elements: int, *, bytes_per_scalar: int = 4
) -> int:
    """On-chip bytes while one element block flows through the kernel: the
    element in/out block slices, double-buffered scratch for the largest
    intermediate, plus the shared matrices held resident.  Mirrors
    ``memory.layout.block_working_set_bytes`` on the recipe's program."""
    shared = sum(
        math.prod(shape) for _, shape, is_elem in recipe.inputs
        if not is_elem
    )
    out_slots = {slot for _, slot in recipe.outputs}
    elem = sum(
        math.prod(shape) for _, shape, is_elem in recipe.inputs if is_elem
    ) + sum(math.prod(recipe.slot_shape(s)) for s in out_slots)
    scratch = 2 * max(
        (math.prod(recipe.slot_shape(recipe.n_inputs + k))
         for k in range(len(recipe.ops))),
        default=0,
    )
    return (shared + block_elements * (elem + scratch)) * bytes_per_scalar


def block_elements_for_vmem(
    recipe: GemmRecipe,
    vmem_bytes: int,
    *,
    bytes_per_scalar: int = 4,
    reserve_fraction: float = 0.5,
) -> int:
    """Largest power-of-two element block whose working set fits the
    given on-chip memory (half reserved for double buffering)."""
    budget = int(vmem_bytes * reserve_fraction)
    be = 1
    while block_working_set_bytes(
        recipe, be * 2, bytes_per_scalar=bytes_per_scalar
    ) <= budget:
        be *= 2
    return be


def make_pallas_impl(
    recipe: GemmRecipe,
    block_elements: Optional[int] = None,
):
    """Adapter for ``core.emit.compile_program(backend='pallas')``; the
    kernel launches at ``block_elements`` (None: its default tile) and
    writes into ``out`` where given (``gemm_chain``)."""

    def batched_fn(env, out=None):
        return gemm_chain(recipe, env, block_elements=block_elements, out=out)

    return batched_fn
