"""Public wrappers for the fused Inverse-Helmholtz kernel.

``make_pallas_impl`` returns the batched callable
``repro_torch.core.emit.compile_program(backend='pallas')`` expects for
the Inverse-Helmholtz program: the CUDA kernel on CUDA tensors, its plain
PyTorch version on CPU tensors.  Block sizing mirrors the reference: the
working-set model is unchanged and is fed the card's per-block shared
memory in place of a TPU core's VMEM.
"""
from __future__ import annotations

from typing import Optional

from .helmholtz import inverse_helmholtz


def block_working_set_bytes(
    p: int, block_elements: int, *, bytes_per_scalar: int = 4
) -> int:
    """On-chip bytes while one element block flows through the fused
    kernel: the u/D/v block slices plus the double-buffered t/r scratch
    pair, plus the resident S operator.  Matches
    ``memory.layout.block_working_set_bytes`` on the Inverse-Helmholtz
    program."""
    return (p * p + 5 * block_elements * p ** 3) * bytes_per_scalar


def block_elements_for_vmem(
    p: int,
    vmem_bytes: int,
    *,
    bytes_per_scalar: int = 4,
    reserve_fraction: float = 0.5,
) -> int:
    """Largest power-of-two element block whose working set fits the
    given on-chip memory (half reserved for double buffering).  On the
    H100 target ``vmem_bytes`` is one block's shared memory."""
    budget = int(vmem_bytes * reserve_fraction)
    be = 1
    while block_working_set_bytes(
        p, be * 2, bytes_per_scalar=bytes_per_scalar
    ) <= budget:
        be *= 2
    return be


def make_pallas_impl(block_elements: Optional[int] = None):
    """Adapter for ``core.emit.compile_program(backend='pallas')``; the
    kernel launches at ``block_elements`` (None: its default tile) and
    writes ``v`` into ``out["v"]`` where given."""

    def batched_fn(env, out=None):
        v = inverse_helmholtz(
            env["S"], env["D"], env["u"], block_elements=block_elements,
            out=None if out is None else out["v"],
        )
        return {"v": v}

    return batched_fn
