"""CHARM-style two-class tile candidates for the CFD kernels.

CHARM composes heterogeneous accelerators from two design classes: CDSE
enumerates *large* tile configurations that maximize steady-state
throughput for big operands, CDAC keeps *small* dedicated accelerators
whose latency (fill cost) stays low for small operands.

:func:`tile_candidates` is the reference's search space for the
GEMM-chain kernel's ``block_elements`` on a VMEM target (power-of-two
blocks filtered by the VMEM budget, dividing the batch), kept equal to
it so that plans on the reference's targets compare.  On the H100 a
block is the CUDA kernels' tile ``te``, the elements a CTA takes a step,
and :func:`card_tile_candidates` enumerates what the card can run:
``te = 1 .. max_tile``, each with the threads and shared memory that
follow from it (``kernels._cube``), classed by its CTA's share of one
block's shared memory.  The measured block autotuner
(``flow.compile(tune_blocks=True)``) times these candidates.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

from .._cube import MAX_SHARED_BYTES
from .gemm import GemmRecipe
from .ops import block_working_set_bytes

#: Working-set fraction of the VMEM budget separating the two classes:
#: blocks using more than this are "cdse" (large/throughput), the rest
#: "cdac" (small/latency).
LARGE_CLASS_FRACTION = 0.25

#: Default per-dispatch overhead used by the throughput ranking (one
#: kernel launch per block; same order as ``dse.DISPATCH_OVERHEAD_S``).
DEFAULT_OVERHEAD_S = 50e-6


@dataclasses.dataclass(frozen=True)
class TileCandidate:
    """One feasible ``block_elements`` choice for a CFD kernel."""

    klass: str                  # "cdse" (large) | "cdac" (small)
    block_elements: int
    working_set_bytes: int
    #: modeled elements/second: block roofline plus dispatch overhead
    predicted_throughput: float


def tile_candidates(
    recipe: GemmRecipe,
    *,
    vmem_bytes: int,
    peak_flops: float,
    hbm_bandwidth: float,
    bytes_per_scalar: int = 4,
    overhead_s: float = DEFAULT_OVERHEAD_S,
    reserve_fraction: float = 0.5,
    max_block: int = 2048,
    batch_elements: Optional[int] = None,
) -> List[TileCandidate]:
    """Enumerate, filter, and throughput-rank block-size candidates.

    Power-of-two blocks up to ``max_block`` are kept when their VMEM
    working set fits ``vmem_bytes * reserve_fraction`` (the other half
    is the grid pipeline's DMA double buffer) and, when
    ``batch_elements`` is given, when they divide the batch (the Pallas
    grid requires it).  Each survivor is classed large ("cdse") or small
    ("cdac") by working-set fraction and ranked by modeled throughput:
    ``be / (overhead + flops/peak + io_bytes/bw)``.  Returns candidates
    sorted best-first; empty when even a 1-element block exceeds VMEM.
    """
    budget = int(vmem_bytes * reserve_fraction)
    flops = recipe.flops_per_element()
    out_slots = {slot for _, slot in recipe.outputs}
    io_scalars = sum(
        math.prod(shape) for _, shape, is_elem in recipe.inputs if is_elem
    ) + sum(math.prod(recipe.slot_shape(s)) for s in out_slots)

    out: List[TileCandidate] = []
    be = 1
    while be <= max_block:
        ws = block_working_set_bytes(
            recipe, be, bytes_per_scalar=bytes_per_scalar
        )
        divides = batch_elements is None or batch_elements % be == 0
        fits = ws <= budget and (
            batch_elements is None or be <= batch_elements
        )
        if fits and divides:
            t = (
                overhead_s
                + be * flops / peak_flops
                + be * io_scalars * bytes_per_scalar / hbm_bandwidth
            )
            out.append(TileCandidate(
                klass=(
                    "cdse" if ws > budget * LARGE_CLASS_FRACTION
                    else "cdac"
                ),
                block_elements=be,
                working_set_bytes=ws,
                predicted_throughput=be / t,
            ))
        be *= 2
    out.sort(key=lambda c: -c.predicted_throughput)
    return out


def card_tile_candidates(
    tile_at: Callable[[int], Tuple[int, int, int]],
    max_te: int,
    *,
    batch_elements: Optional[int] = None,
) -> List[Tuple[int, str, int]]:
    """The CUDA kernels' own block candidates: every ``te`` from 1 to
    ``max_te`` (the largest the kernel launches with), at most the batch,
    as ``(te, class, shared bytes)`` in ``te`` order.

    ``tile_at(te)`` gives the tile's ``(te, threads, shared bytes)``.  A
    candidate is "cdse" when its CTA takes more than
    ``LARGE_CLASS_FRACTION`` of one block's shared memory, else "cdac".
    No model ranks them: the tuner times every one.
    """
    top = max_te if batch_elements is None else min(max_te, batch_elements)
    out = []
    for te in range(1, top + 1):
        smem = tile_at(te)[2]
        klass = ("cdse" if smem > MAX_SHARED_BYTES * LARGE_CLASS_FRACTION
                 else "cdac")
        out.append((te, klass, smem))
    return out
