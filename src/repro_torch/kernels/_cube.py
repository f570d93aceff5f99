"""The CFD kernels' CTA tile, mirrored from ``csrc/common.cuh``.

Both CFD kernels (``csrc/helmholtz.cu``, ``csrc/gemm_chain.cu``) stage
element inputs, keep f32 work cubes and hold their matrices as padded
columns in shared memory.  A tile is ``te``, the elements a CTA takes a
step -- the plan's block size -- and its thread count and shared bytes
follow from ``te`` by one rule (``cube_tile``).  Without a block the
kernels take ``cube_tile``'s default ``te``; a ``te`` is legal up to
``cube_max_tile``.  This module repeats those rules in Python, so that a
wrapper can refuse what would not launch before a launch and the tests
here can pin the model without a card.
"""
from __future__ import annotations

from typing import Optional, Tuple

#: largest p the kernels are built for (common.cuh REPRO_FOR_EACH_P)
MAX_P = 16
#: shared memory one block may use on an H100 (227 KB)
MAX_SHARED_BYTES = 232_448
#: common.cuh's CFD tile constants
CUBE_MAX_THREADS, CUBE_MIN_THREADS, CUBE_FIBERS = 192, 128, 2
CUBE_CTA_TARGET = 75 * 1024


def _round16(n: int) -> int:
    return (n + 15) & ~15


def cube_smem(p: int, te: int, n_stage: int, elem_bytes: int, n_work: int,
              n_mat_rows: int) -> int:
    """Shared bytes of a CFD CTA (common.cuh ``cube_smem``):
    ``n_mat_rows`` padded p x p matrix blocks, ``n_stage`` staging buffers
    of a tile of one element input (16 bytes of slack each, for the
    copy's alignment), and f32 work cubes with an odd row pitch."""
    return (_round16(n_mat_rows * p * ((p + 3) & ~3) * 4)
            + n_stage * (_round16(te * p ** 3 * elem_bytes) + 16)
            + n_work * _round16(te * p * p * (p | 1) * 4))


def cube_threads(p: int, te: int) -> int:
    """Threads of a CTA at ``te`` elements a step (common.cuh
    ``cube_threads``): two fibers a thread, whole warps, at least 128."""
    threads = -(-te * p * p // CUBE_FIBERS)
    return max(CUBE_MIN_THREADS, -(-threads // 32) * 32)


def cube_tile(p: int, n_stage: int, elem_bytes: int, n_work: int,
              n_mat_rows: int, te: Optional[int] = None
              ) -> Tuple[int, int, int]:
    """A CFD kernel's CTA tile, ``(te, threads, shared bytes)``
    (common.cuh ``cube_tile``).  Without ``te``, the default: te elements
    fill the CTA's fiber slots and, where they can, keep three CTAs on
    an SM.  With ``te``, the tile at that block; whether it launches is
    :func:`cube_max_tile`'s to say."""
    if te is None:
        te = max(1, CUBE_FIBERS * CUBE_MAX_THREADS // (p * p))
        while te > 1 and cube_smem(p, te, n_stage, elem_bytes, n_work,
                                   n_mat_rows) > CUBE_CTA_TARGET:
            te -= 1
    return te, cube_threads(p, te), cube_smem(p, te, n_stage, elem_bytes,
                                              n_work, n_mat_rows)


def cube_max_tile(p: int, n_stage: int, elem_bytes: int, n_work: int,
                  n_mat_rows: int) -> int:
    """The largest ``te`` a CFD kernel launches with (common.cuh
    ``cube_max_tile``): at most ``CUBE_MAX_THREADS`` threads (the
    kernels' ``__launch_bounds__``) and one block's shared memory.  0
    where not even one element fits."""
    te = CUBE_FIBERS * CUBE_MAX_THREADS // (p * p)
    while te > 0 and cube_smem(p, te, n_stage, elem_bytes, n_work,
                               n_mat_rows) > MAX_SHARED_BYTES:
        te -= 1
    return te


def check_te(kernel: str, p: int, te: int, max_te: int) -> None:
    """Refuse a block the kernel cannot launch with, before a launch."""
    if not 1 <= te <= max_te:
        raise ValueError(
            f"the {kernel} kernel at p={p} launches with 1..{max_te} "
            f"elements a CTA step (at most {CUBE_MAX_THREADS} threads and "
            f"{MAX_SHARED_BYTES} B of shared memory), got block {te}"
        )


def helmholtz_tile(p: int, elem_bytes: int, te: Optional[int] = None
                   ) -> Tuple[int, int, int]:
    """The Helmholtz kernel's tile at p (helmholtz.cu ``helmholtz_tile``):
    u and D staged, one work cube, S and S^T as padded columns.  Its
    default fits one block's shared memory at every p <= MAX_P."""
    return cube_tile(p, 2, elem_bytes, 1, 2, te)


def helmholtz_max_tile(p: int, elem_bytes: int) -> int:
    """The largest ``te`` the Helmholtz kernel launches with at p."""
    return cube_max_tile(p, 2, elem_bytes, 1, 2)


def chain_tile(p: int, n_elem: int, n_mats: int, n_bufs: int,
               elem_bytes: int, te: Optional[int] = None
               ) -> Tuple[int, int, int]:
    """The GEMM-chain kernel's tile (gemm_chain.cu ``chain_tile``): two
    staging buffers per element input, ``n_bufs`` work cubes, each matrix
    as columns of M and of its transpose."""
    return cube_tile(p, 2 * n_elem, elem_bytes, n_bufs, 2 * n_mats, te)


def chain_max_tile(p: int, n_elem: int, n_mats: int, n_bufs: int,
                   elem_bytes: int) -> int:
    """The largest ``te`` the GEMM-chain kernel launches with."""
    return cube_max_tile(p, 2 * n_elem, elem_bytes, n_bufs, 2 * n_mats)
