"""The CFD kernels' CTA tile, mirrored from ``csrc/common.cuh``.

Both CFD kernels (``csrc/helmholtz.cu``, ``csrc/gemm_chain.cu``) stage
element inputs, keep f32 work cubes and hold their matrices as padded
columns in shared memory, and choose their tile (elements a step,
threads, shared bytes) by one rule, ``cube_tile``.  This module repeats
that rule in Python, so that a wrapper can refuse what would not fit
before a launch and the tests here can pin the model without a card.
"""
from __future__ import annotations

from typing import Tuple

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


def cube_tile(p: int, n_stage: int, elem_bytes: int, n_work: int,
              n_mat_rows: int) -> Tuple[int, int, int]:
    """The CFD kernels' CTA tile, ``(te, threads, shared bytes)``
    (common.cuh ``cube_tile``): te elements fill the CTA's fiber slots
    and, where they can, keep three CTAs on an SM; it does not depend on
    the plan's block size."""
    te = max(1, CUBE_FIBERS * CUBE_MAX_THREADS // (p * p))
    while te > 1 and cube_smem(p, te, n_stage, elem_bytes, n_work,
                               n_mat_rows) > CUBE_CTA_TARGET:
        te -= 1
    threads = -(-te * p * p // CUBE_FIBERS)
    threads = max(CUBE_MIN_THREADS, -(-threads // 32) * 32)
    return te, threads, cube_smem(p, te, n_stage, elem_bytes, n_work,
                                  n_mat_rows)


def helmholtz_tile(p: int, elem_bytes: int) -> Tuple[int, int, int]:
    """The Helmholtz kernel's tile at p (helmholtz.cu ``helmholtz_tile``):
    u and D staged, one work cube, S and S^T as padded columns.  It fits
    one block's shared memory at every p <= MAX_P, so its wrapper has
    nothing to refuse."""
    return cube_tile(p, 2, elem_bytes, 1, 2)


def chain_tile(p: int, n_elem: int, n_mats: int, n_bufs: int,
               elem_bytes: int) -> Tuple[int, int, int]:
    """The GEMM-chain kernel's tile (gemm_chain.cu ``chain_tile``): two
    staging buffers per element input, ``n_bufs`` work cubes, each matrix
    as columns of M and of its transpose."""
    return cube_tile(p, 2 * n_elem, elem_bytes, n_bufs, 2 * n_mats)
