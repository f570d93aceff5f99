"""Fused Inverse-Helmholtz operator: the CUDA kernel's wrapper and its
plain PyTorch version.

:func:`inverse_helmholtz` is the port of the reference's
``inverse_helmholtz_pallas``: on CUDA tensors it launches
``csrc/helmholtz.cu`` (a persistent grid of CTAs walking tiles of
elements, every intermediate in shared memory; ``kernels._cube`` mirrors
its tile and shared memory); on CPU tensors it runs
:func:`inverse_helmholtz_plain`, which repeats the kernel's arithmetic
in plain PyTorch.  Both sum each output entry over ``l`` in ascending
order in float32, so an element's result never depends on the block
size or on how a batch is split.
"""
from __future__ import annotations

import torch

from .._cube import MAX_P

DEFAULT_BLOCK_ELEMENTS = 128


def _check_blocks(E: int, block_elements: int) -> int:
    be = min(block_elements, E)
    if be < 1 or E % be != 0:
        raise ValueError(f"element count {E} not divisible by block {be}")
    return be


def _check_shapes(S, D, u) -> int:
    if u.dim() != 4 or len(set(u.shape[1:])) != 1:
        raise ValueError(f"u must be (E, p, p, p), got {tuple(u.shape)}")
    p = u.shape[1]
    if tuple(S.shape) != (p, p) or D.shape != u.shape:
        raise ValueError(
            f"shape mismatch: S {tuple(S.shape)}, D {tuple(D.shape)}, "
            f"u {tuple(u.shape)}"
        )
    return p


def contract_mode(x: torch.Tensor, M: torch.Tensor, mode: int) -> torch.Tensor:
    """``y[e, .., a at mode, ..] = sum_l M[a, l] * x[e, .., l, ..]`` in the
    kernel's order: one multiply-add per ``l``, ascending."""
    ax = mode + 1
    acc = None
    for l in range(x.shape[ax]):
        xl = x.narrow(ax, l, 1)                       # (.., 1 at ax, ..)
        shape = [1] * x.dim()
        shape[ax] = M.shape[0]
        term = M[:, l].reshape(shape) * xl            # (.., a at ax, ..)
        acc = term if acc is None else acc + term
    return acc


def inverse_helmholtz_plain(
    S: torch.Tensor,
    D: torch.Tensor,
    u: torch.Tensor,
    *,
    block_elements: int = DEFAULT_BLOCK_ELEMENTS,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``v = (S (x)3) (D o (S^T (x)3)
    u)`` per element, float32 accumulation, stored in ``u.dtype``.
    ``block_elements`` must divide E, exactly as for the kernel."""
    _check_shapes(S, D, u)
    _check_blocks(u.shape[0], block_elements)
    f32 = torch.float32
    s = S.to(f32)
    t = u.to(f32)
    for mode in range(3):
        t = contract_mode(t, s, mode)                 # M(a, l) = S[a, l]
    r = D.to(f32) * t
    v = r
    for mode in range(3):
        v = contract_mode(v, s.t(), mode)             # M(a, l) = S[l, a]
    return v.to(u.dtype)


def inverse_helmholtz(
    S: torch.Tensor,
    D: torch.Tensor,
    u: torch.Tensor,
    *,
    block_elements: int = DEFAULT_BLOCK_ELEMENTS,
) -> torch.Tensor:
    """Batched fused Inverse Helmholtz.  S: (p, p); D, u: (E, p, p, p).

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version.  ``inverse_helmholtz.launches`` counts kernel launches."""
    p = _check_shapes(S, D, u)
    be = _check_blocks(u.shape[0], block_elements)
    devices = {S.device, D.device, u.device}
    if len(devices) != 1:
        raise ValueError(f"S, D and u lie on different devices: {devices}")
    device = u.device
    if device.type == "cpu":
        return inverse_helmholtz_plain(S, D, u, block_elements=be)
    if device.type != "cuda":
        raise ValueError(f"no Inverse-Helmholtz kernel for device {device}")
    from .. import _cuda

    if not (S.dtype == D.dtype == u.dtype):
        raise TypeError(
            f"S, D and u must share one dtype, got {S.dtype}, {D.dtype}, "
            f"{u.dtype}"
        )
    code = _cuda.dtype_code(u.dtype)
    if p > MAX_P:
        raise ValueError(f"kernel supports p <= {MAX_P}, got {p}")
    if not (S.is_contiguous() and D.is_contiguous() and u.is_contiguous()):
        raise ValueError("the kernel reads contiguous S, D and u")
    v = torch.empty_like(u)
    lib = _cuda.library()
    err = lib.repro_helmholtz(
        S.data_ptr(), D.data_ptr(), u.data_ptr(), v.data_ptr(),
        u.shape[0], p, code, _cuda.stream_handle(device),
    )
    _cuda.check(err, "helmholtz")
    inverse_helmholtz.launches += 1
    return v


inverse_helmholtz.launches = 0
