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

``block_elements`` is the kernel's tile ``te``, the elements a CTA takes
a step (None: the kernel's default, ``_cube.helmholtz_tile``); any E
runs at any legal tile, the last one ragged.
"""
from __future__ import annotations

from typing import Optional

import torch

from .._cube import MAX_P, check_te, helmholtz_max_tile, helmholtz_tile


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


def _check_out(name: str, out: torch.Tensor, like: torch.Tensor) -> None:
    """``out`` must be a contiguous tensor of ``like``'s shape and dtype."""
    if (tuple(out.shape) != tuple(like.shape) or out.dtype != like.dtype
            or not out.is_contiguous()):
        raise ValueError(
            f"out {name!r} must be contiguous {like.dtype} "
            f"{tuple(like.shape)}, got {out.dtype} {tuple(out.shape)}"
        )


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
    block_elements: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``v = (S (x)3) (D o (S^T (x)3)
    u)`` per element, float32 accumulation, stored in ``u.dtype``.  The
    result does not depend on ``block_elements`` (the kernel's tile)."""
    _check_shapes(S, D, u)
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
    block_elements: Optional[int] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched fused Inverse Helmholtz.  S: (p, p); D, u: (E, p, p, p).

    CUDA tensors launch the kernel at ``block_elements`` elements a CTA
    step (None: its default tile), refusing a tile it cannot launch with
    before the launch; CPU tensors run the plain version.  ``out``, a
    contiguous tensor like ``u`` (a slice of a larger batch's output,
    say), receives ``v`` and is returned.
    ``inverse_helmholtz.launches`` counts kernel launches."""
    p = _check_shapes(S, D, u)
    devices = {S.device, D.device, u.device}
    if out is not None:
        _check_out("v", out, u)
        devices.add(out.device)
    if len(devices) != 1:
        raise ValueError(f"S, D, u and out lie on different devices: "
                         f"{devices}")
    device = u.device
    if device.type == "cpu":
        v = inverse_helmholtz_plain(S, D, u, block_elements=block_elements)
        return v if out is None else out.copy_(v)
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
    eb = u.element_size()
    te = block_elements or helmholtz_tile(p, eb)[0]
    check_te("Inverse-Helmholtz", p, te, helmholtz_max_tile(p, eb))
    v = torch.empty_like(u) if out is None else out
    lib = _cuda.library()
    with _cuda.launch_on(device) as stream:
        err = lib.repro_helmholtz(
            S.data_ptr(), D.data_ptr(), u.data_ptr(), v.data_ptr(),
            u.shape[0], p, code, te, stream,
        )
    _cuda.check(err, "helmholtz")
    inverse_helmholtz.launches += 1
    return v


inverse_helmholtz.launches = 0
