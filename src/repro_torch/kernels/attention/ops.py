"""Public attention entry point with implementation switch.

Models call :func:`multi_head_attention` with ``(B, H, T, d)`` tensors;
head folding to the kernel layout happens here.  ``impl``:

* ``"auto"``: the CUDA kernel for CUDA tensors and for ``meta`` ones
  (whose launches are shapes only: the dry run counts the kernel path),
  ``"xla"`` on the CPU (as the reference takes the Pallas kernel only on
  a TPU);
* ``"pallas"``: the kernel's wrapper (:func:`.attention.flash_attention`),
  which runs the plain version for CPU tensors;
* ``"interpret"``: the kernel's plain PyTorch version on any device
  (:func:`.attention.flash_attention_interpret`);
* ``"xla"``: the same math in plain whole-tensor PyTorch ops
  (:func:`_xla_attention`);
* ``"xla_flash"``: the reference's blockwise path with its hand-written
  backward (:func:`.xla_flash.flash_attention_xla`).

Every impl is differentiable: ``"pallas"`` and ``"interpret"`` through
the backward kernels and their plain version (``Tq <= Tk``; on the
``wgmma`` route, bfloat16 at head dims 64 and 128, ``p`` is rounded to
bfloat16 for dv and ``ds`` for dq and dk, as the tensor-core kernel
rounds them), ``"xla"`` through autograd, ``"xla_flash"`` through its own
backward.

On DTensors (a sharded train step) every impl runs on each rank's local
shards (:func:`repro_torch.distributed.rules.local_attention`): a
DTensor never reaches the kernels' wrapper, and each rank's q heads meet
their KV heads where the model axis splits a group of q heads.

The serving path -- prefill and decode over a KV cache, and the
encoder-decoder's cross attention -- takes plain masked attention, as
the reference does (:func:`cache_attention`, :func:`masked_attention`).
A cache of DTensors is written and attended where it lies
(:func:`repro_torch.distributed.rules.split_cache_attention`).

``"pallas"`` and ``"interpret"`` agree with the reference's kernel on
every row, those that see no key (causal, ``Tq > Tk``) included: such a
row is the mean of the V rows below its key limit, which is set by
``block_q`` and ``block_k`` as the reference's blocks set it (0 when
that limit is 0; see ``ref.py``).
"""
from __future__ import annotations

import functools
import math
from typing import Literal, Optional

import torch
from torch.distributed.tensor import DTensor

from ...core.precision import matmul_f32
from .attention import flash_attention, flash_attention_interpret
from .ref import NEG_INF
from .xla_flash import flash_attention_xla

Impl = Literal["auto", "pallas", "interpret", "xla", "xla_flash"]


def _xla_attention(q, k, v, *, causal: bool, scale: float):
    """(B, Hq, Tq, d) x (B, Hkv, Tk, d) GQA attention in plain ops: scores
    in float32, softmax in float32, ``p`` cast to ``v.dtype`` before the
    PV product (accumulated in float32), output in ``q.dtype``."""
    B, Hq, Tq, d = q.shape
    _, Hkv, Tk, _ = k.shape
    group = Hq // Hkv
    qh = q.reshape(B, Hkv, group * Tq, d)
    s = matmul_f32(qh, k.transpose(-1, -2)).reshape(B, Hkv, group, Tq, Tk)
    s = s * scale
    if causal:
        qpos = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
        kpos = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = matmul_f32(p.reshape(B, Hkv, group * Tq, Tk), v)
    return o.reshape(B, Hq, Tq, d).to(q.dtype)


def multi_head_attention(
    q: torch.Tensor,   # (B, Hq, Tq, d)
    k: torch.Tensor,   # (B, Hkv, Tk, d)
    v: torch.Tensor,   # (B, Hkv, Tk, d)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    impl: Impl = "auto",
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    B, Hq, Tq, d = q.shape
    _, Hkv, Tk, _ = k.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if impl == "auto":
        impl = "pallas" if q.device.type in ("cuda", "meta") else "xla"
    if impl not in ("pallas", "interpret", "xla", "xla_flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        # each rank's batch rows and heads, as local tensors
        from ...distributed.rules import local_attention

        return local_attention(functools.partial(
            multi_head_attention, causal=causal, scale=scale, impl=impl,
            block_q=block_q, block_k=block_k), q, k, v)
    if impl == "xla_flash":
        return flash_attention_xla(q, k, v, causal=causal, scale=scale)
    if impl == "xla":
        return _xla_attention(q, k, v, causal=causal, scale=scale)

    qf = q.reshape(B * Hq, Tq, d).contiguous()
    kf = k.reshape(B * Hkv, Tk, d).contiguous()
    vf = v.reshape(B * Hkv, Tk, d).contiguous()
    fn = flash_attention if impl == "pallas" else flash_attention_interpret
    out = fn(
        qf, kf, vf,
        n_q_heads=Hq, n_kv_heads=Hkv, causal=causal, scale=scale,
        block_q=block_q, block_k=block_k,
    )
    return out.reshape(B, Hq, Tq, d)


def _is_per_slot(cache_index) -> bool:
    return isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1


def cache_attention(q, k, v, cache, cache_index, *, causal: bool = True):
    """Write ``k``, ``v`` (B, T, Hkv, hd) into ``cache`` (``{"k", "v"}``,
    each (B, Tk, Hkv, hd), written in place) at ``cache_index`` -- an int
    (a slice, its start clamped so the T rows fit:
    ``dynamic_update_slice``) or a (B,) tensor (continuous batching: each
    sequence at its own position, T == 1) -- and attend ``q`` (B, T, Hq,
    hd) over the written slots: (B, Hq, T, hd)."""
    if isinstance(cache["k"], DTensor):
        # a cache split over a mesh: written and read where it lies
        from ...distributed.rules import split_cache_attention

        return split_cache_attention(_cache_attention, q, k, v, cache,
                                     cache_index, causal=causal)
    return _cache_attention(q, k, v, cache["k"], cache["v"], cache_index,
                            causal=causal)


def reads_old_rows(cache_index) -> bool:
    """Whether attending new rows written at ``cache_index`` reads rows
    written before: a per-slot position, or a slice not written at row
    0 (past the slice, every row is masked)."""
    return _is_per_slot(cache_index) or int(cache_index or 0) != 0


def write_cache(k, v, ck, cv, cache_index, *, lo: int = 0,
                Tk: Optional[int] = None) -> None:
    """Write ``k``, ``v`` (B, T, Hkv, hd) into ``ck``, ``cv`` in place at
    ``cache_index`` (see :func:`cache_attention`), where ``ck`` and
    ``cv`` hold the rows ``lo`` .. ``lo + ck.shape[1]`` of a ``Tk``-row
    cache: the rows that fall there."""
    B, T = k.shape[:2]
    Tl = ck.shape[1]
    Tk = Tl if Tk is None else Tk
    idx = cache_index
    if _is_per_slot(cache_index):
        bidx = torch.arange(B, device=k.device)
        if Tl == Tk:
            ck[bidx, idx] = k[:, 0].to(ck.dtype)
            cv[bidx, idx] = v[:, 0].to(cv.dtype)
        else:
            # each sequence's row where it lies; elsewhere the slot it
            # would clamp to keeps its value
            at = (idx - lo).clamp(0, Tl - 1)
            here = ((idx >= lo) & (idx < lo + Tl))[:, None, None]
            ck[bidx, at] = torch.where(here, k[:, 0].to(ck.dtype),
                                       ck[bidx, at])
            cv[bidx, at] = torch.where(here, v[:, 0].to(cv.dtype),
                                       cv[bidx, at])
    else:
        start = min(max(int(idx), 0), Tk - T)
        a, b = max(start, lo), min(start + T, lo + Tl)
        if a < b:
            ck[:, a - lo:b - lo] = k[:, a - start:b - start].to(ck.dtype)
            cv[:, a - lo:b - lo] = v[:, a - start:b - start].to(cv.dtype)


def _cache_attention(q, k, v, ck, cv, cache_index, *, causal: bool,
                     lo: int = 0, Tk: Optional[int] = None, reduce=None,
                     hd: Optional[int] = None, reduce_scores=None):
    """:func:`cache_attention` on plain tensors.  ``ck`` and ``cv`` may
    hold the rows ``lo`` .. ``lo + ck.shape[1]`` of a ``Tk``-row cache, a
    rank's split of it: only the rows there are written, keys are masked
    by their global positions, and ``reduce(t, op)`` sums (``op``
    ``"sum"``) or takes the max (``"max"``) over the ranks for the
    softmax (:func:`masked_attention`).  Split on the head dim (``hd``
    whole, the local head dim a part of it), the scores are partial sums
    that ``reduce_scores`` sums over the ranks."""
    T = q.shape[1]
    idx = cache_index if cache_index is not None else 0
    per_slot = _is_per_slot(cache_index)
    write_cache(k, v, ck, cv, idx, lo=lo, Tk=Tk)
    kpos = lo + torch.arange(ck.shape[1], device=q.device)
    # mask out unwritten cache slots
    if per_slot:
        valid = kpos[None, :] <= idx[:, None]                # (B, Tk)
    else:
        valid = kpos[None, :] <= (idx + T - 1)               # (1, Tk)
    # for per-slot decode the mask subsumes causality
    return masked_attention(q.transpose(1, 2), ck.transpose(1, 2),
                            cv.transpose(1, 2),
                            causal=causal and not per_slot, valid=valid,
                            cache_index=cache_index, kpos=kpos,
                            reduce=reduce, hd=hd,
                            reduce_scores=reduce_scores)


def masked_attention(q, k, v, *, causal: bool, valid, cache_index,
                     kpos=None, reduce=None, hd=None, reduce_scores=None):
    """(B, Hq, T, d) x (B, Hkv, Tk, d) GQA attention with an explicit
    validity/causal mask (the cache and cross paths): scores and softmax
    in float32, ``p`` cast to ``v.dtype`` for the PV product (accumulated
    in float32).  ``kpos``: the keys' positions (``arange(Tk)``).  With
    ``reduce``, the keys are one rank's split of them: the softmax's max
    and sum and the output are reduced over the ranks (flash-decoding's
    combine).  ``hd``: the whole head dim where q and k hold a split of
    it, whose partial scores ``reduce_scores`` sums."""
    B, Hq, T, d = q.shape
    _, Hkv, Tk, _ = k.shape
    group = Hq // Hkv
    qg = q.float().reshape(B, Hkv, group * T, d)
    s = torch.matmul(qg, k.float().transpose(-1, -2))
    if reduce_scores is not None:
        s = reduce_scores(s)
    s = s.reshape(B, Hkv, group, T, Tk) / math.sqrt(hd or d)
    mask = None
    if causal:
        start = cache_index if cache_index is not None else 0
        qpos = start + torch.arange(T, device=q.device)
        if kpos is None:
            kpos = torch.arange(Tk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
    if valid is not None:
        vmask = valid[:, None, :].expand(B, T, Tk)
        mask = vmask if mask is None else (mask[None] & vmask)
    if mask is not None:
        mask = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
        s = torch.where(mask, s, NEG_INF)
    if reduce is None:
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = matmul_f32(p.reshape(B, Hkv, group * T, Tk), v)
    else:
        e = torch.exp(s - reduce(s.amax(dim=-1, keepdim=True), "max"))
        p = (e / reduce(e.sum(dim=-1, keepdim=True), "sum")).to(v.dtype)
        o = reduce(matmul_f32(p.reshape(B, Hkv, group * T, Tk), v), "sum")
    return o.reshape(B, Hq, T, d).to(q.dtype)
