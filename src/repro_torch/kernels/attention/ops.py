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

``"pallas"`` and ``"interpret"`` agree with the reference's kernel on
every row, those that see no key (causal, ``Tq > Tk``) included: such a
row is the mean of the V rows below its key limit, which is set by
``block_q`` and ``block_k`` as the reference's blocks set it (0 when
that limit is 0; see ``ref.py``).
"""
from __future__ import annotations

import functools
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
