"""Flash attention in plain PyTorch ops with a hand-written backward: the
port of the reference's ``flash_attention_xla`` (``xla_flash.py``).

The same online-softmax dataflow as the kernels, as a Python loop over
KV chunks of ``chunk`` keys (the reference's ``lax.scan``), and a
backward that recomputes each chunk from the saved ``(q, k, v, o, lse)``
(the reference's ``_flash_bwd``, step for step), so no (Tq, Tk) score
matrix is kept for the backward.  Scores and products accumulate in
float32; ``p`` is cast to ``v.dtype`` for the PV product, as in the
reference.

Layout: q (B, Hq, Tq, d), k/v (B, Hkv, Tk, d); GQA repeats each KV head
over its group on entry (its gradient sums back over the group).  Causal
masking assumes queries occupy the LAST Tq positions of the Tk context.
"""
from __future__ import annotations

import torch

from ...core.precision import matmul_f32

NEG_INF = -1e30

#: default KV chunk width, as in the reference
DEFAULT_CHUNK = 1024


def _masked(s, qpos, j, W, causal):
    if not causal:
        return s
    kpos = j * W + torch.arange(W, device=s.device)
    return torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)


def _flash_fwd_impl(q, k, v, scale, causal, chunk):
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    n = max(1, Tk // chunk)
    W = Tk // n
    qpos = (Tk - Tq) + torch.arange(Tq, device=q.device)
    f32 = torch.float32
    m = torch.full((B, H, Tq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=f32, device=q.device)
    acc = torch.zeros((B, H, Tq, d), dtype=f32, device=q.device)
    for j, (kj, vj) in enumerate(zip(k.chunk(n, dim=2), v.chunk(n, dim=2))):
        s = matmul_f32(q, kj.transpose(-1, -2)) * scale
        s = _masked(s, qpos, j, W, causal)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + matmul_f32(p.to(vj.dtype), vj)
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (acc / l_safe[..., None]).to(q.dtype)
    return o, m + torch.log(l_safe)


def _flash_bwd(q, k, v, o, lse, do, scale, causal, chunk):
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    n = max(1, Tk // chunk)
    W = Tk // n
    qpos = (Tk - Tq) + torch.arange(Tq, device=q.device)
    f32 = torch.float32
    dof = do.to(f32)
    qf = q.to(f32)
    # D_i = rowsum(do * o)
    Dm = (dof * o.to(f32)).sum(dim=-1)
    dq = torch.zeros((B, H, Tq, d), dtype=f32, device=q.device)
    dks, dvs = [], []
    for j, (kj, vj) in enumerate(zip(k.chunk(n, dim=2), v.chunk(n, dim=2))):
        s = matmul_f32(q, kj.transpose(-1, -2)) * scale
        s = _masked(s, qpos, j, W, causal)
        p = torch.exp(s - lse[..., None])
        dvs.append(torch.matmul(p.transpose(-1, -2), dof))
        dp = torch.matmul(dof, vj.to(f32).transpose(-1, -2))
        ds = p * (dp - Dm[..., None]) * scale
        dq = dq + torch.matmul(ds, kj.to(f32))
        dks.append(torch.matmul(ds.transpose(-1, -2), qf))
    dk = torch.cat(dks, dim=2)
    dv = torch.cat(dvs, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, chunk):
        o, lse = _flash_fwd_impl(q, k, v, scale, causal, chunk)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, causal, chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_xla(
    q: torch.Tensor,   # (B, Hq, Tq, d)
    k: torch.Tensor,   # (B, Hkv, Tk, d)
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    chunk: int | None = None,
) -> torch.Tensor:
    """Attention in ``q.dtype``; differentiable.  ``chunk`` (default
    :data:`DEFAULT_CHUNK`) is cut to Tk, and a chunk that does not divide
    Tk falls back to one chunk of Tk, as in the reference."""
    if chunk is None:
        chunk = DEFAULT_CHUNK
    B, Hq, Tq, d = q.shape
    _, Hkv, Tk, _ = k.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    group = Hq // Hkv
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=1)
        v = torch.repeat_interleave(v, group, dim=1)
    chunk = min(chunk, Tk)
    if Tk % chunk:
        chunk = Tk  # fallback: single chunk
    return _Flash.apply(q, k, v, scale, causal, chunk)
