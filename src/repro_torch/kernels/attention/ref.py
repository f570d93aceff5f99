"""Plain PyTorch version of the flash-attention kernel (GQA + causal).

:func:`flash_attention_plain` repeats ``csrc/flash_attention.cu``'s
arithmetic: the same online-softmax recurrence over the same tiles of
``TILE_Q`` query rows and ``TILE_K`` keys, ascending, in float32, with the
reference kernel's constants (``attention.py`` of ``repro``):

* masked scores are ``-1e30``, not ``-inf``;
* queries align to the end of the keys, ``q_offset = Tk - Tq``;
* with ``causal``, a key tile is visited by a query tile only when the
  tile's last row reaches it (``q_end >= kt * TILE_K``); tiles wholly
  above the diagonal are skipped;
* a row whose running denominator is still 0 at the end is divided by 1.

So a row that is masked everywhere (``Tq > Tk``, causal) takes
``p = exp(0) = 1`` on every key of the tiles its query tile visits: it
comes out as the mean of those V rows (0 if no tile is visited), never
NaN.

Such rows can differ from the reference kernel's.  It visits by its
``block_q x block_k`` blocks (``min(512, T)`` by default), these tiles
are always 64 x 64, so the two agree on a fully masked row only where
both visit the same keys -- always at ``block_q = block_k = 64``, not
in general.  At ``Tq = 128,
Tk = 64`` and the reference's default blocks, its one query block
reaches key 0 and rows 0..63 come out as the mean of V, while this
tile 0 (last row at position -1) visits nothing and gives 0.  Rows that
see at least one key agree in every case; the model path, whose
cache-less forward has ``Tq = Tk``, has no fully masked row.

Shapes are head-folded: q ``(G, Tq, d)`` with ``G = batch *
n_q_heads``; k, v ``(Gkv, Tk, d)`` with ``Gkv = batch * n_kv_heads``.
"""
from __future__ import annotations

import torch

#: masked score, as in the reference kernel
NEG_INF = -1e30
#: query rows per CTA and keys per shared-memory tile of the CUDA kernel;
#: fixed, so results never depend on ``block_q``/``block_k``
TILE_Q = 64
TILE_K = 64


def check_blocks(Tq: int, Tk: int, block_q: int, block_k: int) -> None:
    """The reference kernel's block rule: ``min(block, T)`` divides T."""
    bq, bk = min(block_q, Tq), min(block_k, Tk)
    if bq < 1 or bk < 1 or Tq % bq or Tk % bk:
        raise ValueError(
            f"seq lens ({Tq},{Tk}) not divisible by blocks ({bq},{bk})"
        )


def check_shapes(q, k, v, n_q_heads: int, n_kv_heads: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(
            f"want q (G, Tq, d) and k, v (Gkv, Tk, d); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    G, _, d = q.shape
    Gkv = k.shape[0]
    if n_q_heads % n_kv_heads or G % n_q_heads or k.shape[2] != d or (
            G // n_q_heads * n_kv_heads != Gkv):
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} do not fold "
            f"{n_q_heads} query heads onto {n_kv_heads} KV heads"
        )


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    n_q_heads: int,
    n_kv_heads: int,
    causal: bool = True,
    scale: float | None = None,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch; output in ``q.dtype``.

    ``block_q``/``block_k`` are only checked (the reference's rule), as
    for the kernel."""
    check_shapes(q, k, v, n_q_heads, n_kv_heads)
    G, Tq, d = q.shape
    Gkv, Tk, _ = k.shape
    check_blocks(Tq, Tk, block_q, block_k)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    group = n_q_heads // n_kv_heads
    q_offset = Tk - Tq
    f32 = torch.float32
    # query head h of batch b reads KV head h // group of the same batch:
    # fold each group's query rows under its KV head
    qf = q.to(f32).reshape(Gkv, group * Tq, d)
    kf, vf = k.to(f32), v.to(f32)
    rows = torch.arange(Tq, device=q.device)
    qpos = (rows + q_offset).repeat(group)                 # (group * Tq,)
    tile_end = torch.clamp((rows // TILE_Q + 1) * TILE_Q, max=Tq) - 1
    q_end = (tile_end + q_offset).repeat(group)            # last row's qpos

    m = torch.full((Gkv, group * Tq, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((Gkv, group * Tq, d), dtype=f32, device=q.device)
    # with causal, no query tile reaches a key past the last row's qpos
    k_stop = min(Tk, max(q_offset + Tq, 0)) if causal else Tk
    for k0 in range(0, k_stop, TILE_K):
        kt, vt = kf[:, k0:k0 + TILE_K], vf[:, k0:k0 + TILE_K]
        s = torch.matmul(qf, kt.transpose(1, 2)) * scale   # (Gkv, rows, bk)
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[1], device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            visit = (q_end >= k0)[None, :, None]
        m_new = torch.maximum(m, s.amax(dim=2, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=2, keepdim=True)
        acc_new = acc * corr + torch.matmul(p, vt)
        if causal:
            m = torch.where(visit, m_new, m)
            l = torch.where(visit, l_new, l)
            acc = torch.where(visit, acc_new, acc)
        else:
            m, l, acc = m_new, l_new, acc_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l).reshape(G, Tq, d).to(q.dtype)
