"""Plain PyTorch version of the flash-attention kernels (GQA + causal).

:func:`flash_attention_plain` repeats the arithmetic of the kernel that
:func:`route` picks for the inputs: the same online-softmax recurrence
over key tiles of :func:`tile_k` keys, ascending, in float32, with the
reference kernel's constants (``attention.py`` of ``repro``):

* queries align to the end of the keys, ``q_offset = Tk - Tq``;
* the reference visits key blocks by its ``block_q x block_k`` blocks
  (``bq = min(block_q, Tq)``, ``bk = min(block_k, Tk)``) and skips a key
  block wholly above its query block's last row.  Its result is a
  function of (row, ``bq``, ``bk``) alone, which the port reproduces per
  row without taking those blocks as tiles (:func:`key_limits`): row
  ``t``'s query block ends at ``q_end = (t // bq + 1) * bq - 1 +
  q_offset``, its key limit is ``K_lim = 0`` if ``q_end < 0``, else
  ``min(Tk, (q_end // bk + 1) * bk)``; keys at or past ``K_lim`` score
  ``-inf`` and causally masked keys below it ``-1e30``;
* a row whose running denominator is still 0 at the end is divided by 1.

So a row that is masked everywhere (``Tq > Tk``, causal) takes ``p =
exp(0) = 1`` on every key below its ``K_lim``: it comes out as the mean
of those V rows, as in the reference, and as 0 when ``K_lim = 0``, never
NaN.  Rows that see a key are unchanged by the rule: their masked keys
get ``p = 0`` either way.  A result depends on the kernel's own tiles
only through the float32 summation order.

The ``wgmma`` route (bfloat16 storage at head dims 64 and 128) rounds
``p`` to bfloat16 for the PV product, as the reference's ``xla``
attention does (``p.astype(v.dtype)``), and sums ``l`` from the unrounded
float32 ``p``.  The ``fma`` route (float32 storage, and bfloat16 at head
dims 16 and 32) keeps ``p`` in float32, as the reference's kernel does.

Shapes are head-folded: q ``(G, Tq, d)`` with ``G = batch *
n_q_heads``; k, v ``(Gkv, Tk, d)`` with ``Gkv = batch * n_kv_heads``.
"""
from __future__ import annotations

import torch

#: masked score, as in the reference kernel
NEG_INF = -1e30
#: query rows per CTA and keys per tile of the CUDA-core (``fma``) kernel
TILE_Q = 64
TILE_K = 64
#: query rows per CTA and keys per tile of the tensor-core (``wgmma``) kernel
WGMMA_TILE_Q = 128
WGMMA_TILE_K = 128
#: head dims the tensor-core (``wgmma``) kernel is instantiated for
WGMMA_HEAD_DIMS = (64, 128)
#: query rows per ring tile of the tensor-core backward's dk/dv kernel,
#: to which its workspace (D and a copy of lse) pads each head's rows
WGMMA_BWD_ROWS = 64
#: one bfloat16 rounding of p, relative (half a step of 8 significant bits)
P_ROUND = 2.0 ** -8


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that serves ``dtype`` storage at head dim ``d``:
    ``"wgmma"`` for bfloat16 at d in :data:`WGMMA_HEAD_DIMS`, else
    ``"fma"``."""
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS else "fma"


def tile_k(dtype: torch.dtype, d: int) -> int:
    """Keys per tile of the kernel :func:`route` picks."""
    return WGMMA_TILE_K if route(dtype, d) == "wgmma" else TILE_K


def check_blocks(Tq: int, Tk: int, block_q: int, block_k: int):
    """The reference kernel's block rule: ``min(block, T)`` divides T.
    Returns the effective blocks ``(bq, bk)``."""
    bq, bk = min(block_q, Tq), min(block_k, Tk)
    if bq < 1 or bk < 1 or Tq % bq or Tk % bk:
        raise ValueError(
            f"seq lens ({Tq},{Tk}) not divisible by blocks ({bq},{bk})"
        )
    return bq, bk


def key_limits(Tq: int, Tk: int, bq: int, bk: int, causal: bool,
               device=None) -> torch.Tensor:
    """Each query row's ``K_lim`` (int64, ``(Tq,)``): the keys the
    reference's blocks visit for it are ``[0, K_lim)``."""
    rows = torch.arange(Tq, device=device)
    if not causal:
        return torch.full_like(rows, Tk)
    q_end = (rows // bq + 1) * bq - 1 + (Tk - Tq)
    lim = torch.clamp((torch.div(q_end, bk, rounding_mode="floor") + 1) * bk,
                      max=Tk)
    return torch.where(q_end < 0, torch.zeros_like(lim), lim)


def visible_pairs(Tq: int, Tk: int, bq: int, bk: int, causal: bool) -> int:
    """The (query, key) pairs whose ``p`` the visit rule leaves nonzero,
    summed over the rows: a row that sees a key, the keys causality
    leaves it (end-aligned: the last ``min(Tq, Tk)`` rows see ``Tk -
    min(Tq, Tk) + 1`` up to ``Tk``); a row that sees none (causal, ``Tq >
    Tk``), every key below its ``K_lim`` (``p = 1`` on each).  The work a
    launch does on (q, k, v): 4 d flops a pair forward, 10 d backward."""
    if not causal:
        return Tq * Tk
    n = min(Tq, Tk)
    pairs = n * (Tk - n) + n * (n + 1) // 2
    for t in range(Tq - n):
        q_end = (t // bq + 1) * bq - 1 + (Tk - Tq)
        pairs += 0 if q_end < 0 else min(Tk, (q_end // bk + 1) * bk)
    return pairs


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
    return_p_bound: bool = False,
    return_lse: bool = False,
):
    """The kernel's function in plain PyTorch; output in ``q.dtype``.

    With ``return_lse`` it also returns each row's log-sum-exp of its
    scaled scores, ``m + log(l)`` (``l == 0`` replaced by 1; float32,
    ``(G, Tq)``), which the kernels write for the backward
    (:func:`flash_attention_bwd_plain`); it comes last in the tuple.

    With ``return_p_bound`` it also returns, per output entry, one
    bfloat16 rounding of the ``p`` terms, ``2^-8 * sum_j p_j |v_j| / l``
    (float32; zero on the ``fma`` route, which does not round ``p``): how
    far two computations of the same row can differ where float32 scores
    summed in another order round ``p`` to different bfloat16
    neighbours."""
    check_shapes(q, k, v, n_q_heads, n_kv_heads)
    G, Tq, d = q.shape
    Gkv, Tk, _ = k.shape
    bq, bk = check_blocks(Tq, Tk, block_q, block_k)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    round_p = route(q.dtype, d) == "wgmma"
    tk = tile_k(q.dtype, d)
    group = n_q_heads // n_kv_heads
    q_offset = Tk - Tq
    f32 = torch.float32
    # query head h of batch b reads KV head h // group of the same batch:
    # fold each group's query rows under its KV head
    qf = q.to(f32).reshape(Gkv, group * Tq, d)
    kf, vf = k.to(f32), v.to(f32)
    qpos = (torch.arange(Tq, device=q.device) + q_offset).repeat(group)
    lim = key_limits(Tq, Tk, bq, bk, causal, q.device).repeat(group)

    m = torch.full((Gkv, group * Tq, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((Gkv, group * Tq, d), dtype=f32, device=q.device)
    acc_abs = torch.zeros_like(acc) if return_p_bound and round_p else None
    k_stop = int(lim.max()) if lim.numel() else 0
    for k0 in range(0, k_stop, tk):
        kt, vt = kf[:, k0:k0 + tk], vf[:, k0:k0 + tk]
        s = torch.matmul(qf, kt.transpose(1, 2)) * scale   # (Gkv, rows, tk)
        kpos = torch.arange(k0, k0 + kt.shape[1], device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF) if causal else s
        s = torch.where(kpos[None, :] < lim[:, None], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=2, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=2, keepdim=True)
        p_pv = p.to(torch.bfloat16).to(f32) if round_p else p
        acc = acc * corr + torch.matmul(p_pv, vt)
        if acc_abs is not None:
            acc_abs = acc_abs * corr + torch.matmul(p, vt.abs())
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l).reshape(G, Tq, d).to(q.dtype)
    extra = []
    if return_p_bound:
        extra.append(torch.zeros(G, Tq, d, dtype=f32, device=q.device)
                     if acc_abs is None
                     else (P_ROUND * acc_abs / l).reshape(G, Tq, d))
    if return_lse:
        extra.append((m + torch.log(l)).reshape(G, Tq))
    return (out, *extra) if extra else out


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    n_q_heads: int,
    n_kv_heads: int,
    causal: bool = True,
    scale: float | None = None,
):
    """The backward kernel's function in plain PyTorch: ``(dq, dk, dv)``
    in the inputs' dtypes from the forward's output ``o`` and per-row
    ``lse`` (:func:`flash_attention_plain` with ``return_lse``) and the
    output's gradient ``do``.

    It repeats the arithmetic of the backward kernel :func:`route` picks,
    the reference's ``_flash_bwd`` (``xla_flash.py``) per key tile of
    :data:`TILE_K` keys, in float32: ``p = exp(s scale - lse)`` (0 where
    causally masked), ``D = rowsum(do o)``, ``dv = p^T do``, ``dp = do
    v^T``, ``ds = p (dp - D) scale``, ``dq = ds k``, ``dk = ds^T q``; dk
    and dv sum over the group's query heads.  On the ``fma`` route
    (``csrc/flash_attention_bwd.cu``: float32, and bfloat16 at head dims
    16 and 32) everything stays float32.  On the ``wgmma`` route
    (``csrc/flash_attention_bwd_sm90.cu``: bfloat16 at head dims 64 and
    128) it rounds where that kernel's tensor-core products do: ``p`` to
    bfloat16 for ``dv``, and ``ds`` -- computed from the float32 ``p`` --
    to bfloat16 for ``dq`` and ``dk``; every sum stays float32.  Causal
    is end-aligned, and ``Tq <= Tk`` (every row sees a key), else
    ``ValueError``."""
    check_shapes(q, k, v, n_q_heads, n_kv_heads)
    G, Tq, d = q.shape
    Gkv, Tk, _ = k.shape
    if Tq > Tk:
        raise ValueError(f"the backward takes Tq <= Tk, got Tq={Tq} > Tk={Tk}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    group = n_q_heads // n_kv_heads
    f32 = torch.float32
    bf16 = torch.bfloat16
    rounds = route(q.dtype, d) == "wgmma"
    rows = group * Tq
    qf = q.to(f32).reshape(Gkv, rows, d)
    dof = do.to(f32).reshape(Gkv, rows, d)
    kf, vf = k.to(f32), v.to(f32)
    lse_f = lse.to(f32).reshape(Gkv, rows, 1)
    delta = (dof * o.to(f32).reshape(Gkv, rows, d)).sum(dim=2, keepdim=True)
    qpos = (torch.arange(Tq, device=q.device) + (Tk - Tq)).repeat(group)
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for k0 in range(0, Tk, TILE_K):
        kt, vt = kf[:, k0:k0 + TILE_K], vf[:, k0:k0 + TILE_K]
        p = torch.exp(torch.matmul(qf, kt.transpose(1, 2)) * scale - lse_f)
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[1], device=q.device)
            p = torch.where(qpos[:, None] >= kpos[None, :], p, 0.0)
        p_dv = p.to(bf16).to(f32) if rounds else p
        dv[:, k0:k0 + TILE_K] = torch.matmul(p_dv.transpose(1, 2), dof)
        dp = torch.matmul(dof, vt.transpose(1, 2))
        ds = p * (dp - delta) * scale
        if rounds:
            ds = ds.to(bf16).to(f32)
        dq += torch.matmul(ds, kt)
        dk[:, k0:k0 + TILE_K] = torch.matmul(ds.transpose(1, 2), qf)
    return (dq.reshape(G, Tq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
