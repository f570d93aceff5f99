"""Mixture-of-Experts FFN with capacity-based dispatch (the reference's
``models/moe.py``, step for step).

Routing is data-dependent top-k, so it is written out in tensor ops; the
expert products are batched matmuls over the expert axis, accumulated
in float32 (:func:`~repro_torch.core.precision.matmul_f32`) as the
reference's ``preferred_element_type`` einsums are.

Dispatch uses the Switch/GShard capacity formulation:
  * capacity C = max(ceil(tokens * top_k / E * capacity_factor), 8),
    divided over the token groups (at least 8 slots a group);
  * position-in-expert via a stable sort of the flattened (token, k)
    assignment list and a search for each expert's first slot; tokens
    beyond capacity are dropped (every shape stays static);
  * dispatch by gather into a ``(G, E, C, d)`` buffer; combine by a
    token-side gather (``COMBINE_MODE = "gather"``, the default) or an
    expert-side scatter-add (``"scatter"``; on CUDA the adds are atomics
    and sum in no fixed order).

The row gathers, the scatter-add and the combine's sum over the top k
are ops of this package (:func:`gather_rows`, :func:`scatter_add_rows`,
each the other's gradient as autograd's ``gather`` and ``scatter_add``
are, and :func:`sum_top_k`; on plain tensors bit for bit the tensor ops
they name), so that the distribution layer can place them
expert-parallel (:mod:`repro_torch.distributed.rules`): a rule runs
below autograd.

Ties among router probabilities resolve as ``jax.lax.top_k`` resolves
them, the lower expert index first: the top k come from a stable
descending sort (``torch.topk`` promises no order among equal values).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import layers
from .config import ModelConfig

Params = Dict[str, Any]

#: the expert and token mesh axes last given to :func:`set_ep_sharding`.
#: On DTensor tokens the dispatch buffer and the expert outputs are
#: placed by them, as the reference constrains both: groups over the
#: token axes, experts over the expert axis (the rules of
#: :func:`gather_rows` and :func:`scatter_add_rows`).  Plain tensors
#: ignore them, as the reference drops its constraint with no mesh.
_EP_SPEC: Optional[Tuple[Optional[str], Tuple[str, ...]]] = None
#: GShard-style grouped dispatch: tokens reshaped to (G, N/G, d), every
#: routing step (sort, rank, gather) batched per group.  The group count
#: changes the results -- each group has capacity // G slots per expert,
#: and G falls back to 1 when it does not divide N -- so it is honoured.
_NUM_GROUPS: int = 1
#: "gather" (token-side, baseline) | "scatter" (expert-side partial sum)
COMBINE_MODE: str = "gather"


def set_ep_sharding(expert_axis: Optional[str] = "model",
                    token_axes: Optional[Sequence[str]] = ("data",),
                    num_groups: int = 1) -> None:
    """Set the dispatch's group count and the mesh axes that place its
    buffer (``_EP_SPEC``).  ``expert_axis=None`` and no ``token_axes``:
    grouped dispatch with replicated experts."""
    global _EP_SPEC, _NUM_GROUPS
    if expert_axis is None and not token_axes:
        _EP_SPEC = None
    else:
        _EP_SPEC = (expert_axis, tuple(token_axes) if token_axes else ())
    _NUM_GROUPS = max(1, num_groups)


@torch.library.custom_op("repro_torch::gather_rows", mutates_args=())
def gather_rows(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``out[g, j] = src[g, index[g, j]]``: rows of ``src`` (G, S, d) by
    ``index`` (G, J), as ``torch.gather`` along dim 1 -- the dispatch
    (tokens into expert slots) and the token-side combine (slots back to
    tokens)."""
    return torch.gather(src, 1, index[..., None].expand(
        *index.shape, src.shape[-1]))


@gather_rows.register_fake
def _(src, index):
    return src.new_empty((*index.shape, src.shape[-1]))


@torch.library.custom_op("repro_torch::scatter_add_rows", mutates_args=())
def scatter_add_rows(src: torch.Tensor, index: torch.Tensor,
                     like: torch.Tensor) -> torch.Tensor:
    """Zeros of ``like``'s shape (G, S, d) in ``src``'s dtype, row
    ``index[g, j]`` plus ``src[g, j]``, as ``scatter_add`` along dim 1
    (``like`` read for its shape only): :func:`gather_rows`' gradient,
    and the expert-side combine."""
    return src.new_zeros(like.shape).scatter_add_(
        1, index[..., None].expand(*index.shape, src.shape[-1]), src)


@scatter_add_rows.register_fake
def _(src, index, like):
    return src.new_empty(like.shape)


@torch.library.custom_op("repro_torch::sum_top_k", mutates_args=())
def sum_top_k(rows: torch.Tensor, k: int) -> torch.Tensor:
    """``rows`` (G, N k, d) summed over each token's ``k`` consecutive
    rows: (G, N, d) -- the end of the combine, where the distribution
    layer reduces a sum over the experts' ranks."""
    G, NK, d = rows.shape
    return rows.reshape(G, NK // k, k, d).sum(dim=2)


@sum_top_k.register_fake
def _(rows, k):
    G, NK, d = rows.shape
    return rows.new_empty((G, NK // k, d))


def _sum_top_k_context(ctx, inputs, output):
    ctx.k = inputs[1]


def _sum_top_k_grad(ctx, grad):
    G, N, d = grad.shape
    return grad[:, :, None].expand(G, N, ctx.k, d).reshape(G, N * ctx.k,
                                                          d), None


sum_top_k.register_autograd(_sum_top_k_grad, setup_context=_sum_top_k_context)


def _gather_rows_context(ctx, inputs, output):
    src, index = inputs
    ctx.save_for_backward(src, index)


def _gather_rows_grad(ctx, grad):
    src, index = ctx.saved_tensors
    return scatter_add_rows(grad, index, src), None


def _scatter_add_rows_context(ctx, inputs, output):
    ctx.save_for_backward(inputs[1])


def _scatter_add_rows_grad(ctx, grad):
    (index,) = ctx.saved_tensors
    return gather_rows(grad, index), None, None


gather_rows.register_autograd(_gather_rows_grad,
                              setup_context=_gather_rows_context)
scatter_add_rows.register_autograd(_scatter_add_rows_grad,
                                   setup_context=_scatter_add_rows_context)


def moe_init(gen, cfg: ModelConfig, dtype, *, lead: Tuple[int, ...] = (),
             device=None) -> Params:
    m = cfg.moe
    d, ff, E = cfg.d_model, m.d_ff_expert, m.n_experts
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(ff * 2 * cfg.n_layers)
    return {
        "router": layers.dense_init(gen, d, E, dtype, lead=lead, device=device),
        "w_gate": layers._normal(gen, (*lead, E, d, ff), dtype, s_in, device),
        "w_up": layers._normal(gen, (*lead, E, d, ff), dtype, s_in, device),
        "w_down": layers._normal(gen, (*lead, E, ff, d), dtype, s_out, device),
    }


def _route(p: Params, xt: torch.Tensor, cfg: ModelConfig,
           capacity: Optional[int]):
    """Router and capacity ranks for tokens ``xt`` (G, Ng, d): top-k
    experts ``eidx`` and renormalised gates (G, Ng, K), each assignment's
    rank within its expert ``flat_pos`` and whether it fits ``keep``
    (G, Ng*K), the stable sort of the assignments by expert, each
    expert's first sorted slot (G, E), and the per-group capacity."""
    m = cfg.moe
    G, Ng, _ = xt.shape
    E, K = m.n_experts, m.top_k
    logits = layers.dense_apply(p["router"], xt, torch.float32)  # (G, Ng, E)
    probs = torch.softmax(logits.float(), dim=-1)
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[..., :K], eidx[..., :K]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    if capacity is None:
        capacity = max(int(math.ceil(G * Ng * K / E * m.capacity_factor)), 8)
    cap_g = max(8, capacity // G)

    # rank within expert: stable sort of the flat expert ids, each
    # expert's first slot by a batched search
    NKg = Ng * K
    flat_e = eidx.reshape(G, NKg)
    sorted_idx = torch.argsort(flat_e, dim=1, stable=True)       # (G, NKg)
    sorted_e = torch.gather(flat_e, 1, sorted_idx).contiguous()
    experts = torch.arange(E, device=xt.device).expand(G, E).contiguous()
    first = torch.searchsorted(sorted_e, experts)                # (G, E)
    rank_sorted = (torch.arange(NKg, device=xt.device)[None]
                   - torch.gather(first, 1, sorted_e))
    flat_pos = torch.zeros_like(flat_e).scatter(1, sorted_idx, rank_sorted)
    keep = flat_pos < cap_g
    return gate, eidx, flat_e, flat_pos, keep, sorted_idx, first, cap_g


def moe_apply(
    p: Params,
    x: torch.Tensor,          # (B, T, d)
    cfg: ModelConfig,
    *,
    capacity: Optional[int] = None,
) -> torch.Tensor:
    """Grouped capacity dispatch.

    ``capacity`` is the GLOBAL capacity (slots per expert across all
    groups); it is divided across groups internally.
    """
    m = cfg.moe
    B, T, d = x.shape
    E, K = m.n_experts, m.top_k
    N = B * T
    G = _NUM_GROUPS if N % _NUM_GROUPS == 0 else 1
    Ng = N // G
    cd = layers.torch_dtype(cfg.compute_dtype)
    xt = x.reshape(G, Ng, d)

    gate, _, flat_e, flat_pos, keep, sorted_idx, first, cap_g = _route(
        p, xt, cfg, capacity)
    NKg = Ng * K
    flat_gate = gate.reshape(G, NKg) * keep.to(gate.dtype)

    # ---- dispatch by gather: slot (g, e, c) pulls its token directly ------
    dev = x.device
    ends = torch.cat([first[:, 1:], torch.full((G, 1), NKg, device=dev,
                                                dtype=first.dtype)], dim=1)
    grid = first[:, :, None] + torch.arange(cap_g, device=dev)[None, None]
    slot_valid = grid < ends[:, :, None]                         # (G, E, C)
    slot_src = torch.where(slot_valid, grid.clamp(0, NKg - 1), 0)
    slot_assign = torch.gather(sorted_idx, 1, slot_src.reshape(G, E * cap_g))
    slot_token = slot_assign // K                                # (G, E*C)
    buf = gather_rows(xt, slot_token)
    buf = buf.to(cd).reshape(G, E, cap_g, d) * slot_valid[..., None].to(cd)

    # ---- expert compute (batched products over the expert axis) -----------
    wg, wu, wd = (p["w_gate"].to(cd), p["w_up"].to(cd), p["w_down"].to(cd))
    xe = buf.transpose(0, 1).reshape(E, G * cap_g, d)
    mm = layers.matmul_acc       # f32, or cd under REDUCE_IN_COMPUTE_DTYPE
    if cfg.act == "swiglu":
        g = mm(xe, wg)
        u = mm(xe, wu)
        h = F.silu(g.float()).to(cd) * u.to(cd)
    else:
        u = mm(xe, wu)
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(u.float(), approximate="tanh").to(cd)
    out_flat = (mm(h, wd).to(cd).reshape(E, G, cap_g, d)
                .transpose(0, 1).reshape(G, E * cap_g, d))

    # ---- combine ------------------------------------------------------------
    if COMBINE_MODE == "scatter":
        # expert-side scatter-add: each slot pushes its weighted output
        # into its token's row
        slot_gate = torch.gather(flat_gate, 1, slot_assign)
        contrib = out_flat * (slot_gate[..., None].to(cd)
                              * slot_valid.reshape(G, E * cap_g)[..., None]
                              .to(cd))
        y = scatter_add_rows(contrib, slot_token, xt)
    else:
        # token-side gather (baseline): every token reads its k slots
        safe_pos = torch.where(keep, flat_pos, cap_g - 1)
        flat_slot = flat_e * cap_g + safe_pos                    # (G, NKg)
        gathered = gather_rows(out_flat, flat_slot)
        weighted = gathered * flat_gate[..., None].to(cd)
        y = sum_top_k(weighted, K)
    return y.reshape(B, T, d).to(x.dtype)


def aux_load_balance_loss(logits: torch.Tensor, eidx: torch.Tensor,
                          E: int) -> torch.Tensor:
    """Switch-style auxiliary loss (fraction * probability per expert)."""
    probs = torch.softmax(logits.float(), dim=-1)
    frac = F.one_hot(eidx[..., 0].long(), E).float().mean(dim=0)
    imp = probs.mean(dim=0)
    return E * (frac * imp).sum()
