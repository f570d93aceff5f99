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
#: The reference turns them into sharding constraints on the dispatch
#: buffer, which it drops when no mesh is in scope; this package has no
#: device mesh for the model yet, so they are recorded and nothing else
#: (a ``torch.distributed`` expert axis belongs to the training slice).
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
    """Set the dispatch's group count (and record the mesh axes, which
    annotate sharding only; see ``_EP_SPEC``).  ``expert_axis=None`` and
    no ``token_axes``: grouped dispatch with replicated experts."""
    global _EP_SPEC, _NUM_GROUPS
    if expert_axis is None and not token_axes:
        _EP_SPEC = None
    else:
        _EP_SPEC = (expert_axis, tuple(token_axes) if token_axes else ())
    _NUM_GROUPS = max(1, num_groups)


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
    buf = torch.gather(xt, 1, slot_token[..., None].expand(G, E * cap_g, d))
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
        y = torch.zeros((G, Ng, d), dtype=cd, device=dev).scatter_add(
            1, slot_token[..., None].expand(G, E * cap_g, d), contrib)
    else:
        # token-side gather (baseline): every token reads its k slots
        safe_pos = torch.where(keep, flat_pos, cap_g - 1)
        flat_slot = flat_e * cap_g + safe_pos                    # (G, NKg)
        gathered = torch.gather(out_flat, 1,
                                flat_slot[..., None].expand(G, NKg, d))
        weighted = gathered * flat_gate[..., None].to(cd)
        y = weighted.reshape(G, Ng, K, d).sum(dim=2)
    return y.reshape(B, T, d).to(x.dtype)


def aux_load_balance_loss(logits: torch.Tensor, eidx: torch.Tensor,
                          E: int) -> torch.Tensor:
    """Switch-style auxiliary loss (fraction * probability per expert)."""
    probs = torch.softmax(logits.float(), dim=-1)
    frac = F.one_hot(eidx[..., 0].long(), E).float().mean(dim=0)
    imp = probs.mean(dim=0)
    return E * (frac * imp).sum()
