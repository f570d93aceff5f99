"""Decoder-only transformer (dense / MoE / VLM families) and the xLSTM
stack.

Block params are stacked along a leading ``n_layers`` axis, as the
reference stacks them with ``jax.vmap``; :func:`_scan_blocks` is a Python
loop over the layers in place of ``lax.scan``.  The xLSTM's blocks stay a
list of ``{"ln", "core"}`` dicts, as in the reference: ``core``'s keys
differ between its sLSTM and mLSTM layers.  The encoder-decoder
(whisper) stack of the reference's module is not ported yet (ROADMAP
queue 1, item 12).

``cfg.remat`` matters only to training (it wraps the reference's scan
body in ``jax.checkpoint``); these forward passes ignore it.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import layers, moe as moe_mod, ssm
from .config import ModelConfig

Params = Dict[str, Any]


# =============================================================================
# Uniform decoder block (dense or MoE FFN)
# =============================================================================

def block_init(gen, cfg: ModelConfig, dtype, *, lead: Tuple[int, ...] = (),
               device=None) -> Params:
    kw = dict(lead=lead, device=device)
    p = {
        "ln1": layers.norm_init(cfg.d_model, cfg.norm, dtype, **kw),
        "attn": layers.attention_init(gen, cfg, dtype, **kw),
        "ln2": layers.norm_init(cfg.d_model, cfg.norm, dtype, **kw),
    }
    if cfg.family == "moe" or (cfg.moe is not None and cfg.moe.layout == "all"):
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype, **kw)
    else:
        p["mlp"] = layers.mlp_init(gen, cfg, dtype, **kw)
    return p


def block_apply(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index=None,
    attn_impl: str = "auto",
    moe_capacity: Optional[int] = None,
):
    h = layers.norm_apply(p["ln1"], x, cfg.norm, cfg.norm_eps)
    a, new_cache = layers.attention_apply(
        p["attn"], h, cfg, positions=positions, cache=cache,
        cache_index=cache_index, causal=True, attn_impl=attn_impl,
    )
    x = x + a
    h = layers.norm_apply(p["ln2"], x, cfg.norm, cfg.norm_eps)
    if "moe" in p:
        f = moe_mod.moe_apply(p["moe"], h, cfg, capacity=moe_capacity)
    else:
        f = layers.mlp_apply(p["mlp"], h, cfg)
    return x + f, new_cache


# =============================================================================
# Decoder-only model (dense | moe | vlm)
# =============================================================================

def decoder_init(cfg: ModelConfig, generator: Optional[torch.Generator], *,
                 device=None) -> Params:
    """Random params from ``generator`` (on ``device``).  With
    ``device="meta"`` and no generator, only the shapes and dtypes."""
    dtype = layers.torch_dtype(cfg.param_dtype)
    p = {
        "embed": layers.embed_init(generator, cfg, dtype, device=device),
        "blocks": block_init(generator, cfg, dtype, lead=(cfg.n_layers,),
                             device=device),
        "ln_f": layers.norm_init(cfg.d_model, cfg.norm, dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["head"] = layers.dense_init(
            generator, cfg.d_model, cfg.vocab, dtype,
            scale=1.0 / math.sqrt(cfg.d_model), device=device,
        )
    return p


def _layer(tree, i: int):
    """Layer ``i`` of a stacked param (or cache) tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _scan_blocks(params_blocks, x, cfg, *, positions, attn_impl,
                 moe_capacity=None, caches=None, cache_index=None):
    """The blocks in order over stacked params (and stacked caches, which
    are written in place, if serving)."""
    for i in range(cfg.n_layers):
        x, _ = block_apply(
            _layer(params_blocks, i), x, cfg, positions=positions,
            cache=None if caches is None else _layer(caches, i),
            cache_index=cache_index, attn_impl=attn_impl,
            moe_capacity=moe_capacity,
        )
    return x, caches


def _positions(B: int, T: int, device) -> torch.Tensor:
    return torch.arange(T, device=device)[None].expand(B, T)


def decoder_forward(
    params: Params,
    tokens: torch.Tensor,              # (B, T)
    cfg: ModelConfig,
    *,
    attn_impl: str = "auto",
    moe_capacity: Optional[int] = None,
) -> torch.Tensor:
    """float32 logits (B, T, V); cache-less, so every layer's attention
    goes through the flash kernel on the card."""
    B, T = tokens.shape
    x = layers.embed_apply(params["embed"], tokens, cfg)
    x, _ = _scan_blocks(
        params["blocks"], x, cfg, positions=_positions(B, T, x.device),
        attn_impl=attn_impl, moe_capacity=moe_capacity,
    )
    x = layers.norm_apply(params["ln_f"], x, cfg.norm, cfg.norm_eps)
    return layers.unembed_apply(params["embed"], params.get("head"), x, cfg)


def decoder_init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                       device=None) -> Params:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dt = layers.torch_dtype(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decoder_prefill(
    params: Params,
    tokens: torch.Tensor,
    cache: Params,
    cfg: ModelConfig,
    *,
    attn_impl: str = "auto",
    moe_capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, Params]:
    """Run the prompt; returns (last-position logits, filled cache)."""
    B, T = tokens.shape
    x = layers.embed_apply(params["embed"], tokens, cfg)
    x, new_caches = _scan_blocks(
        params["blocks"], x, cfg, positions=_positions(B, T, x.device),
        attn_impl=attn_impl, moe_capacity=moe_capacity, caches=cache,
        cache_index=0,
    )
    x = layers.norm_apply(params["ln_f"], x, cfg.norm, cfg.norm_eps)
    logits = layers.unembed_apply(
        params["embed"], params.get("head"), x[:, -1:], cfg
    )
    return logits[:, 0], new_caches


def decoder_decode_step(
    params: Params,
    token: torch.Tensor,               # (B,) integers
    cache: Params,
    cache_index,                       # int / 0-d: write position; (B,): per slot
    cfg: ModelConfig,
    *,
    moe_capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, Params]:
    B = token.shape[0]
    x = layers.embed_apply(params["embed"], token[:, None], cfg)
    if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
        positions = cache_index[:, None]                    # per-slot decode
    else:
        positions = torch.full((B, 1), int(cache_index), device=x.device)
    x, new_caches = _scan_blocks(
        params["blocks"], x, cfg, positions=positions, attn_impl="xla",
        moe_capacity=moe_capacity, caches=cache, cache_index=cache_index,
    )
    x = layers.norm_apply(params["ln_f"], x, cfg.norm, cfg.norm_eps)
    logits = layers.unembed_apply(
        params["embed"], params.get("head"), x, cfg
    )
    return logits[:, 0], new_caches


# =============================================================================
# xLSTM stack (12 small layers: python loop)
# =============================================================================

def xlstm_init(cfg: ModelConfig, generator: Optional[torch.Generator], *,
               device=None) -> Params:
    """Random params from ``generator`` (on ``device``); with
    ``device="meta"`` and no generator, only the shapes and dtypes."""
    dtype = layers.torch_dtype(cfg.param_dtype)
    blocks = []
    for i in range(cfg.n_layers):
        kind = ssm.xlstm_block_kind(i, cfg)  # static per index: not stored
        init = ssm.slstm_init if kind == "slstm" else ssm.mlstm_init
        blocks.append({
            "ln": layers.norm_init(cfg.d_model, cfg.norm, dtype, device=device),
            "core": init(generator, cfg, dtype, device=device),
        })
    return {
        "embed": layers.embed_init(generator, cfg, dtype, device=device),
        "blocks": blocks,
        "ln_f": layers.norm_init(cfg.d_model, cfg.norm, dtype, device=device),
    }


def xlstm_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  states: Optional[List[ssm.State]] = None):
    """float32 logits (B, T, V).  With ``states`` (a list of per-layer
    recurrent states, the O(1) "cache") returns ``(logits, new_states)``;
    the states passed in are left as they were."""
    x = layers.embed_apply(params["embed"], tokens, cfg)
    new_states = [] if states is not None else None
    for i, bp in enumerate(params["blocks"]):
        kind = ssm.xlstm_block_kind(i, cfg)
        h = layers.norm_apply(bp["ln"], x, cfg.norm, cfg.norm_eps)
        if kind == "slstm":
            apply = ssm.slstm_apply
        elif ssm.MLSTM_CHUNK and tokens.shape[1] > ssm.MLSTM_CHUNK:
            apply = functools.partial(ssm.mlstm_apply_chunked,
                                      chunk=ssm.MLSTM_CHUNK)
        else:
            apply = ssm.mlstm_apply
        st = states[i] if states is not None else None
        y, new_st = apply(bp["core"], h, cfg, state=st)
        if states is not None:
            new_states.append(new_st)
        x = x + y
    x = layers.norm_apply(params["ln_f"], x, cfg.norm, cfg.norm_eps)
    logits = layers.unembed_apply(params["embed"], None, x, cfg)
    if states is not None:
        return logits, new_states
    return logits


def xlstm_init_states(cfg: ModelConfig, batch: int, *,
                      device=None) -> List[ssm.State]:
    return [
        ssm.xlstm_init_state(cfg, batch, ssm.xlstm_block_kind(i, cfg),
                             device=device)
        for i in range(cfg.n_layers)
    ]
