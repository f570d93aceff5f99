"""Jamba-style hybrid: Mamba and attention interleaved 1:7, with MoE FFNs
(the reference's ``models/hybrid.py``, step for step).

Structure (a period of ``attn_period`` layers):

  layer i in period:  mixer = attention  if i == attn_period-1 else mamba
                      ffn   = MoE        if i odd else dense MLP

For jamba-1.5-large: 72 layers = 9 periods of 8; one attention layer per
period (1:7), MoE on every other layer -- the published layout.

Every leaf under ``periods`` carries a leading ``n_periods`` axis, as the
reference's ``jax.vmap`` stacks them; the forward is a Python loop over
the periods in place of ``lax.scan``.  There is no ``head``: the logits
come from the embedding table, transposed.

The cache keeps the reference's layout: per period the attention
layer's k and v, and the conv and ssm states of the period's Mamba
layers.  Prefill and decode write the new k and v into the cache they
are given, in place (as every decoder of ``layers`` does), and return
the Mamba states as new stacked tensors, as the reference stacks them:
the conv and ssm states passed in are left as they were.

``cfg.remat == "block"`` recomputes each period in the backward while
autograd records (:func:`~.transformer.remat`), as the reference wraps
its scan body in ``jax.checkpoint``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from . import layers, moe as moe_mod, ssm
from .config import ModelConfig
from .transformer import _layer, _positions, _unstack, remat

Params = Dict[str, Any]


def _n_periods(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_period


def _sub_init(gen, cfg: ModelConfig, idx_in_period: int, dtype, *,
              lead: Tuple[int, ...] = (), device=None) -> Params:
    kw = dict(lead=lead, device=device)
    p: Params = {"ln1": layers.norm_init(cfg.d_model, cfg.norm, dtype, **kw),
                 "ln2": layers.norm_init(cfg.d_model, cfg.norm, dtype, **kw)}
    if idx_in_period == cfg.attn_period - 1:
        p["attn"] = layers.attention_init(gen, cfg, dtype, **kw)
    else:
        p["mamba"] = ssm.mamba_init(gen, cfg, dtype, **kw)
    if idx_in_period % 2 == 1:
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype, **kw)
    else:
        p["mlp"] = layers.mlp_init(gen, cfg, dtype, **kw)
    return p


def hybrid_init(cfg: ModelConfig, generator: Optional[torch.Generator], *,
                device=None) -> Params:
    """Random params from ``generator`` (on ``device``).  With
    ``device="meta"`` and no generator, only the shapes and dtypes."""
    dtype = layers.torch_dtype(cfg.param_dtype)
    lead = (_n_periods(cfg),)
    return {
        "embed": layers.embed_init(generator, cfg, dtype, device=device),
        "periods": {
            f"sub{i}": _sub_init(generator, cfg, i, dtype, lead=lead,
                                 device=device)
            for i in range(cfg.attn_period)
        },
        "ln_f": layers.norm_init(cfg.d_model, cfg.norm, dtype, device=device),
    }


def _period_apply(pp, x, cfg, *, positions, attn_impl, moe_capacity,
                  cache=None, cache_index=None):
    """One period (``attn_period`` sub-layers).  ``cache``: this period's
    'k'/'v' (written in place) and 'conv'/'ssm' stacked over its Mamba
    slots (read only); returns the new Mamba states stacked likewise."""
    new_mamba = {"conv": [], "ssm": []}
    mamba_slot = 0
    for i in range(cfg.attn_period):
        sp = pp[f"sub{i}"]
        h = layers.norm_apply(sp["ln1"], x, cfg.norm, cfg.norm_eps)
        if "attn" in sp:
            c = None if cache is None else {"k": cache["k"], "v": cache["v"]}
            a, _ = layers.attention_apply(
                sp["attn"], h, cfg, positions=positions, cache=c,
                cache_index=cache_index, causal=True, attn_impl=attn_impl,
            )
        else:
            st = None
            if cache is not None:
                st = {"conv": cache["conv"][mamba_slot],
                      "ssm": cache["ssm"][mamba_slot]}
            a, nst = ssm.mamba_apply(sp["mamba"], h, cfg, state=st)
            if cache is not None:
                new_mamba["conv"].append(nst["conv"])
                new_mamba["ssm"].append(nst["ssm"])
                mamba_slot += 1
        x = x + a
        h = layers.norm_apply(sp["ln2"], x, cfg.norm, cfg.norm_eps)
        if "moe" in sp:
            f = moe_mod.moe_apply(sp["moe"], h, cfg, capacity=moe_capacity)
        else:
            f = layers.mlp_apply(sp["mlp"], h, cfg)
        x = x + f
    if cache is None:
        return x, None
    return x, {k: torch.stack(v) for k, v in new_mamba.items()}


def hybrid_forward(
    params: Params,
    tokens: torch.Tensor,             # (B, T)
    cfg: ModelConfig,
    *,
    attn_impl: str = "auto",
    moe_capacity: Optional[int] = None,
) -> torch.Tensor:
    """float32 logits (B, T, V); cache-less, so each period's attention
    layer goes through the flash kernel on the card."""
    T = tokens.shape[1]
    x = layers.embed_apply(params["embed"], tokens, cfg)
    positions = _positions(T, x.device)
    body = remat(cfg, functools.partial(
        _period_apply, cfg=cfg, positions=positions, attn_impl=attn_impl,
        moe_capacity=moe_capacity))
    for pp in _unstack(params["periods"], _n_periods(cfg)):
        x, _ = body(pp, x)
    x = layers.norm_apply(params["ln_f"], x, cfg.norm, cfg.norm_eps)
    return layers.unembed_apply(params["embed"], None, x, cfg)


def hybrid_init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      device=None) -> Params:
    n_periods = _n_periods(cfg)
    n_mamba = cfg.attn_period - 1
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    dt = layers.torch_dtype(cfg.compute_dtype)
    kv = (n_periods, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
        "conv": torch.zeros((n_periods, n_mamba, batch, m.d_conv - 1, d_in),
                            dtype=dt, device=device),
        "ssm": torch.zeros((n_periods, n_mamba, batch, d_in, m.d_state),
                           dtype=torch.float32, device=device),
    }


def _cached_apply(params, x, positions, cache, cache_index, cfg,
                  moe_capacity=None):
    """Every period on its slice of the cache (plain masked attention, as
    the reference's cache path); returns the cache with the same k and v
    tensors, now written, and new conv and ssm stacks."""
    new = {"conv": [], "ssm": []}
    for i in range(_n_periods(cfg)):
        x, nc = _period_apply(
            _layer(params["periods"], i), x, cfg, positions=positions,
            attn_impl="xla", moe_capacity=moe_capacity,
            cache=_layer(cache, i), cache_index=cache_index,
        )
        for k in new:
            new[k].append(nc[k])
    return x, {"k": cache["k"], "v": cache["v"],
               **{k: torch.stack(v) for k, v in new.items()}}


def hybrid_prefill(params, tokens, cache, cfg, *, moe_capacity=None):
    """Run the prompt from cache index 0; returns (last-position logits,
    the cache)."""
    T = tokens.shape[1]
    x = layers.embed_apply(params["embed"], tokens, cfg)
    x, new_cache = _cached_apply(
        params, x, _positions(T, x.device), cache, 0, cfg,
        moe_capacity=moe_capacity,
    )
    x = layers.norm_apply(params["ln_f"], x, cfg.norm, cfg.norm_eps)
    logits = layers.unembed_apply(params["embed"], None, x[:, -1:], cfg)
    return logits[:, 0], new_cache


def hybrid_decode_step(params, token, cache, cache_index, cfg,
                       *, moe_capacity=None):
    """One token a sequence (``token``: (B,)) at the scalar position
    ``cache_index`` (an int or a 0-d tensor), as in the reference."""
    B = token.shape[0]
    cache_index = int(cache_index)
    x = layers.embed_apply(params["embed"], token[:, None], cfg)
    positions = torch.full((B, 1), cache_index, device=x.device)
    x, new_cache = _cached_apply(
        params, x, positions, cache, cache_index, cfg,
        moe_capacity=moe_capacity,
    )
    x = layers.norm_apply(params["ln_f"], x, cfg.norm, cfg.norm_eps)
    logits = layers.unembed_apply(params["embed"], None, x, cfg)
    return logits[:, 0], new_cache
