"""Decoder-only transformer (dense / MoE / VLM families), the
encoder-decoder (whisper) and the xLSTM stack.

Block params are stacked along a leading ``n_layers`` axis, as the
reference stacks them with ``jax.vmap``; :func:`_scan_blocks` is a Python
loop over the layers in place of ``lax.scan``.  The encoder-decoder's
``enc_blocks`` and ``dec_blocks`` and the xLSTM's ``blocks`` stay lists
of per-layer dicts, as in the reference (the xLSTM's ``core`` keys
differ between its sLSTM and mLSTM layers).

``cfg.remat == "block"`` recomputes each block in the backward
(:func:`remat`, ``torch.utils.checkpoint``) at the reference's four
places of ``jax.checkpoint``: the decoder's scan body, the encoder's and
the decoder's blocks of the encoder-decoder, and the hybrid's period.
It applies only while autograd records a block's inputs (training); a
forward under ``torch.no_grad`` or on params that need no gradient runs
the blocks directly, and the outputs are bitwise the same either way.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..tree import tree_leaves
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


def _unstack(tree, n: int) -> List[Any]:
    """The ``n`` layers of a stacked param tree, each leaf taken apart by
    one ``torch.unbind`` (views): under autograd the layers' gradients
    are stacked back once, where selecting ``tree[i]`` layer by layer
    would build a full-size zero gradient of the leaf for every layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree))


def remat(cfg: ModelConfig, fn: Callable) -> Callable:
    """``fn`` recomputed in the backward when ``cfg.remat == "block"`` and
    autograd records a tensor argument (``torch.utils.checkpoint``,
    non-reentrant), the counterpart of the reference's
    ``jax.checkpoint``; else ``fn`` itself."""
    if cfg.remat != "block":
        return fn

    def wrapped(*args, **kwargs):
        if torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad
                for t in tree_leaves(args)):
            return torch.utils.checkpoint.checkpoint(
                fn, *args, use_reentrant=False, **kwargs)
        return fn(*args, **kwargs)

    return wrapped


def _scan_blocks(params_blocks, x, cfg, *, positions, attn_impl,
                 moe_capacity=None, caches=None, cache_index=None):
    """The blocks in order over stacked params (and stacked caches, which
    are written in place, if serving).  Without caches each block is
    :func:`remat`'s (recomputed in the backward at ``remat="block"``)."""
    layers_p = _unstack(params_blocks, cfg.n_layers)
    if caches is None:
        body = remat(cfg, functools.partial(
            block_apply, cfg=cfg, positions=positions, attn_impl=attn_impl,
            moe_capacity=moe_capacity))
        for bp in layers_p:
            x, _ = body(bp, x)
        return x, None
    for i, bp in enumerate(layers_p):
        x, _ = block_apply(
            bp, x, cfg, positions=positions, cache=_layer(caches, i),
            cache_index=cache_index, attn_impl=attn_impl,
            moe_capacity=moe_capacity,
        )
    return x, caches


def _positions(T: int, device) -> torch.Tensor:
    """The positions ``0 .. T-1`` of a cache-less or from-zero call, (1,
    T): every row's are the same, so RoPE builds its tables once and
    broadcasts them over the rows (one table, not one a row of the
    global batch on every rank of a sharded step)."""
    return torch.arange(T, device=device)[None]


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
    T = tokens.shape[1]
    x = layers.embed_apply(params["embed"], tokens, cfg)
    x, _ = _scan_blocks(
        params["blocks"], x, cfg, positions=_positions(T, x.device),
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
    T = tokens.shape[1]
    x = layers.embed_apply(params["embed"], tokens, cfg)
    x, new_caches = _scan_blocks(
        params["blocks"], x, cfg, positions=_positions(T, x.device),
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
# Encoder-decoder (whisper backbone; the conv frontend stubbed, as in the
# reference: frames arrive as d_model embeddings)
# =============================================================================

def encdec_init(cfg: ModelConfig, generator: Optional[torch.Generator], *,
                device=None) -> Params:
    """Random params from ``generator`` (on ``device``); with
    ``device="meta"`` and no generator, only the shapes and dtypes."""
    dtype = layers.torch_dtype(cfg.param_dtype)
    kw = dict(device=device)

    def enc_block():
        return {
            "ln1": layers.norm_init(cfg.d_model, cfg.norm, dtype, **kw),
            "attn": layers.attention_init(generator, cfg, dtype, **kw),
            "ln2": layers.norm_init(cfg.d_model, cfg.norm, dtype, **kw),
            "mlp": layers.mlp_init(generator, cfg, dtype, **kw),
        }

    def dec_block():
        return {
            "ln1": layers.norm_init(cfg.d_model, cfg.norm, dtype, **kw),
            "self_attn": layers.attention_init(generator, cfg, dtype, **kw),
            "ln_x": layers.norm_init(cfg.d_model, cfg.norm, dtype, **kw),
            "cross_attn": layers.attention_init(generator, cfg, dtype, **kw),
            "ln2": layers.norm_init(cfg.d_model, cfg.norm, dtype, **kw),
            "mlp": layers.mlp_init(generator, cfg, dtype, **kw),
        }

    return {
        "embed": layers.embed_init(generator, cfg, dtype, **kw),
        "enc_blocks": [enc_block() for _ in range(cfg.n_encoder_layers)],
        "dec_blocks": [dec_block() for _ in range(cfg.n_layers)],
        "ln_enc": layers.norm_init(cfg.d_model, cfg.norm, dtype, **kw),
        "ln_f": layers.norm_init(cfg.d_model, cfg.norm, dtype, **kw),
    }


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig, *,
           attn_impl: str = "auto") -> torch.Tensor:
    """frames: (B, n_frames, d_model) -- precomputed stub embeddings.

    The self-attention is non-causal at one block the length of the
    frame axis, ``block_q = block_k = n_frames``: the reference's default
    512-row blocks do not divide whisper's 1,500 frames, so its kernel
    refuses them, and no multiple of 8 divides 1,500.  Without causality
    every row sees all keys whatever the blocks, so this changes nothing
    that is computed (ROADMAP fault 13)."""
    Tf = frames.shape[1]
    cd = layers.torch_dtype(cfg.compute_dtype)
    pe = layers.sinusoidal_positions(Tf, cfg.d_model, device=frames.device)
    x = frames.to(cd) + pe.to(cd)[None]
    positions = _positions(Tf, x.device)

    def enc_block(bp, x):
        h = layers.norm_apply(bp["ln1"], x, cfg.norm, cfg.norm_eps)
        a, _ = layers.attention_apply(
            bp["attn"], h, cfg, positions=positions, causal=False,
            attn_impl=attn_impl, block_q=Tf, block_k=Tf,
        )
        x = x + a
        h = layers.norm_apply(bp["ln2"], x, cfg.norm, cfg.norm_eps)
        return x + layers.mlp_apply(bp["mlp"], h, cfg)

    enc_block = remat(cfg, enc_block)
    for bp in params["enc_blocks"]:
        x = enc_block(bp, x)
    return layers.norm_apply(params["ln_enc"], x, cfg.norm, cfg.norm_eps)


def _dec_embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
               n_positions: int, start: int = 0) -> torch.Tensor:
    """Token embeddings plus the sinusoidal positions ``[start, start +
    T)`` of a table of ``n_positions`` rows."""
    x = layers.embed_apply(params["embed"], tokens, cfg)
    pe = layers.sinusoidal_positions(n_positions, cfg.d_model,
                                     device=x.device).to(x.dtype)
    return x + pe[start:start + tokens.shape[1]][None]


def _dec_block(bp: Params, x, enc, cfg: ModelConfig, *, positions,
               attn_impl: str, cache=None, cache_index=None):
    """One decoder block: causal self-attention (through the cache, which
    is written in place, if one is given), cross-attention on the encoder
    output, MLP.  Returns ``(x, new self-attention cache)``."""
    h = layers.norm_apply(bp["ln1"], x, cfg.norm, cfg.norm_eps)
    a, new_cache = layers.attention_apply(
        bp["self_attn"], h, cfg, positions=positions, cache=cache,
        cache_index=cache_index, causal=True, attn_impl=attn_impl,
    )
    x = x + a
    h = layers.norm_apply(bp["ln_x"], x, cfg.norm, cfg.norm_eps)
    a, _ = layers.attention_apply(
        bp["cross_attn"], h, cfg, positions=positions, kv=(enc, enc),
        causal=False, attn_impl=attn_impl,
    )
    x = x + a
    h = layers.norm_apply(bp["ln2"], x, cfg.norm, cfg.norm_eps)
    return x + layers.mlp_apply(bp["mlp"], h, cfg), new_cache


def encdec_forward(
    params: Params,
    frames: torch.Tensor,               # (B, n_frames, d_model)
    tokens: torch.Tensor,               # (B, T)
    cfg: ModelConfig,
    *,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """float32 logits (B, T, V).  The encoder's and the decoder's
    self-attention go through the flash kernel on the card (one launch
    a layer each); cross-attention takes the masked plain path, as in
    the reference."""
    enc = encode(params, frames, cfg, attn_impl=attn_impl)
    T = tokens.shape[1]
    x = _dec_embed(params, tokens, cfg, T)
    positions = _positions(T, x.device)
    dec_block = remat(cfg, functools.partial(
        _dec_block, cfg=cfg, positions=positions, attn_impl=attn_impl))
    for bp in params["dec_blocks"]:
        x, _ = dec_block(bp, x, enc)
    x = layers.norm_apply(params["ln_f"], x, cfg.norm, cfg.norm_eps)
    return layers.unembed_apply(params["embed"], None, x, cfg)


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      device=None) -> Params:
    """``{"self": [{"k", "v"}] a decoder layer, "enc"}`` in the compute
    dtype, zeros.  Each layer gets tensors of its own: prefill and decode
    write k and v in place (the reference copies one dict of immutable
    arrays into every layer)."""
    dt = layers.torch_dtype(cfg.compute_dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)

    def zeros(*s):
        return torch.zeros(s, dtype=dt, device=device)

    return {
        "self": [{"k": zeros(*shape), "v": zeros(*shape)}
                 for _ in range(cfg.n_layers)],
        # encoder output buffer; replaced at prefill
        "enc": zeros(batch, cfg.n_audio_frames, cfg.d_model),
    }


def encdec_prefill(params, frames, tokens, cache, cfg, *,
                   attn_impl: str = "auto"):
    """Encode ``frames`` (through the flash kernel on the card, at
    ``attn_impl``), then run the prompt through the decoder on the cache
    path.  Returns (last-position logits, a new cache dict holding the
    encoder output under ``"enc"`` and the self-attention caches it was
    given, written in place)."""
    enc = encode(params, frames, cfg, attn_impl=attn_impl)
    cache = dict(cache)
    cache["enc"] = enc
    T = tokens.shape[1]
    x = _dec_embed(params, tokens, cfg, T)
    positions = _positions(T, x.device)
    new_self = []
    for bp, c in zip(params["dec_blocks"], cache["self"]):
        x, nc = _dec_block(bp, x, enc, cfg, positions=positions,
                           attn_impl="xla", cache=c, cache_index=0)
        new_self.append(nc)
    x = layers.norm_apply(params["ln_f"], x, cfg.norm, cfg.norm_eps)
    logits = layers.unembed_apply(params["embed"], None, x[:, -1:], cfg)
    cache["self"] = new_self
    return logits[:, 0], cache


def encdec_decode_step(params, token, cache, cache_index, cfg):
    """One token a sequence at the scalar ``cache_index`` (an int or a 0-d
    tensor).  The cross-attention's K and V are computed again from
    ``cache["enc"]`` every step, as in the reference."""
    if isinstance(cache_index, torch.Tensor) and cache_index.dim():
        raise ValueError(
            "the encoder-decoder decodes at one scalar cache_index, got "
            f"shape {tuple(cache_index.shape)}")
    idx = int(cache_index)
    B = token.shape[0]
    Tmax = cache["self"][0]["k"].shape[1]
    # dynamic_slice_in_dim semantics: the start is clamped into the table
    x = _dec_embed(params, token[:, None], cfg, Tmax,
                   start=min(max(idx, 0), Tmax - 1))
    positions = torch.full((B, 1), idx, device=x.device)
    new_self = []
    for bp, c in zip(params["dec_blocks"], cache["self"]):
        x, nc = _dec_block(bp, x, cache["enc"], cfg, positions=positions,
                           attn_impl="xla", cache=c, cache_index=idx)
        new_self.append(nc)
    x = layers.norm_apply(params["ln_f"], x, cfg.norm, cfg.norm_eps)
    logits = layers.unembed_apply(params["embed"], None, x, cfg)
    new_cache = dict(cache)
    new_cache["self"] = new_self
    return logits[:, 0], new_cache


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
