"""Shared neural-net layers (functional PyTorch, dict params).

Conventions, as in the reference's ``models/layers.py``:
  * params are nested dicts of tensors; leaves use ``cfg.param_dtype``;
  * activations use ``cfg.compute_dtype`` with float32 accumulation on
    matmuls (:func:`~repro_torch.core.precision.matmul_f32`);
  * every ``*_init`` returns params; every apply is a function of its
    inputs, except that a KV cache passed to :func:`attention_apply` is
    updated in place (the reference returns an updated copy; writing in
    place saves a copy of the whole cache per token).

Every ``*_init`` takes a ``torch.Generator`` on the target device and an
optional ``lead`` shape, so one call builds a stack of per-layer params
(the reference stacks blocks with ``jax.vmap``).  With ``device="meta"``
and no generator it only builds shapes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.precision import matmul_f32
from ..kernels.attention import ops as attn_ops
from .config import ModelConfig

Params = Dict[str, Any]

#: When True, matmul partial sums are produced in the compute dtype so
#: cross-shard (TP) reductions move bf16 instead of f32 -- halves the
#: activation-collective bytes at the cost of one extra rounding per
#: reduction.  Set by the dry run (``launch.dryrun --bf16-reduce``), as
#: the reference's flag of the same name.
REDUCE_IN_COMPUTE_DTYPE = False


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (dtypes pass through)."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


# -- initializers -----------------------------------------------------------

def _normal(gen, shape, dtype, scale, device):
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, *, bias: bool = False,
               scale: Optional[float] = None, lead: Tuple[int, ...] = (),
               device=None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(gen, (*lead, d_in, d_out), dtype, scale, device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def matmul_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as :func:`matmul_f32`, or with ``REDUCE_IN_COMPUTE_DTYPE``
    returned in the operands' dtype (float32 accumulation inside the
    product, rounded once at its end)."""
    if REDUCE_IN_COMPUTE_DTYPE:
        return torch.matmul(a, b)
    return matmul_f32(a, b)


def dense_apply(p: Params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x @ w (+ b)``: accumulated in float32 (the product's dtype under
    ``REDUCE_IN_COMPUTE_DTYPE``), bias added in that dtype, then cast to
    the compute dtype."""
    cd = torch_dtype(compute_dtype)
    y = matmul_acc(x.to(cd), p["w"].to(cd))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y.to(cd)


# -- norms --------------------------------------------------------------------

def norm_init(d: int, kind: str, dtype, *, lead: Tuple[int, ...] = (),
              device=None) -> Params:
    p = {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((*lead, d), dtype=dtype, device=device)
    return p


def norm_apply(p: Params, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# -- rotary embeddings --------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, d) with d even; positions: (..., T) integers, or
    dims of 1 where every row shares them (the tables are built at the
    positions' shape and broadcast).  Computed in float32, cast back to
    ``x.dtype``."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].float() * freqs       # (..., T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- attention ----------------------------------------------------------------

def attention_init(gen, cfg: ModelConfig, dtype, *, lead: Tuple[int, ...] = (),
                   device=None) -> Params:
    d, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    kw = dict(lead=lead, device=device)
    p = {
        "wq": dense_init(gen, d, Hq * hd, dtype, bias=cfg.qkv_bias, **kw),
        "wk": dense_init(gen, d, Hkv * hd, dtype, bias=cfg.qkv_bias, **kw),
        "wv": dense_init(gen, d, Hkv * hd, dtype, bias=cfg.qkv_bias, **kw),
        "wo": dense_init(gen, Hq * hd, d, dtype,
                         scale=1.0 / math.sqrt(Hq * hd * 2 * cfg.n_layers),
                         **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(hd, "rmsnorm", dtype, **kw)
        p["k_norm"] = norm_init(hd, "rmsnorm", dtype, **kw)
    return p


def attention_apply(
    p: Params,
    x: torch.Tensor,                  # (B, T, d)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,          # (B, T), or (1, T) for every row
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cross-attn src
    cache: Optional[Dict[str, torch.Tensor]] = None,         # decode KV cache
    cache_index=None,
    causal: bool = True,
    attn_impl: str = "auto",
    block_q: int = 512,
    block_k: int = 512,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self- (or cross-) attention.  Without a cache or ``kv`` it goes
    through :func:`~repro_torch.kernels.attention.ops.multi_head_attention`
    (the flash kernel on the card) at ``block_q``/``block_k`` (the
    reference's 512; only the encoder passes others, see
    :func:`~.transformer.encode`); with a cache or ``kv`` -- prefill,
    decode, cross-attention -- through the plain masked attention of
    :func:`~repro_torch.kernels.attention.ops.cache_attention` and
    :func:`~repro_torch.kernels.attention.ops.masked_attention`, as in
    the reference."""
    B, T, d = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    cd = torch_dtype(cfg.compute_dtype)

    q = dense_apply(p["wq"], x, cd).reshape(B, T, Hq, hd)
    if kv is None:
        k = dense_apply(p["wk"], x, cd).reshape(B, T, Hkv, hd)
        v = dense_apply(p["wv"], x, cd).reshape(B, T, Hkv, hd)
    else:
        src_k, src_v = kv
        Ts = src_k.shape[1]
        k = dense_apply(p["wk"], src_k, cd).reshape(B, Ts, Hkv, hd)
        v = dense_apply(p["wv"], src_v, cd).reshape(B, Ts, Hkv, hd)

    if cfg.qk_norm:
        q = norm_apply(p["q_norm"], q, "rmsnorm", cfg.norm_eps)
        k = norm_apply(p["k_norm"], k, "rmsnorm", cfg.norm_eps)

    if kv is None and cfg.rope_theta > 0:
        q = rope(q.transpose(1, 2), positions[:, None], cfg.rope_theta).transpose(1, 2)
        k = rope(k.transpose(1, 2), positions[:, None], cfg.rope_theta).transpose(1, 2)

    new_cache = None
    if cache is not None:
        # write the new K/V at cache_index (decode: T == 1; prefill: T == n)
        # and attend over the written slots
        o = attn_ops.cache_attention(q, k, v, cache, cache_index,
                                     causal=causal and kv is None)
        new_cache = {"k": cache["k"], "v": cache["v"]}
    elif kv is not None:
        # cross path: plain attention over the whole source
        o = attn_ops.masked_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=False, valid=None, cache_index=None)
    else:
        o = attn_ops.multi_head_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, impl=attn_impl, block_q=block_q, block_k=block_k,
        )
    o = o.transpose(1, 2).reshape(B, T, Hq * hd)
    out = dense_apply(p["wo"], o, cd)
    return out, new_cache


# -- MLP -----------------------------------------------------------------------

def mlp_init(gen, cfg: ModelConfig, dtype, d_ff: Optional[int] = None, *,
             lead: Tuple[int, ...] = (), device=None) -> Params:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    kw = dict(bias=cfg.mlp_bias, lead=lead, device=device)
    down_scale = 1.0 / math.sqrt(ff * 2 * cfg.n_layers)
    if cfg.act == "swiglu":
        return {
            "gate": dense_init(gen, d, ff, dtype, **kw),
            "up": dense_init(gen, d, ff, dtype, **kw),
            "down": dense_init(gen, ff, d, dtype, scale=down_scale, **kw),
        }
    return {
        "up": dense_init(gen, d, ff, dtype, **kw),
        "down": dense_init(gen, ff, d, dtype, scale=down_scale, **kw),
    }


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cd = torch_dtype(cfg.compute_dtype)
    if cfg.act == "swiglu":
        g = dense_apply(p["gate"], x, cd)
        u = dense_apply(p["up"], x, cd)
        h = F.silu(g.float()).to(cd) * u
    else:
        u = dense_apply(p["up"], x, cd)
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(u.float(), approximate="tanh").to(cd)
    return dense_apply(p["down"], h, cd)


# -- embeddings -----------------------------------------------------------------

def embed_init(gen, cfg: ModelConfig, dtype, *, device=None) -> Params:
    return {"tok": _normal(gen, (cfg.vocab, cfg.d_model), dtype, 1.0, device)}


@torch.library.custom_op("repro_torch::embedding", mutates_args=())
def embedding(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` as an op of its own, whose gradient sums into the
    rows as autograd's ``index`` does: the distribution layer gives it a
    rule (a vocab-split table looked up where it lies,
    :mod:`repro_torch.distributed.rules`) that ``index`` cannot take,
    since a rule runs below autograd."""
    return table[tokens]


@embedding.register_fake
def _(table, tokens):
    return table.new_empty((*tokens.shape, *table.shape[1:]))


@torch.library.custom_op("repro_torch::embedding_backward", mutates_args=())
def embedding_backward(grad: torch.Tensor, tokens: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`embedding` with respect to ``table`` (read
    for its shape only): autograd's ``index`` backward."""
    return grad.new_zeros(table.shape).index_put_((tokens,), grad,
                                                  accumulate=True)


@embedding_backward.register_fake
def _(grad, tokens, table):
    return grad.new_empty(table.shape)


def _embedding_context(ctx, inputs, output):
    table, tokens = inputs
    ctx.save_for_backward(tokens, table)


def _embedding_grad(ctx, grad):
    tokens, table = ctx.saved_tensors
    return embedding_backward(grad, tokens, table), None


embedding.register_autograd(_embedding_grad, setup_context=_embedding_context)


def embed_apply(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return embedding(p["tok"], tokens).to(torch_dtype(cfg.compute_dtype))


def unembed_apply(p_embed: Params, p_head: Optional[Params], x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """float32 logits from compute-dtype operands (the tied head reads
    the embedding table transposed)."""
    cd = torch_dtype(cfg.compute_dtype)
    if p_head is None:
        return matmul_f32(x.to(cd), p_embed["tok"].to(cd).t())
    return matmul_f32(x.to(cd), p_head["w"].to(cd))


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe
