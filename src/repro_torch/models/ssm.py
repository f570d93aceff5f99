"""State-space and recurrent blocks: the Mamba (S6) mixer of the jamba
hybrid and the xLSTM (sLSTM + mLSTM), the reference's ``models/ssm.py``
step for step.

The recurrences are data-dependent over time.  The reference runs them
with ``lax.scan``; here each scan is a Python loop over the steps (or,
for the chunkwise mLSTM, over the chunks) in eager PyTorch.  A loop
reads its steps as the views of one ``unbind``, whose backward stacks
the steps' gradients once, as the scan does (a ``select`` a step would
write a zero gradient of the whole sequence every step).  A state the
caller does not pass starts as zeros made ``*_like`` a step of the
loop's own input, so that it has that input's rows (and, on sharded
tensors, its layout).  Decode is O(1): the "cache" is the fixed-size
recurrent state.  Every apply returns new states and never writes into
the ones it was given.

Dtypes follow the reference.  Mamba: the projections come out of the
compute dtype, the causal conv sums its taps in float32 and rounds once,
and dt, the gates and the scan's state are float32.  xLSTM: q, k and v
come out of the compute dtype (``k`` is scaled by 1/sqrt(hd) in it), the
gates from float32 products, and the scans carry ``C``, ``n`` and ``m``
in float32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import layers
from .config import ModelConfig

Params = Dict[str, Any]
State = Dict[str, torch.Tensor]

# =============================================================================
# Mamba (S6) -- used by the jamba hybrid
# =============================================================================

def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.mamba.dt_rank or -(-cfg.d_model // 16)


def mamba_init(gen, cfg: ModelConfig, dtype, *, lead: Tuple[int, ...] = (),
               device=None) -> Params:
    m = cfg.mamba
    d = cfg.d_model
    d_in = m.expand * d
    dtr = _dt_rank(cfg)
    kw = dict(lead=lead, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    a = torch.arange(1, m.d_state + 1, **f32).log()
    return {
        "in_proj": layers.dense_init(gen, d, 2 * d_in, dtype, **kw),
        "conv_w": layers._normal(gen, (*lead, m.d_conv, d_in), dtype,
                                 1.0 / math.sqrt(m.d_conv), device),
        "conv_b": torch.zeros((*lead, d_in), dtype=dtype, device=device),
        "x_proj": layers.dense_init(gen, d_in, dtr + 2 * m.d_state, dtype,
                                    **kw),
        "dt_proj": layers.dense_init(gen, dtr, d_in, dtype, bias=True, **kw),
        "A_log": a.expand(*lead, d_in, m.d_state).clone(),
        "D": torch.ones((*lead, d_in), **f32),
        "out_proj": layers.dense_init(
            gen, d_in, d, dtype, **kw,
            scale=1.0 / math.sqrt(d_in * 2 * cfg.n_layers)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x: (B, T, C), w: (K, C).  The K taps
    are summed in ascending order in float32, then the bias, then one
    cast to ``x.dtype``.

    Returns (y, new_state), the state being the last K-1 inputs (rows of
    ``[state, x]``, so also right when T < K-1)."""
    B, T, C = x.shape
    K = w.shape[0]
    if state is None:
        pad = torch.zeros_like(x[:, :1]).expand(B, K - 1, C)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                    # (B, T+K-1, C)
    wf = w.float()
    y = xp[:, 0:T].float() * wf[0]
    for i in range(1, K):
        y = y + xp[:, i:i + T].float() * wf[i]
    y = y + b.float()
    new_state = xp[:, T:].clone()                      # (B, K-1, C)
    return y.to(x.dtype), new_state


def mamba_apply(
    p: Params,
    x: torch.Tensor,                 # (B, T, d)
    cfg: ModelConfig,
    *,
    state: Optional[State] = None,
) -> Tuple[torch.Tensor, Optional[State]]:
    """The selective scan, one step at a time:
    ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t`` and ``y_t = h_t . C_t``
    in float32.  ``exp(dt A)`` and the input term are formed per step, so
    the (B, T, d_in, S) tensor is never built (at jamba's widths it would
    be 2 x 4,096 x 16,384 x 16 x 4 bytes = 8.6 GB a layer); only
    (B, T, d_in) activations leave the loop."""
    m = cfg.mamba
    B, _, d = x.shape
    d_in = m.expand * d
    dtr = _dt_rank(cfg)
    cd = layers.torch_dtype(cfg.compute_dtype)

    xz = layers.dense_apply(p["in_proj"], x, cd)
    xs, z = xz.split(d_in, dim=-1)                     # (B, T, d_in) each

    conv_state = state["conv"] if state is not None else None
    xs, new_conv = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_state)
    xs = F.silu(xs.float()).to(cd)

    dbc = layers.dense_apply(p["x_proj"], xs, cd)
    dt, Bc, Cc = dbc.split([dtr, m.d_state, m.d_state], dim=-1)
    dt = layers.dense_apply(p["dt_proj"], dt, cd)     # (B, T, d_in)
    dt = F.softplus(dt.float())
    A = -torch.exp(p["A_log"])                          # (d_in, S)

    xs_f32 = xs.float()

    def steps(t):  # (B, T, *) -> T contiguous (B, *) views
        # a stack of the steps, not a transposed copy: its gradient is
        # laid out (B, T, *) again, as sharded tensors expect
        return torch.stack(t.unbind(1)).unbind(0)

    dts = steps(dt)
    h = (state["ssm"] if state is not None else
         torch.zeros_like(dts[0])[..., None].expand(
             B, d_in, m.d_state).contiguous())
    ys = []
    for dt_t, dtx_t, B_t, C_t in zip(dts, steps(dt * xs_f32),
                                     steps(Bc.float()), steps(Cc.float())):
        dA = torch.exp(dt_t[..., None] * A)            # (B, d_in, S)
        dBx = dtx_t[..., None] * B_t[:, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bds,bs->bd", h, C_t))
    y = torch.stack(ys, dim=1)                          # (B, T, d_in)
    y = y + p["D"].float() * xs_f32
    y = y * F.silu(z.float())
    out = layers.dense_apply(p["out_proj"], y.to(cd), cd)
    new_state = {"conv": new_conv, "ssm": h} if state is not None else None
    return out.to(x.dtype), new_state


def mamba_init_state(cfg: ModelConfig, batch: int, *, device=None) -> State:
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, m.d_conv - 1, d_in),
                            dtype=layers.torch_dtype(cfg.compute_dtype),
                            device=device),
        "ssm": torch.zeros((batch, d_in, m.d_state), dtype=torch.float32,
                           device=device),
    }


# =============================================================================
# xLSTM: mLSTM (matrix memory) + sLSTM (scalar memory)
# =============================================================================

#: Chunkwise-parallel mLSTM switch (None = exact recurrent scan).  With a
#: chunk width W the matrix memory C is read and written once per chunk
#: instead of once per step; :func:`~.transformer.xlstm_forward` takes the
#: chunked path only for sequences longer than W.
MLSTM_CHUNK = None

#: sLSTM's initial stabilizer: ``exp(f + m - m_new)`` is exactly 0 on the
#: first step from it, whatever the carried c and n hold
SLSTM_M0 = -1e30


def mlstm_init(gen, cfg: ModelConfig, dtype, *, device=None) -> Params:
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    kw = dict(device=device)
    return {
        "wq": layers.dense_init(gen, d, H * hd, dtype, **kw),
        "wk": layers.dense_init(gen, d, H * hd, dtype, **kw),
        "wv": layers.dense_init(gen, d, H * hd, dtype, **kw),
        "wi": layers.dense_init(gen, d, H, dtype, bias=True, **kw),
        "wf": layers.dense_init(gen, d, H, dtype, bias=True, **kw),
        "wo": layers.dense_init(gen, H * hd, d, dtype, **kw,
                                scale=1.0 / math.sqrt(H * hd * 2 * cfg.n_layers)),
    }


@torch.library.custom_op("repro_torch::scan_rows", mutates_args=())
def scan_rows(x: torch.Tensor, free: Optional[int] = None) -> torch.Tensor:
    """A copy of ``x`` (B, ...) for a step loop whose rows step alone: the
    mLSTM's projections and output h, the sLSTM's input.  ``free`` names
    a dim along which the loop's update is elementwise too (the head dim
    of v and h: the columns of the state C).  Where the tensors are
    sharded, the distribution layer (``distributed.rules``) gives each
    rank its own rows of the copy, or its own part of ``free`` where the
    rows do not divide, so that no rank steps the whole state of its
    rows.  Its gradient is this op's copy of the incoming one, placed
    alike."""
    return x.clone()


@scan_rows.register_fake
def _(x, free=None):
    return torch.empty_like(x)


def _scan_rows_context(ctx, inputs, output):
    ctx.free = inputs[1]


scan_rows.register_autograd(lambda ctx, grad: (scan_rows(grad, ctx.free),
                                               None),
                            setup_context=_scan_rows_context)


def _mlstm_qkv_gates(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """q, k, v as (B, T, H, hd) in the compute dtype (k scaled by
    1/sqrt(hd) there) and the float32 gate pre-activations (B, T, H),
    each from :func:`scan_rows` (the products' own layout would leave
    every head whole on each rank where they are fewer than the ranks
    that split the products)."""
    B, T, _ = x.shape
    hd, H = cfg.hd, cfg.n_heads
    cd = layers.torch_dtype(cfg.compute_dtype)

    def proj(name, dtype):
        return scan_rows(layers.dense_apply(p[name], x, dtype))

    q = proj("wq", cd).reshape(B, T, H, hd)
    k = proj("wk", cd).reshape(B, T, H, hd) / math.sqrt(hd)
    v = scan_rows(proj("wv", cd).reshape(B, T, H, hd), 3)
    return q, k, v, proj("wi", torch.float32), proj("wf", torch.float32)


def _mlstm_state(state: Optional[State], k0: torch.Tensor, v0: torch.Tensor,
                 i0: torch.Tensor):
    """``state``'s (C, n, m), or zeros like a step's k and v (B, H, hd)
    and input gate (B, H), as :func:`xlstm_init_state` makes them: C
    (B, H, hd, hd) like v along its columns."""
    if state is None:
        C = torch.zeros_like(v0)[..., None, :].expand(
            *k0.shape, v0.shape[-1]).contiguous()
        return C, torch.zeros_like(k0), torch.zeros_like(i0)
    return state["C"], state["n"], state["m"]


def _mlstm_out(p: Params, h: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[State], C, n, m):
    cd = layers.torch_dtype(cfg.compute_dtype)
    out = layers.dense_apply(p["wo"], h.to(cd), cd)
    new_state = {"C": C, "n": n, "m": m} if state is not None else None
    return out.to(x.dtype), new_state


def mlstm_apply(
    p: Params,
    x: torch.Tensor,                 # (B, T, d)
    cfg: ModelConfig,
    *,
    state: Optional[State] = None,
) -> Tuple[torch.Tensor, Optional[State]]:
    """The exact recurrent mLSTM, one step at a time."""
    B, T, _ = x.shape
    hd, H = cfg.hd, cfg.n_heads
    q, k, v, i_pre, f_pre = _mlstm_qkv_gates(p, x, cfg)
    qs, ks, vs = (t.float().unbind(1) for t in (q, k, v))  # (B, H, hd)
    i_s = i_pre.unbind(1)                                  # (B, H)
    C, n, m = _mlstm_state(state, ks[0], vs[0], i_s[0])
    fs = F.logsigmoid(f_pre)        # log(sigmoid) underflows where this does not
    hs = []
    for qt, kt, vt, it, ft in zip(qs, ks, vs, i_s, fs.unbind(1)):
        fm = ft + m
        m_new = torch.maximum(fm, it)                # stabilizer
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(fm - m_new)
        C = f_g[..., None, None] * C + i_g[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = f_g[..., None] * n + i_g[..., None] * kt
        num = torch.einsum("bhkv,bhk->bhv", C, qt)
        den = torch.einsum("bhk,bhk->bh", n, qt).abs()
        hs.append(num / torch.clamp(den, min=1.0)[..., None])
        m = m_new
    h = scan_rows(torch.stack(hs, dim=1), 3).reshape(B, T, H * hd)
    return _mlstm_out(p, h, x, cfg, state, C, n, m)


class _RunningMax(torch.autograd.Function):
    """``torch.cummax(a, -1).values``, whose gradient is scattered onto
    zeros like the incoming gradient (autograd's ``cummaxmin_backward``
    makes plain zeros of the input's shape, which on a sharded tensor
    is the global one) -- the same sums."""

    @staticmethod
    def forward(ctx, a):
        values, indices = torch.cummax(a, dim=-1)
        ctx.save_for_backward(indices)
        return values

    @staticmethod
    def backward(ctx, grad):
        (indices,) = ctx.saved_tensors
        return torch.zeros_like(grad).scatter_add(-1, indices, grad)


def _mlstm_chunk_body(q, k, v, i_pre, f_log, C, n, m, *, W: int):
    """One chunk of the chunkwise-parallel stabilized mLSTM.

    q/k/v: (B, H, W, hd) f32; i_pre/f_log: (B, H, W); carry (C, n, m).
    Exactly equivalent to W recurrent steps (same stabilizer convention:
    the carried C/n are scaled by exp(-m)).
    """
    Fc = torch.cumsum(f_log, dim=-1)                     # (B,H,W)
    a = i_pre - Fc
    M = torch.maximum(m[..., None], _RunningMax.apply(a))
    # intra-chunk scores with per-(t,s) decay, causal within the chunk
    S = torch.einsum("bhtd,bhsd->bhts", q, k)
    decay = torch.exp(a[..., None, :] - M[..., :, None])  # (B,H,t,s)
    tri = torch.tril(torch.ones((W, W), dtype=torch.bool, device=q.device))
    St = torch.where(tri, S * decay, 0.0)
    num = torch.einsum("bhts,bhsv->bhtv", St, v)
    den = St.sum(dim=-1)                                 # (B,H,t)
    # inter-chunk (previous state) contribution
    inter_w = torch.exp(m[..., None] - M)                # (B,H,t)
    num = num + inter_w[..., None] * torch.einsum("bhkv,bhtk->bhtv", C, q)
    den = den + inter_w * torch.einsum("bhk,bhtk->bht", n, q)
    h = num / torch.clamp(den.abs(), min=1.0)[..., None]
    # end-of-chunk state update (C/n touched ONCE per chunk)
    M_W = M[..., -1]
    F_W = Fc[..., -1]
    w_s = torch.exp(a - M_W[..., None])                  # (B,H,s)
    carry_w = torch.exp(m - M_W)
    C_new = torch.einsum("bhs,bhsk,bhsv->bhkv", w_s, k, v) \
        + carry_w[..., None, None] * C
    n_new = torch.einsum("bhs,bhsk->bhk", w_s, k) + carry_w[..., None] * n
    m_new = F_W + M_W
    return h, (C_new, n_new, m_new)


def mlstm_apply_chunked(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    chunk: int,
    state: Optional[State] = None,
) -> Tuple[torch.Tensor, Optional[State]]:
    """The mLSTM in chunks of ``chunk`` steps; a ``T`` the chunk does not
    divide falls back to the recurrent scan."""
    B, T, _ = x.shape
    hd, H = cfg.hd, cfg.n_heads
    W = chunk
    if T % W:
        return mlstm_apply(p, x, cfg, state=state)  # ragged: fall back
    q, k, v, i_pre, f_pre = _mlstm_qkv_gates(p, x, cfg)
    f_log = F.logsigmoid(f_pre)

    def to_chunks(t):  # (B,T,H,*) -> (n, B, H, W, *)
        t = t.movedim(2, 1)                              # (B,H,T,*)
        t = t.reshape(*t.shape[:2], T // W, W, *t.shape[3:])
        return t.movedim(2, 0).contiguous()

    qs, ks, vs, ii, ff = (to_chunks(t).unbind(0) for t in (
        q.float(), k.float(), v.float(), i_pre, f_log))  # (B, H, W, *)
    C, n, m = _mlstm_state(state, ks[0][:, :, 0], vs[0][:, :, 0],
                           ii[0][:, :, 0])
    hs = []
    for inputs in zip(qs, ks, vs, ii, ff):
        h, (C, n, m) = _mlstm_chunk_body(*inputs, C, n, m, W=W)
        hs.append(h)
    # hs: n x (B, H, W, hd) -> (B, T, H*hd)
    h = torch.stack(hs, dim=2).reshape(B, H, T, hd)
    h = scan_rows(h.movedim(1, 2), 3).reshape(B, T, H * hd)
    return _mlstm_out(p, h, x, cfg, state, C, n, m)


def slstm_init(gen, cfg: ModelConfig, dtype, *, device=None) -> Params:
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    kw = dict(device=device)
    return {
        "wz": layers.dense_init(gen, d, H * hd, dtype, bias=True, **kw),
        "wi": layers.dense_init(gen, d, H * hd, dtype, bias=True, **kw),
        "wf": layers.dense_init(gen, d, H * hd, dtype, bias=True, **kw),
        "wo_gate": layers.dense_init(gen, d, H * hd, dtype, bias=True, **kw),
        "wo": layers.dense_init(gen, H * hd, d, dtype, **kw,
                                scale=1.0 / math.sqrt(H * hd * 2 * cfg.n_layers)),
    }


def slstm_apply(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    state: Optional[State] = None,
) -> Tuple[torch.Tensor, Optional[State]]:
    cd = layers.torch_dtype(cfg.compute_dtype)
    f32 = torch.float32
    x = scan_rows(x)
    z = torch.tanh(layers.dense_apply(p["wz"], x, f32))
    i_pre = layers.dense_apply(p["wi"], x, f32)
    f_pre = F.logsigmoid(layers.dense_apply(p["wf"], x, f32))
    o = torch.sigmoid(layers.dense_apply(p["wo_gate"], x, f32))

    zs = z.unbind(1)                                     # (B, D)
    if state is None:
        c, n = torch.zeros_like(zs[0]), torch.zeros_like(zs[0])
        m = torch.full_like(zs[0], SLSTM_M0)
    else:
        c, n, m = state["c"], state["n"], state["m"]
    hs = []
    for zt, it, ft in zip(zs, i_pre.unbind(1), f_pre.unbind(1)):
        fm = ft + m
        m_new = torch.maximum(fm, it)
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(fm - m_new)
        c = f_g * c + i_g * zt
        n = f_g * n + i_g
        hs.append(c / torch.clamp(n, min=1.0))
        m = m_new
    h = torch.stack(hs, dim=1) * o                       # (B, T, D)
    out = layers.dense_apply(p["wo"], h.to(cd), cd)
    new_state = {"c": c, "n": n, "m": m} if state is not None else None
    return out.to(x.dtype), new_state


def xlstm_block_kind(layer_idx: int, cfg: ModelConfig) -> str:
    every = cfg.xlstm.slstm_every
    return "slstm" if (every > 0 and layer_idx % every == 0) else "mlstm"


def xlstm_init_state(cfg: ModelConfig, batch: int, kind: str, *,
                     device=None) -> State:
    hd, H = cfg.hd, cfg.n_heads
    kw = dict(dtype=torch.float32, device=device)
    if kind == "mlstm":
        return {
            "C": torch.zeros((batch, H, hd, hd), **kw),
            "n": torch.zeros((batch, H, hd), **kw),
            "m": torch.zeros((batch, H), **kw),
        }
    return {
        "c": torch.zeros((batch, H * hd), **kw),
        "n": torch.zeros((batch, H * hd), **kw),
        "m": torch.full((batch, H * hd), SLSTM_M0, **kw),
    }
