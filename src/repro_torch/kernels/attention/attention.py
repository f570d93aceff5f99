"""Flash attention with GQA and causal masking: the CUDA kernels' wrapper.

:func:`flash_attention` is the port of the reference's
``flash_attention_pallas`` (``repro/kernels/attention/attention.py``).
On CUDA tensors it launches one of two kernels, chosen by storage dtype
and head dim (:func:`~.ref.route`), or raises:

* ``"wgmma"``: bfloat16 at head dims 64 and 128 ->
  ``csrc/flash_attention_sm90.cu`` (tensor cores: TMA loads into a
  shared-memory ring, one producer and two consumer warpgroups; ``p`` is
  rounded to bfloat16 for the PV product);
* ``"fma"``: float32, and bfloat16 at head dims 16 and 32 ->
  ``csrc/flash_attention.cu`` (CUDA cores, ``p`` kept in float32).

On CPU tensors it runs :func:`~.ref.flash_attention_plain`, which
repeats the arithmetic of the kernel the route names.  Both follow the
reference's visit rule per row: a row sees the keys below its ``K_lim``,
a function of the row and the caller's ``block_q``/``block_k``
(``ref.py``), so rows that see no key (causal, ``Tq > Tk``) come out as
the reference's do.  Layout is head-folded: q ``(G, Tq, d)`` with ``G =
batch * n_q_heads``, k and v ``(Gkv, Tk, d)``; query head ``g`` reads KV
head ``(g // Hq) * Hkv + (g % Hq) // (Hq / Hkv)``.

:func:`flash_attention` is differentiable.  When an input requires a
gradient, the forward kernel also writes each row's log-sum-exp, and
the backward runs :func:`flash_attention_bwd` (the counterpart of the
reference's ``_flash_bwd`` in ``xla_flash.py``, since its Pallas kernel
has no derivative), by the same routes: ``"wgmma"`` ->
``csrc/flash_attention_bwd_sm90.cu`` (tensor cores; ``p`` and ``ds``
rounded to bfloat16 as product operands), ``"fma"`` ->
``csrc/flash_attention_bwd.cu`` (CUDA cores, float32); on CPU tensors
:func:`~.ref.flash_attention_bwd_plain`.  Nothing falls back: a build or
launch failure raises.

The launches are PyTorch ops, ``torch.ops.repro_torch.flash_fwd`` and
``torch.ops.repro_torch.flash_bwd`` (``torch.library.custom_op``): on
CUDA tensors each runs the ctypes launch above; on ``meta`` tensors its
fake returns the outputs' shapes and dtypes, so that the dry run
(``launch.dryrun``) can build and count the kernel path a card trains;
any other device raises.  A dispatch mode sees each launch as one op
(``launch.dryrun.FLOP_FORMULAS`` counts its work).
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor
from torch.distributed.tensor import DTensor

from .ref import (TILE_Q, WGMMA_BWD_ROWS, WGMMA_TILE_Q, check_blocks,
                  check_shapes, flash_attention_bwd_plain,
                  flash_attention_plain, route)

#: head dims the kernels are instantiated for (the fma kernel takes all)
HEAD_DIMS = (16, 32, 64, 128)
#: most query tiles one launch takes (the grid's y dimension)
MAX_Q_TILES = 65_535


def flash_attention(
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
    """Head-folded GQA attention; output in ``q.dtype``.

    ``scale`` defaults to ``1/sqrt(d)``; ``min(block, T)`` must divide T
    (the reference's rule, else ``ValueError``).  The blocks set each
    row's key limit, as in the reference, never the kernel's own tiles.
    ``flash_attention.launches`` counts forward kernel launches, and
    ``flash_attention.launches_by_route`` counts them per kernel
    (``"wgmma"``, ``"fma"``)."""
    return _Flash.apply(q, k, v, n_q_heads, n_kv_heads, causal, scale,
                        block_q, block_k, False)


def flash_attention_interpret(q, k, v, *, n_q_heads: int, n_kv_heads: int,
                              causal: bool = True, scale: float | None = None,
                              block_q: int = 512, block_k: int = 512):
    """:func:`flash_attention` through the plain versions on any device:
    :func:`~.ref.flash_attention_plain` forward and
    :func:`~.ref.flash_attention_bwd_plain` backward (``impl="interpret"``)."""
    return _Flash.apply(q, k, v, n_q_heads, n_kv_heads, causal, scale,
                        block_q, block_k, True)


class _Flash(torch.autograd.Function):
    """The kernels' forward and backward as one differentiable op; the
    residuals are ``(q, k, v, o, lse)``, as the reference's custom VJP
    keeps them."""

    @staticmethod
    def forward(ctx, q, k, v, n_q_heads, n_kv_heads, causal, scale, block_q,
                block_k, plain):
        check_shapes(q, k, v, n_q_heads, n_kv_heads)
        if scale is None:
            scale = 1.0 / (q.shape[2] ** 0.5)
        kw = dict(n_q_heads=n_q_heads, n_kv_heads=n_kv_heads, causal=causal,
                  scale=scale)
        grad = any(ctx.needs_input_grad[:3])
        if plain or q.device.type == "cpu":
            out = flash_attention_plain(q, k, v, block_q=block_q,
                                        block_k=block_k, return_lse=grad,
                                        **kw)
            o, lse = out if grad else (out, None)
        else:
            o, lse = torch.ops.repro_torch.flash_fwd(
                q, k, v, n_q_heads, n_kv_heads, causal, scale, block_q,
                block_k, grad)
            lse = lse if grad else None
        if grad:
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.kw, ctx.plain = kw, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def _check_launch(q, *tensors) -> None:
    """What every kernel launch needs of its tensors: one CUDA device,
    one dtype, contiguous and 16-byte aligned."""
    _check_tensors(q, *tensors)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")


def _check_tensors(q, *tensors) -> None:
    """:func:`_check_launch` but the device type: local tensors (a DTensor
    is refused: a sharded caller runs the kernels on its local shards,
    ``distributed.rules.local_attention``), one device, one dtype, contiguous
    and 16-byte aligned."""
    if any(isinstance(t, DTensor) for t in (q, *tensors)):
        raise TypeError("the flash kernels take local tensors, not DTensors")
    devices = {t.device for t in (q, *tensors)}
    if len(devices) != 1:
        raise ValueError(f"the tensors lie on different devices: {devices}")
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError(
            "q, k, v (and o, do) must share one dtype, got "
            + ", ".join(str(t.dtype) for t in (q, *tensors)))
    if not all(t.is_contiguous() for t in (q, *tensors)):
        raise ValueError("the kernel reads contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, *tensors)):
        raise ValueError("the kernel reads tensors with 16-byte alignment")


def _forward_kernel(q, k, v, *, n_q_heads, n_kv_heads, causal, scale,
                    block_q, block_k, with_lse):
    """Launch the forward kernel of :func:`~.ref.route`; returns ``(o,
    lse)``, ``lse`` None unless ``with_lse``."""
    G, Tq, d = q.shape
    Tk = k.shape[1]
    bq, bk = check_blocks(Tq, Tk, block_q, block_k)
    device = q.device
    _check_launch(q, k, v)
    from .. import _cuda

    code = _cuda.dtype_code(q.dtype)
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel supports head dims {HEAD_DIMS}, got {d}")
    kernel = route(q.dtype, d)
    tile_q = WGMMA_TILE_Q if kernel == "wgmma" else TILE_Q
    if -(-Tq // tile_q) > MAX_Q_TILES:
        raise ValueError(f"kernel takes at most {MAX_Q_TILES * tile_q} query "
                         f"rows, got {Tq}")
    o = torch.empty_like(q)
    lse = (torch.empty(G, Tq, dtype=torch.float32, device=device)
           if with_lse else None)
    if G == 0 or Tq == 0:
        return o, lse
    lib = _cuda.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            G, Tq, Tk, d, n_q_heads, n_kv_heads, int(causal),
            ctypes.c_float(scale), bq, bk)
    with _cuda.launch_on(device) as stream:
        if kernel == "wgmma":
            err = lib.repro_flash_attention_sm90(*args, stream)
        else:
            err = lib.repro_flash_attention(*args, code, stream)
    _cuda.check(err, f"flash_attention ({kernel})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[kernel] += 1
    return o, lse


flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "fma": 0}


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def _flash_fwd(q: Tensor, k: Tensor, v: Tensor, n_q_heads: int,
               n_kv_heads: int, causal: bool, scale: float, block_q: int,
               block_k: int, with_lse: bool) -> tuple[Tensor, Tensor]:
    """:func:`_forward_kernel` as an op: ``(o, lse)``, ``lse`` empty
    unless ``with_lse`` (an op returns tensors only)."""
    o, lse = _forward_kernel(q, k, v, n_q_heads=n_q_heads,
                             n_kv_heads=n_kv_heads, causal=causal,
                             scale=scale, block_q=block_q, block_k=block_k,
                             with_lse=with_lse)
    return o, q.new_empty(0, dtype=torch.float32) if lse is None else lse


@_flash_fwd.register_fake
def _(q, k, v, n_q_heads, n_kv_heads, causal, scale, block_q, block_k,
      with_lse):
    check_shapes(q, k, v, n_q_heads, n_kv_heads)
    check_blocks(q.shape[1], k.shape[1], block_q, block_k)
    rows = q.shape[:2] if with_lse else (0,)
    return torch.empty_like(q), q.new_empty(rows, dtype=torch.float32)


def flash_attention_bwd(
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
    """``(dq, dk, dv)`` of :func:`flash_attention` from its residuals
    ``(q, k, v, o, lse)`` and the output's gradient ``do``; ``Tq <= Tk``.

    On CUDA tensors it launches the kernels of the route
    :func:`bwd_route` names -- a rowsum pass, a dk/dv kernel over (KV
    head, key tile) and a dq kernel over (query head, query tile), with
    no atomics, so the result is bitwise fixed: ``"wgmma"`` (bfloat16 at
    head dims 64 and 128) -> ``csrc/flash_attention_bwd_sm90.cu``,
    ``"fma"`` (float32 at 16/32/64/128, bfloat16 at 16 and 32) ->
    ``csrc/flash_attention_bwd.cu`` -- and adds one to
    ``flash_attention_bwd.launches`` and to its route's count in
    ``flash_attention_bwd.launches_by_route`` a call (through the op
    ``repro_torch::flash_bwd``, whose ``meta`` fake returns the three
    gradients' shapes); on CPU tensors it runs
    :func:`~.ref.flash_attention_bwd_plain`."""
    check_shapes(q, k, v, n_q_heads, n_kv_heads)
    if scale is None:
        scale = 1.0 / (q.shape[2] ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, o, lse, do, n_q_heads=n_q_heads, n_kv_heads=n_kv_heads,
            causal=causal, scale=scale)
    return torch.ops.repro_torch.flash_bwd(q, k, v, o, lse, do, n_q_heads,
                                           n_kv_heads, causal, scale)


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=())
def _flash_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
               do: Tensor, n_q_heads: int, n_kv_heads: int, causal: bool,
               scale: float) -> tuple[Tensor, Tensor, Tensor]:
    """:func:`_backward_kernel` as an op: ``(dq, dk, dv)``."""
    return _backward_kernel(q, k, v, o, lse, do, n_q_heads=n_q_heads,
                            n_kv_heads=n_kv_heads, causal=causal,
                            scale=scale)


@_flash_bwd.register_fake
def _(q, k, v, o, lse, do, n_q_heads, n_kv_heads, causal, scale):
    _bwd_shapes(q, k, v, o, lse, do, n_q_heads, n_kv_heads)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _backward_kernel(q, k, v, o, lse, do, *, n_q_heads, n_kv_heads, causal,
                     scale):
    """Launch the backward kernels of :func:`bwd_route` (see
    :func:`flash_attention_bwd`); returns ``(dq, dk, dv)``."""
    G, Tq, d = q.shape
    Tk = k.shape[1]
    kernel = bwd_route(q, k, v, o, lse, do, n_q_heads=n_q_heads,
                       n_kv_heads=n_kv_heads)
    device = q.device
    _check_launch(q)   # the rest of the tensors: bwd_route
    from .. import _cuda

    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if G == 0 or Tq == 0:
        return dq, dk.zero_(), dv.zero_()
    lib = _cuda.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr())
    tail = (G, Tq, Tk, d, n_q_heads, n_kv_heads, int(causal),
            ctypes.c_float(scale))
    with _cuda.launch_on(device) as stream:
        if kernel == "wgmma":
            # D and a copy of lse, each head's rows padded to the ring tile
            t_pad = -(-Tq // WGMMA_BWD_ROWS) * WGMMA_BWD_ROWS
            ws = torch.empty(2, G, t_pad, dtype=torch.float32, device=device)
            err = lib.repro_flash_attention_bwd_sm90(*args, ws.data_ptr(),
                                                     *tail, stream)
        else:
            delta = torch.empty(G, Tq, dtype=torch.float32, device=device)
            err = lib.repro_flash_attention_bwd(
                *args, delta.data_ptr(), *tail, _cuda.dtype_code(q.dtype),
                stream)
    _cuda.check(err, f"flash_attention_bwd ({kernel})")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route[kernel] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = {"wgmma": 0, "fma": 0}


def bwd_route(q, k, v, o, lse, do, *, n_q_heads: int, n_kv_heads: int) -> str:
    """The backward kernel that takes these tensors: ``"wgmma"`` or
    ``"fma"`` (:func:`~.ref.route` of their dtype and head dim).  Raises
    on what neither takes -- ``Tq > Tk``, ``o``/``do``/``lse`` that do not
    match ``q``, mixed devices or dtypes, strided or unaligned tensors,
    a dtype or head dim no kernel is built for, more key tiles than a
    grid holds -- and so before anything is launched; the device type is
    the launch's own check."""
    _bwd_shapes(q, k, v, o, lse, do, n_q_heads, n_kv_heads)
    _check_tensors(q, k, v, o, do)
    d = q.shape[2]
    Tk = k.shape[1]
    from .. import _cuda

    _cuda.dtype_code(q.dtype)
    if lse.dtype != torch.float32 or not lse.is_contiguous() or (
            lse.device != q.device):
        raise ValueError("lse must be contiguous float32 on the tensors' card")
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel supports head dims {HEAD_DIMS}, got {d}")
    kernel = route(q.dtype, d)
    tile = WGMMA_TILE_Q if kernel == "wgmma" else TILE_Q
    if -(-Tk // tile) > MAX_Q_TILES:   # Tq <= Tk
        raise ValueError(f"kernel takes at most {MAX_Q_TILES * tile} rows")
    return kernel


def _bwd_shapes(q, k, v, o, lse, do, n_q_heads: int, n_kv_heads: int) -> None:
    """The backward's shape rules: :func:`~.ref.check_shapes`, ``Tq <=
    Tk``, ``o`` and ``do`` shaped as ``q``, ``lse`` ``(G, Tq)``."""
    check_shapes(q, k, v, n_q_heads, n_kv_heads)
    G, Tq, _ = q.shape
    Tk = k.shape[1]
    if Tq > Tk:
        raise ValueError(f"the backward takes Tq <= Tk, got Tq={Tq} > Tk={Tk}")
    if o.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != (G, Tq):
        raise ValueError(
            f"o {tuple(o.shape)}, do {tuple(do.shape)} and lse "
            f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
