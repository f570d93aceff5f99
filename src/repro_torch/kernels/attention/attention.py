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
"""
from __future__ import annotations

import ctypes

import torch

from .ref import (TILE_Q, WGMMA_TILE_Q, check_blocks, check_shapes,
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
    ``flash_attention.launches`` counts kernel launches, and
    ``flash_attention.launches_by_route`` counts them per kernel
    (``"wgmma"``, ``"fma"``)."""
    check_shapes(q, k, v, n_q_heads, n_kv_heads)
    G, Tq, d = q.shape
    Tk = k.shape[1]
    bq, bk = check_blocks(Tq, Tk, block_q, block_k)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k and v lie on different devices: {devices}")
    device = q.device
    kw = dict(n_q_heads=n_q_heads, n_kv_heads=n_kv_heads, causal=causal,
              scale=scale, block_q=block_q, block_k=block_k)
    if device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    if device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {device}")
    from .. import _cuda

    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"q, k and v must share one dtype, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}"
        )
    code = _cuda.dtype_code(q.dtype)
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel supports head dims {HEAD_DIMS}, got {d}")
    kernel = route(q.dtype, d)
    tile_q = WGMMA_TILE_Q if kernel == "wgmma" else TILE_Q
    if -(-Tq // tile_q) > MAX_Q_TILES:
        raise ValueError(f"kernel takes at most {MAX_Q_TILES * tile_q} query "
                         f"rows, got {Tq}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel reads contiguous q, k and v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the kernel reads q, k and v with 16-byte alignment")
    o = torch.empty_like(q)
    if G == 0 or Tq == 0:
        return o
    lib = _cuda.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
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
    return o


flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "fma": 0}
