"""Flash attention with GQA and causal masking: the CUDA kernel's wrapper.

:func:`flash_attention` is the port of the reference's
``flash_attention_pallas`` (``repro/kernels/attention/attention.py``).
On CUDA tensors it launches ``csrc/flash_attention.cu`` (one CTA per
query head and tile of 64 rows, K/V tiles staged in shared memory, an
online softmax in float32) or raises; on CPU tensors it runs
:func:`~.ref.flash_attention_plain`, which repeats the kernel's
arithmetic.  Layout is head-folded: q ``(G, Tq, d)`` with ``G = batch *
n_q_heads``, k and v ``(Gkv, Tk, d)``; query head ``g`` reads KV head
``(g // Hq) * Hkv + (g % Hq) // (Hq / Hkv)``.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import TILE_Q, check_blocks, check_shapes, flash_attention_plain

#: head dims the kernel is instantiated for
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
    (the reference's rule, else ``ValueError``), but the kernel's own
    tiles do not depend on the blocks.  ``flash_attention.launches``
    counts kernel launches."""
    check_shapes(q, k, v, n_q_heads, n_kv_heads)
    G, Tq, d = q.shape
    Tk = k.shape[1]
    check_blocks(Tq, Tk, block_q, block_k)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k and v lie on different devices: {devices}")
    device = q.device
    kw = dict(n_q_heads=n_q_heads, n_kv_heads=n_kv_heads, causal=causal,
              scale=scale)
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
    if -(-Tq // TILE_Q) > MAX_Q_TILES:
        raise ValueError(f"kernel takes at most {MAX_Q_TILES * TILE_Q} query "
                         f"rows, got {Tq}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel reads contiguous q, k and v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the kernel reads q, k and v with 16-byte alignment")
    o = torch.empty_like(q)
    if G == 0 or Tq == 0:
        return o
    err = _cuda.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        G, Tq, Tk, d, n_q_heads, n_kv_heads, int(causal),
        ctypes.c_float(scale), code, _cuda.stream_handle(device),
    )
    _cuda.check(err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
