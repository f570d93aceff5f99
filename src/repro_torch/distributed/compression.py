"""Gradient compression: int8 quantized all-reduce with error feedback, as
the reference's ``repro/distributed/compression.py``.

Cross-node gradient reduction is the bandwidth-constrained collective at
scale; 4x compression there is a standard distributed-optimization
trick.  Design:

  * per-tensor symmetric int8 quantization (scale = max|g| / 127);
  * error feedback: the quantization residual is carried into the next
    step's gradient (Karimireddy et al.), keeping SGD/Adam convergence;
  * the reduce itself runs in int32 to avoid overflow, then dequantizes.

``quantize``, ``dequantize`` and ``compress_with_feedback`` are bit for
bit the reference's: float32 products in the same order, rounding half
to even.  ``compressed_psum`` reduces over a ``torch.distributed``
process group where the reference runs ``pmax``/``psum`` over a mesh
axis inside ``shard_map``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_map, tree_unflatten


def _scale(g: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.max(torch.abs(g)), min=1e-30) / 127.0


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = _scale(g)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor):
    """Returns (q, scale, new_err)."""
    g_corr = g + err
    q, scale = quantize(g_corr)
    new_err = g_corr - dequantize(q, scale)
    return q, scale, new_err


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group=None):
    """int8-quantized mean over the ranks of ``group`` (default: the
    default group) with error feedback; returns ``(mean, new_err)``.

    Scales are max-reduced first so every rank uses a common scale; the
    int reduce then runs losslessly in int32."""
    g_corr = g + err
    scale = _scale(g_corr)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(g_corr / scale), -127, 127).to(torch.int8)
    new_err = g_corr - q.to(torch.float32) * scale
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32)
    mean = total.to(torch.float32) * scale / n.to(total.device)
    return mean.to(g.dtype), new_err


def tree_compressed_psum(grads: Any, errs: Any, group=None):
    flat_g, flat_e = tree_leaves(grads), tree_leaves(errs)
    out_g, out_e = [], []
    for g, e in zip(flat_g, flat_e):
        m, ne = compressed_psum(g, e, group)
        out_g.append(m)
        out_e.append(ne)
    return tree_unflatten(grads, out_g), tree_unflatten(grads, out_e)


def init_error_feedback(grads_like: Any) -> Any:
    """float32 zeros shaped like every leaf of ``grads_like``."""
    return tree_map(lambda s: torch.zeros(tuple(s.shape), dtype=torch.float32,
                                          device=getattr(s, "device", None)),
                    grads_like)
