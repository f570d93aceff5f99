"""Pipeline parallelism (GPipe schedule) over a process group, the port of
the reference's ``repro/distributed/pipeline.py`` (``shard_map`` over a
stage mesh axis, activations moved by ``ppermute``).

Each rank of ``group`` is one stage and keeps only its own slice of the
stacked stage params.  Schedule: M microbatches through S stages in
M + S - 1 ticks.  Every tick, stage 0 takes microbatch t, a later stage
the activation stage i - 1 sent it at tick t - 1 (``isend``/``irecv``,
point to point); the last stage collects outputs, and at the end
broadcasts them to every stage (the reference's final ``psum`` of one
non-zero contribution).  Bubble fraction is (S-1)/(M+S-1).

This module is deliberately generic: it takes any stage function, so
tests drive it with tiny MLPs.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..tree import tree_map


def pipeline_forward(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,                    # (M, mb, ...) microbatched input
    *,
    group=None,
) -> torch.Tensor:
    """Run x through the S stages of ``group`` (default: the default
    group); returns the (M, mb, ...) outputs on every rank.

    ``stage_params`` leaves have a leading stage axis of size S; this
    rank (its rank in ``group`` is its stage) applies
    ``stage_fn(its slice, x)``.  ``x`` need only be right on stage 0."""
    S = dist.get_world_size(group)
    stage = dist.get_rank(group)
    M = x.shape[0]
    params_here = tree_map(lambda a: a[stage], stage_params)
    peer = lambda s: dist.get_global_rank(group, s) if group is not None else s
    out_buf = torch.zeros_like(x) if stage == S - 1 else None
    y, sends = None, []
    for t in range(M + S - 1):
        if not 0 <= t - stage < M:
            continue
        if stage == 0:
            inp = x[t]
        else:
            inp = torch.empty_like(x[0])
            dist.irecv(inp, src=peer(stage - 1), group=group).wait()
        y = stage_fn(params_here, inp).contiguous()
        if stage == S - 1:
            out_buf[t - stage] = y
        else:
            sends.append((dist.isend(y, dst=peer(stage + 1), group=group), y))
    for req, _ in sends:
        req.wait()
    if out_buf is None:
        out_buf = torch.empty(x.shape, dtype=y.dtype if y is not None
                              else x.dtype, device=x.device)
    dist.broadcast(out_buf, src=peer(S - 1), group=group)
    return out_buf


def microbatch(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) -> (n, B/n, ...)"""
    B = x.shape[0]
    if B % n:
        raise ValueError(f"batch {B} not divisible into {n} microbatches")
    return x.reshape((n, B // n) + tuple(x.shape[1:]))


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))
