"""DTensor sharding rules for the ops of the port's train step that
DTensor has none for, or one that does not fit; registered once, when
this module is imported (:mod:`.sharding` imports it).

A rule lists, for one mesh dim, the placements an op accepts: each entry
is ``(output placements, input placements)``, ``None`` for an argument
that is not a tensor.  DTensor expands the list over every mesh dim and
redistributes the inputs to the cheapest entry; replicating every input
is always one of them, so each rule is exact whatever the placements.

* ``mm.dtype``, ``bmm.dtype``: the card's bfloat16 products accumulated
  in float32 (``core.precision.matmul_f32``) -- the rules of ``mm`` and
  ``bmm``: row-, column-, batch- or contraction-parallel;
* ``searchsorted``: MoE routing (``models.moe``), on whole rows;
* ``log_sigmoid_backward``: the xLSTM's forget gate, elementwise;
* ``gather``: never split the gathered dim.  DTensor's own rule keeps a
  gather along a sharded dim as a masked partial sum, which the loss's
  ``[..., 0]`` after its label gather cannot index; whole rows instead;
* ``index_put`` (the backward of the embedding's ``table[tokens]``):
  replicated, since DTensor's own rule fails there on some torch
  versions.

The flash kernels take raw pointers, so attention runs on local shards
instead (:func:`local_attention`).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (local_map,
                                                   register_sharding)

aten = torch.ops.aten
R = Replicate()


def _extra(rest):
    return [None] * len(rest)


@register_sharding(aten.mm.dtype)
def _mm(a, b, *rest, **kwargs):
    x = _extra(rest)
    return [([R], [R, R, *x]),
            ([Shard(0)], [Shard(0), R, *x]),     # rows of a
            ([Shard(1)], [R, Shard(1), *x]),     # columns of b
            ([Partial()], [Shard(1), Shard(0), *x]),   # the contraction
            ([Partial()], [Partial(), R, *x]),
            ([Partial()], [R, Partial(), *x])]


@register_sharding(aten.bmm.dtype)
def _bmm(a, b, *rest, **kwargs):
    x = _extra(rest)
    return [([R], [R, R, *x]),
            ([Shard(0)], [Shard(0), Shard(0), *x]),     # the batch
            ([Shard(1)], [Shard(1), R, *x]),
            ([Shard(2)], [R, Shard(2), *x]),
            ([Partial()], [Shard(2), Shard(1), *x]),
            ([Partial()], [Partial(), R, *x]),
            ([Partial()], [R, Partial(), *x])]


@register_sharding(aten.searchsorted.Tensor)
def _searchsorted(seq, values, *rest, **kwargs):
    # rows of the sorted sequences and of the values alike, never the
    # searched (last) dim
    x = _extra(rest)
    out = [([R], [R, R, *x])]
    if len(seq.shape) == len(values.shape):
        out += [([Shard(d)], [Shard(d), Shard(d), *x])
                for d in range(len(seq.shape) - 1)]
    return out


@register_sharding(aten.log_sigmoid_backward.default)
def _log_sigmoid_backward(grad, x, buffer):
    # the CPU's buffer is x's shape; the card's is empty (replicated)
    buf = len(buffer.shape) == len(x.shape) and buffer.shape == x.shape
    out = [([R], [R, R, R])]
    out += [([Shard(d)], [Shard(d), Shard(d), Shard(d) if buf else R])
            for d in range(len(x.shape))]
    return out


@register_sharding(aten.gather.default)
def _gather(x, dim, index, *rest, **kwargs):
    dim %= len(x.shape)
    out = [([R], [R, None, R, *_extra(rest)])]
    out += [([Shard(d)], [Shard(d), None, Shard(d), *_extra(rest)])
            for d in range(len(x.shape))
            if d != dim and x.shape[d] == index.shape[d]]
    return out


@register_sharding([aten.index_put.default, aten.index_put_.default,
                    aten._index_put_impl_.default])
def _index_put(x, indices, values, *rest, **kwargs):
    idx = [R for i in indices if i is not None]
    return [([R], [R, *idx, R, *_extra(rest)])]


def local_attention(fn: Callable, q, k, v):
    """``fn(q, k, v)`` -- attention on (B, H, T, d) DTensors -- on each
    rank's local batch rows and heads (``local_map``): each mesh dim keeps
    ``q``'s sharding of the batch axis, or of the head axis when both head
    counts divide it, for all three and the output; any other dim is
    gathered.  Heads and batch rows are independent, so the kernels see
    whole problems."""
    mesh = q.device_mesh
    B, Hq = q.shape[:2]
    Hkv = k.shape[1]
    pl = []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if isinstance(p, Shard) and p.dim == 0 and B % n == 0:
            pl.append(Shard(0))
        elif (isinstance(p, Shard) and p.dim == 1 and Hq % n == 0
              and Hkv % n == 0):
            pl.append(Shard(1))
        else:
            pl.append(R)
    pl = tuple(pl)
    # one output, given as a 1-tuple so that its placements read alike
    # on every torch version
    return local_map(lambda *a: (fn(*a),), out_placements=(pl,),
                     in_placements=(pl, pl, pl), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)[0]
