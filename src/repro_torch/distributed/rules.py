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
* ``cummax`` and its backward: the chunked mLSTM's running max, whole
  along the scanned dim (torch 2.11 has no rule);
* ``gather``: never split the gathered dim.  DTensor's own rule keeps a
  gather along a sharded dim as a masked partial sum, which the loss's
  ``[..., 0]`` after its label gather cannot index; whole rows instead;
* ``index_put`` (the backward of the embedding's ``table[tokens]``):
  replicated, since DTensor's own rule fails there on some torch
  versions;
* ``view`` and ``_unsafe_view`` (:func:`_gather_where_uneven`): an
  unflatten of a dim sharded more ways than its leading part has rows
  -- ``(B, T, H * hd)`` to ``(B, T, H, hd)`` when the model axis
  outnumbers the heads -- or a flatten of a sharded inner dim gathers
  that dim first, as ``reshape`` does.  DTensor refuses such a view; K
  and V then come out replicated over the model axis, the usual
  tensor-parallel layout when it exceeds the KV heads.

Attention runs on local shards (:func:`local_attention`): the flash
kernels take raw pointers, and the plain paths' grouping of q heads by
KV head would gather q whole where the model axis splits the groups.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
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


@register_sharding(aten.cummax.default)
def _cummax(x, dim):
    # the chunked mLSTM's running max (torch 2.11 has no rule): whole
    # along the scanned dim, values and indices split alike
    dim %= len(x.shape)
    out = [([R, R], [R, None])]
    out += [([Shard(d), Shard(d)], [Shard(d), None])
            for d in range(len(x.shape)) if d != dim]
    return out


@register_sharding(aten.cummaxmin_backward.default)
def _cummaxmin_backward(grad, x, indices, dim):
    dim %= len(x.shape)
    out = [([R], [R, R, R, None])]
    out += [([Shard(d)], [Shard(d), Shard(d), Shard(d), None])
            for d in range(len(x.shape)) if d != dim]
    return out


@register_sharding([aten.index_put.default, aten.index_put_.default,
                    aten._index_put_impl_.default])
def _index_put(x, indices, values, *rest, **kwargs):
    idx = [R for i in indices if i is not None]
    return [([R], [R, *idx, R, *_extra(rest)])]


def _out_shape(op_schema) -> list:
    """A view's target shape (its ``-1`` resolved)."""
    shape = list(op_schema.args_schema[1])
    if -1 in shape:
        known = 1
        for n in shape:
            known *= n if n != -1 else 1
        numel = 1
        for n in op_schema.args_schema[0].shape:
            numel *= n
        shape[shape.index(-1)] = numel // known
    return shape


def _uneven(strategy, shape, mesh) -> set:
    """The mesh dims of a strategy's output that split a dim unevenly:
    each that shares the dim with another, or all of them where the first
    alone does not divide it (DTensor's view rule can propose such splits
    for a dim sharded over two mesh dims)."""
    bad = set()
    for spec in strategy.strategies:
        by_dim = {}
        for i, p in enumerate(spec.output_specs.placements):
            if p.is_shard():
                by_dim.setdefault(p.dim, []).append(i)
        for d, dims in by_dim.items():
            n = 1
            for i in dims:
                n *= mesh.size(i)
            if shape[d] % n:
                bad.update(dims if shape[d] % mesh.size(dims[0]) else dims[1:])
    return bad


def _replicated_on(op_schema, mesh_dims):
    """``op_schema`` with its input replicated on ``mesh_dims``."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import (OpSchema, OpSpec,
                                                     OpStrategy)

    spec = op_schema.args_schema[0].strategies[0].output_spec
    pl = tuple(R if i in mesh_dims else p
               for i, p in enumerate(spec.placements))
    arg = OpStrategy([OpSpec(DTensorSpec(spec.mesh, pl,
                                         tensor_meta=spec.tensor_meta))])
    return OpSchema(op_schema.op, (arg, *op_schema.args_schema[1:]),
                    op_schema.kwargs_schema, schema_info=op_schema.schema_info)


def _gather_where_uneven(strict: Callable, gathering: Callable) -> Callable:
    """A view's sharding strategy: DTensor's own (``strict``); where that
    refuses a split or a flatten that needs a redistribution,
    ``reshape``'s (``gathering``), which replicates the dim first; and where either
    proposes an output split unevenly, the same with the input
    replicated on the mesh dims at fault.  The view then aliases the
    gathered copy, not its input: the model's views are read, never
    written through."""
    def strategy(op_schema):
        mesh = op_schema.args_schema[0].strategies[0].output_spec.mesh
        shape = _out_shape(op_schema)
        for _ in range(mesh.ndim + 1):
            try:
                out = strict(op_schema)
            except RuntimeError as e:
                # "Cannot unflatten unevenly sharded tensor ... Please
                # redistribute" (torch 2.13); "Attempted to split (or
                # flatten) ... without redistribution" (2.11)
                if "redistribut" not in str(e):
                    raise
                out = gathering(op_schema)
            bad = _uneven(out, shape, mesh)
            if not bad:
                return out
            op_schema = _replicated_on(op_schema, bad)
        raise RuntimeError(f"no even split of {op_schema} over {mesh}")

    return strategy


def _register_view_fallback() -> None:
    prop = DTensor._op_dispatcher.sharding_propagator
    funcs = prop.op_strategy_funcs
    for op in (aten.view.default, aten._unsafe_view.default):
        funcs[op] = _gather_where_uneven(funcs[op],
                                         funcs[aten.reshape.default])
    prop.propagate_op_sharding.cache_clear()


_register_view_fallback()


def local_attention(fn: Callable, q, k, v):
    """``fn(q, k, v)`` -- attention on (B, H, T, d) DTensors -- on each
    rank's local batch rows and heads (``local_map``).  Each mesh dim
    keeps ``q``'s sharding of the batch axis for all three and the
    output; of the head axis, when it divides ``Hq`` and each rank's
    block of q heads lies within the KV heads of a whole block: with
    ``Hkv`` divisible too, k and v are split alike, else they come
    whole and each rank takes the one KV head its q heads share.  Any
    other dim is gathered.  Heads and batch rows are independent, so
    the kernels see whole problems."""
    mesh = q.device_mesh
    B, Hq = q.shape[:2]
    Hkv = k.shape[1]
    q_pl, kv_pl = [], []
    pick = None                  # (mesh dim, ranks a KV head) of a split group
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if isinstance(p, Shard) and p.dim == 0 and B % n == 0:
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 1 and Hq % n == 0 and (
                Hkv % n == 0 or (pick is None and n % Hkv == 0)):
            q_pl.append(Shard(1))
            if Hkv % n == 0:
                kv_pl.append(Shard(1))
            else:
                kv_pl.append(R)
                pick = (i, n // Hkv)
        else:
            q_pl.append(R)
            kv_pl.append(R)
    q_pl, kv_pl = tuple(q_pl), tuple(kv_pl)
    kv_grad = kv_pl
    if pick is None:
        local = fn
    else:
        # this rank's q heads all belong to KV head coord // (n / Hkv);
        # the whole k and v it was given get a gradient in that head
        # only, summed over the ranks of the split
        h = mesh.get_coordinate()[pick[0]] // pick[1]
        kv_grad = tuple(Partial() if i == pick[0] else p
                        for i, p in enumerate(kv_pl))

        def local(q, k, v):
            return fn(q, k[:, h:h + 1], v[:, h:h + 1])

    # one output, given as a 1-tuple so that its placements read alike
    # on every torch version
    return local_map(lambda *a: (local(*a),), out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)[0]
