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
  along the scanned dim (torch 2.11 has no rule); ``flip`` (a cumsum's
  backward there), whole along the flipped dims;
* ``gather``: never split the gathered dim.  DTensor's own rule keeps a
  gather along a sharded dim as a masked partial sum, which the loss's
  ``[..., 0]`` after its label gather cannot index; whole rows instead;
* ``index.Tensor`` (the embedding's ``table[tokens]``): the table
  whole, the tokens whole or split on their own dims (:func:`_index`):
  torch 2.11's own rule fails where the table is vocab-sharded over
  ``model`` and the tokens over ``pod`` and ``data`` (the multi-pod
  mesh), so the port's rule serves every version;
* ``index_put`` (the backward of the embedding's ``table[tokens]``):
  replicated, since DTensor's own rule fails there on some torch
  versions;
* ``view`` and ``_unsafe_view`` (:func:`_gather_where_uneven`): an
  unflatten of a dim sharded more ways than its leading part has rows
  -- ``(B, T, H * hd)`` to ``(B, T, H, hd)`` when the model axis
  outnumbers the heads -- or a flatten of a sharded inner dim gathers
  that dim first, as ``reshape`` does.  DTensor refuses such a view; K
  and V then come out replicated over the model axis, the usual
  tensor-parallel layout when it exceeds the KV heads.  A flatten that
  DTensor would place ``_StridedShard`` -- ``(B, T, V)`` to ``(B * T,
  V)`` with T split over ``model`` -- moves that split to a dim the
  view keeps (V) first, so that no activation of a step is strided
  (DTensor plans a strided placement's redistributions by a graph
  search: minutes an op on the 2 x 16 x 16 mesh);
* ``add`` (torch 2.11's rule, :func:`_no_shard_to_partial`): where it
  would turn a split input into a partial sum, which DTensor cannot
  run, the partial operands are reduced instead.

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
from torch.distributed.tensor.placement_types import _StridedShard

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


@register_sharding(aten.flip.default)
def _flip(x, dims):
    # a cumsum's backward (the chunked mLSTM's gate sums; torch 2.11 has
    # no rule): whole along the flipped dims
    flipped = {d % len(x.shape) for d in dims}
    out = [([R], [R, None])]
    out += [([Shard(d)], [Shard(d), None])
            for d in range(len(x.shape)) if d not in flipped]
    return out


@register_sharding(aten.cummaxmin_backward.default)
def _cummaxmin_backward(grad, x, indices, dim):
    dim %= len(x.shape)
    out = [([R], [R, R, R, None])]
    out += [([Shard(d)], [Shard(d), Shard(d), Shard(d), None])
            for d in range(len(x.shape)) if d != dim]
    return out


@register_sharding(aten.index.Tensor)
def _index(x, indices):
    """``x[indices]`` -- the embedding's ``table[tokens]``.  Exact on
    every entry: ``x`` whole, the indices whole or split alike on one of
    their broadcast dims (the output split there).  A vocab-sharded
    table thus comes whole over ``model`` (one all-gather of V d a step)
    and the output follows the tokens' split over ``pod`` and ``data``.
    Left out: a split of ``x`` (a split of its columns would leave the
    output split on d, whose partial products torch 2.11's DTensor then
    adds a bias to by an unsupported Shard -> Partial redistribution),
    and the masked partial sum of Megatron's vocab-parallel embedding,
    which needs DTensor's private ``_MaskPartial``, whose mask lives in
    a buffer the cached strategy shares between calls."""
    idx = [(i, t) for i, t in enumerate(indices) if t is not None]
    dims = [i for i, _ in idx]
    nd = max(len(t.shape) for _, t in idx)
    # the indices' broadcast dims sit in the output where x's first
    # indexed dim was (first, where the indexed dims are not consecutive)
    at = dims[0] if dims == list(range(dims[0], dims[-1] + 1)) else 0
    out = [([R], [R] + [R] * len(idx))]
    for b in range(nd):
        sizes = [t.shape[b - nd + len(t.shape)] if b >= nd - len(t.shape)
                 else 1 for _, t in idx]
        if all(n == 1 for n in sizes):
            continue
        out.append(([Shard(b + at)], [R] + [
            Shard(b - nd + len(t.shape)) if n > 1 else R
            for (_, t), n in zip(idx, sizes)]))
    return out


# the rule above serves every version: a torch that keeps a single-dim
# strategy for the op (2.13) would consult that before any registered rule
getattr(DTensor._op_dispatcher.sharding_propagator,
        "op_single_dim_strategy_funcs", {}).pop(aten.index.Tensor, None)


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


def _strided(strategy) -> set:
    """The mesh dims of a strategy's output placed ``_StridedShard``: a
    flatten of a dim sharded on one mesh dim into a major dim sharded on
    others -- ``(B, T, V)`` to ``(B * T, V)`` with the batch over the data
    axes and T over ``model`` (DTensor's choice for some partial sums).
    DTensor reads such a placement only by its graph-search planner,
    which takes minutes an op on the 3-D mesh."""
    return {i for spec in strategy.strategies
            for i, p in enumerate(spec.output_specs.placements)
            if isinstance(p, _StridedShard)}


def _split_ways(spec, mesh, dim: int) -> int:
    """The ranks a DTensor spec splits tensor dim ``dim`` over."""
    n = 1
    for j, p in enumerate(spec.placements):
        if p.is_shard(dim):
            n *= mesh.size(j)
    return n


def _kept_dim(op_schema, shape, mesh, i: int):
    """``Shard(k)`` for the outermost input dim ``k`` that the view keeps
    whole (the trailing dims from ``k`` on equal the output's) and that
    divides over mesh dim ``i`` beside the mesh dims that shard it
    already -- a row dim before a contracted one: ``(B, H, T, d)`` to
    ``(B * H, T, d)`` for a batched product splits T, not d; else
    ``Replicate()``.  Also ``Replicate()`` where mesh dim ``i`` splits its
    dim unevenly (whisper's 1,500 frames over 16): DTensor's move of an
    uneven split to another dim leaves a local tensor that the view
    cannot take without a copy."""
    spec = op_schema.args_schema[0].strategies[0].output_spec
    src = tuple(spec.tensor_meta.shape)
    moved = spec.placements[i].dim
    if src[moved] % _split_ways(spec, mesh, moved):
        return R
    lead = len(src) - len(shape)
    first = len(src)
    while first > max(lead, 0) and src[first - 1:] == tuple(
            shape[first - 1 - lead:]):
        first -= 1
    for k in range(first, len(src)):
        if src[k] % (mesh.size(i) * _split_ways(spec, mesh, k)) == 0:
            return Shard(k)
    return R


def _placed_on(op_schema, mesh_dims: dict):
    """``op_schema`` with its input placed on the mesh dims of
    ``mesh_dims`` as it maps them."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import (OpSchema, OpSpec,
                                                     OpStrategy)

    spec = op_schema.args_schema[0].strategies[0].output_spec
    pl = tuple(mesh_dims.get(i, p) for i, p in enumerate(spec.placements))
    arg = OpStrategy([OpSpec(DTensorSpec(spec.mesh, pl,
                                         tensor_meta=spec.tensor_meta))])
    return OpSchema(op_schema.op, (arg, *op_schema.args_schema[1:]),
                    op_schema.kwargs_schema, schema_info=op_schema.schema_info)


def _gather_where_uneven(strict: Callable, gathering: Callable) -> Callable:
    """A view's sharding strategy: DTensor's own (``strict``); where that
    refuses a split or a flatten that needs a redistribution,
    ``reshape``'s (``gathering``), which replicates the dim first; and where either
    proposes an output split unevenly, the same with the input
    replicated on the mesh dims at fault; where either proposes a
    ``_StridedShard`` (:func:`_strided`), the same with the input moved,
    on those mesh dims, to a dim the view keeps whole (an all-to-all;
    :func:`_kept_dim`) or else replicated.  The view then aliases the
    redistributed copy, not its input: the model's views are read, never
    written through."""
    def strategy(op_schema):
        mesh = op_schema.args_schema[0].strategies[0].output_spec.mesh
        shape = _out_shape(op_schema)
        for _ in range(2 * mesh.ndim + 1):
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
            strided = _strided(out) - bad
            if not bad and not strided:
                return out
            op_schema = _placed_on(op_schema, {
                **dict.fromkeys(bad, R),
                **{i: _kept_dim(op_schema, shape, mesh, i) for i in strided}})
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


def _no_shard_to_partial(strict: Callable) -> Callable:
    """DTensor's rule for an elementwise op (``strict``) without its
    entries that ask a split input to become a partial sum, a
    redistribution DTensor cannot run: torch 2.11 asks it of a bias
    split over ``model`` added to a partial product (jamba's smoke
    ``train_4k`` on the (2, 2, 2) mesh).  On such a mesh dim the partial
    inputs and the output are replicated instead (an all-reduce, and an
    all-gather of the split input): exact."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import (
        generate_redistribute_costs)

    def strategy(op_schema):
        out = strict(op_schema)
        args = [a for a in op_schema.args_schema if isinstance(a, OpStrategy)]
        specs = []
        for spec in out.strategies:
            bad = {i for arg, want in zip(args, spec.input_specs or ())
                   for i, (have, p) in enumerate(zip(
                       arg.strategies[0].output_spec.placements,
                       want.placements))
                   if have.is_shard() and p.is_partial()}
            if not bad:
                specs.append(spec)
                continue

            def whole(s):
                return DTensorSpec(s.mesh, tuple(
                    R if i in bad and p.is_partial() else p
                    for i, p in enumerate(s.placements)),
                    tensor_meta=s.tensor_meta)

            ins = [whole(w) for w in spec.input_specs]
            specs.append(OpSpec(whole(spec.output_spec), ins, [
                generate_redistribute_costs(a, w) for a, w in zip(args, ins)]))
        return OpStrategy(specs)

    return strategy


def _register_partial_guard() -> None:
    # torch 2.13 keeps a single-dim rule for add, which it consults first
    prop = DTensor._op_dispatcher.sharding_propagator
    funcs = prop.op_strategy_funcs
    if aten.add.Tensor in funcs:
        funcs[aten.add.Tensor] = _no_shard_to_partial(funcs[aten.add.Tensor])
        prop.propagate_op_sharding.cache_clear()


_register_partial_guard()


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
