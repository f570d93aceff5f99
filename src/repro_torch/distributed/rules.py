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
* ``log_sigmoid_forward`` and its backward: the xLSTM's forget gate,
  elementwise; ``softplus_backward`` (and ``softplus`` where torch has
  no rule, 2.11): Mamba's dt, elementwise;
* ``cummax`` and its backward: the chunked mLSTM's running max, whole
  along the scanned dim (torch 2.11 has no rule); ``scatter_add``, the
  gradient ``models.ssm`` gives it, split off the scattered dim;
  ``flip`` (a cumsum's backward there), whole along the flipped dims;
* ``gather``: never split the gathered dim (whole rows; DTensor's own
  rule makes a gather along a sharded dim a masked partial sum).  The
  loss picks its labels by a masked sum, not a gather;
* ``mm.dtype`` of the LM head keeps its weight's split of the vocab
  (:func:`_keep_column_split`): the logits leave the head split on V;
  and a product one of whose operands is a partial sum where the other
  is split keeps its work split (by rows, columns or, where it shrinks,
  its contraction), never the split operand gathered beside it (every
  rank the whole product);
* ``eq.Tensor``, ``div.Tensor`` (:func:`_broadcast_splits`): split on
  any output dim where each input is split alike or broadcast -- the
  loss's mask, ``ids == labels[..., None]``, with the labels split over
  the data axes and the vocab ids over ``model``, is split on both;
* ``log``, ``div.Tensor`` (:func:`_reduce_whole`): a partial input is
  reduced whole (an all-reduce), never scattered -- the loss's log of
  its vocab-split exp-sum and that log's backward;
* ``index.Tensor``: the indexed tensor whole, the indices whole or
  split on their own dims (:func:`_index`); ``index_put``: whole.
  torch 2.11's own rules fail on the multi-pod mesh;
* ``select.int`` of a dim one mesh dim splits (:func:`_select`, a
  DTensor op handler): the rank that holds the index gives its slice,
  the others zeros, a partial sum -- a stacked cache's layer, where
  DTensor would gather the whole cache
  (:func:`split_cache_attention` attends it by KV head);
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
  search: minutes an op on the 2 x 16 x 16 mesh).  A dim split unevenly
  that the view merges with others -- 6 batch rows over 4 ranks
  flattened with T -- is moved to a kept dim or replicated first
  (:func:`_uneven_merged`): DTensor would name an even split of the
  merged dim that the ranks' rows are not;
* ``unbind`` (:func:`_unbind_whole`): a step loop's steps, the unbound
  dim replicated where it is split, a partial input reduced once;
* ``add`` (torch 2.11's rule, :func:`_no_shard_to_partial`): where it
  would turn a split input into a partial sum, which DTensor cannot
  run, the partial operands are reduced instead.

Logits that reach the loss as a partial sum (a head whose input is one,
at fewer rows than ranks) are reduced once before the loss reads them,
onto the vocab where the head's weight splits it, else onto T
(:func:`reduced_logits`).

Attention runs on local shards (:func:`local_attention`): the flash
kernels take raw pointers, and the plain paths' grouping of q heads by
KV head would gather q whole where the model axis splits the groups.
Each mesh dim splits the heads where they divide, else the batch rows
(:func:`attention_splits`), so that no rank attends all heads of all
its rows while a split exists.
A serving cache is written and attended where it lies
(:func:`split_cache_attention`: flash-decoding over a split sequence),
and a vocab-split embedding table looked up where it lies, forward and
backward (DTensor op handlers for ``models.layers.embedding`` and its
backward, :func:`_embedding`: Megatron's masked lookup).  The MoE
dispatch buffer and the expert outputs are placed expert-parallel, as
the reference constrains them (op handlers for ``models.moe``'s row
gather, scatter-add and top-k sum: :func:`_gather_rows`,
:func:`_scatter_add_rows`, :func:`_sum_top_k`).  The xLSTM's steps run
on each rank's own rows (an op handler for ``models.ssm.scan_rows``,
:func:`_scan_rows`).
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


#: the vocab of the LM head whose params are split on V over a mesh dim,
#: of the params tree ``sharding.param_specs`` placed last (one model's,
#: :func:`set_vocab_split`): its product keeps the split
VOCAB_SPLIT: frozenset = frozenset()


def set_vocab_split(vocab) -> None:
    """Make ``vocab`` :data:`VOCAB_SPLIT`; DTensor's cached choices,
    made under another, are dropped."""
    global VOCAB_SPLIT
    if frozenset(vocab) != VOCAB_SPLIT:
        VOCAB_SPLIT = frozenset(vocab)
        DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding \
            .cache_clear()


def _splits_work(a, b, grows: bool) -> bool:
    """Whether placements ``a`` and ``b`` of ``a @ b`` on one mesh dim
    split the product's work: by the rows of ``a`` or the columns of
    ``b``, or by the contraction where the product shrinks its rows
    (not ``grows``): a split contraction leaves each rank a partial sum
    of the whole output, an MLP's whole hidden where it grows."""
    return a.is_shard(0) or b.is_shard(1) or (
        not grows and a.is_shard(1) and b.is_shard(0))


def _keep_column_split(strict: Callable) -> Callable:
    """The strategies of ``mm.dtype`` (``strict``), narrowed two ways.

    * The LM head's product -- ``b`` (d, V) with V in
      :data:`VOCAB_SPLIT` -- keeps ``b``'s column split on every mesh
      dim where it has one: the input meets it (gathered, or reduced
      where it is a partial sum), and the logits leave split on V (the
      vocab-parallel head).
    * On a mesh dim where one operand is a partial sum and the other is
      split (a weight; in the backward, an activation), the product's
      work stays split (:func:`_splits_work`): by its rows, its columns
      or, where ``b`` has fewer columns than rows, its contraction --
      never the split operand gathered beside the partial one, which
      leaves every rank of the dim the whole product (the MLP's whole
      hidden of its rows, as a partial sum, and the weights' gradients
      on the multi-pod mesh: 2.7x the FLOPs a device of the single-pod
      cell, with half its rows).

    DTensor's costs count only the inputs' redistributions, so it would
    rather gather the weight, and leave the whole (B T, V) logits, or
    the whole work of a product, on every rank.  Other products keep
    DTensor's choice."""
    def strategy(op_schema):
        out = strict(op_schema)
        a, b = (op_schema.args_schema[i].strategies[0].output_spec
                for i in (0, 1))
        keep = out.strategies
        if b.shape[1] in VOCAB_SPLIT:
            cols = [i for i, p in enumerate(b.placements) if p.is_shard(1)]
            keep = [s for s in keep
                    if all(s.input_specs[1].placements[i].is_shard(1)
                           for i in cols)]
        split = [i for i, (pa, pb) in enumerate(zip(a.placements,
                                                    b.placements))
                 if ((pa.is_partial() and pb.is_shard())
                     or (pb.is_partial() and pa.is_shard()))
                 and a.mesh.size(i) > 1]
        grows = b.shape[1] >= b.shape[0]
        keep = [s for s in keep if all(
            _splits_work(s.input_specs[0].placements[i],
                         s.input_specs[1].placements[i], grows)
            for i in split)]
        if keep:
            out.strategies = keep
        return out

    return strategy


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


@register_sharding(aten.log_sigmoid_forward.default)
def _log_sigmoid_forward(x):
    """The xLSTM's forget gate (``F.logsigmoid``; no rule in torch 2.13,
    whose fallback ran it on the whole tensor): elementwise, the output
    and the buffer split like ``x`` on any dim.  The buffer has ``x``'s
    shape on the CPU and is empty on a card (``aten``'s decomposition:
    ``cuda`` and ``xpu``), where it is replicated."""
    empty = x.mesh.device_type in ("cuda", "xpu")
    out = [([R, R], [R])]
    out += [([Shard(d), R if empty else Shard(d)], [Shard(d)])
            for d in range(len(x.shape))]
    return out


@register_sharding(aten.log_sigmoid_backward.default)
def _log_sigmoid_backward(grad, x, buffer):
    # the CPU's buffer is x's shape; the card's is empty (replicated)
    buf = len(buffer.shape) == len(x.shape) and buffer.shape == x.shape
    out = [([R], [R, R, R])]
    out += [([Shard(d)], [Shard(d), Shard(d), Shard(d) if buf else R])
            for d in range(len(x.shape))]
    return out


@register_sharding(aten.softplus_backward.default)
def _softplus_backward(grad, x, *rest):
    # Mamba's dt (no rule in torch 2.11 or 2.13, whose fallbacks run it
    # on the whole tensor): elementwise
    x_ = _extra(rest)
    out = [([R], [R, R, *x_])]
    out += [([Shard(d)], [Shard(d), Shard(d), *x_])
            for d in range(len(x.shape))]
    return out


def _softplus(x, *rest):
    # its forward, where torch has no rule (2.11; 2.13's is kept)
    x_ = _extra(rest)
    return [([R], [R, *x_])] + [([Shard(d)], [Shard(d), *x_])
                                for d in range(len(x.shape))]


def _has_strategy(op) -> bool:
    prop = DTensor._op_dispatcher.sharding_propagator
    return op in prop.op_strategy_funcs or op in getattr(
        prop, "op_single_dim_strategy_funcs", {})


if not _has_strategy(aten.softplus.default):
    register_sharding(aten.softplus.default)(_softplus)


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


@register_sharding(aten.scatter_add.default)
def _scatter_add(x, dim, index, src):
    # the chunked mLSTM's running-max gradient: split on a dim other than
    # the scattered one where all three are alike (DTensor gathers them)
    dim %= len(x.shape)
    out = [([R], [R, None, R, R])]
    out += [([Shard(d)], [Shard(d), None, Shard(d), Shard(d)])
            for d in range(len(x.shape))
            if d != dim and x.shape[d] == index.shape[d] == src.shape[d]]
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
    """``x[indices]``.  Exact on every entry: ``x`` whole, the indices
    whole or split alike on one of their broadcast dims (the output split
    there).  A vocab-split embedding table does not come here but to
    :func:`_embedding`.  Left out: a split of ``x``'s columns,
    which would leave the output split on d, whose partial products
    torch 2.11's DTensor then adds a bias to by an unsupported Shard ->
    Partial redistribution."""
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




@register_sharding([aten.index_put.default, aten.index_put_.default,
                    aten._index_put_impl_.default])
def _index_put(x, indices, values, *rest, **kwargs):
    idx = [R for i in indices if i is not None]
    return [([R], [R, *idx, R, *_extra(rest)])]


def _broadcast_splits(a, b) -> list:
    """A binary elementwise op's entries: whole, or split on an output dim
    where each input is split alike or broadcast there (a size-1 or
    missing dim, replicated; a number, ``None``).  Per mesh dim, so inputs
    split over different mesh dims keep both splits -- the loss's ``ids
    == labels[..., None]``, the labels split over the data axes and the
    vocab ids over ``model`` (torch 2.11's pointwise rule follows one
    input on every mesh dim and would gather the other)."""
    ts = [t if hasattr(t, "shape") else None for t in (a, b)]
    nd = max(len(t.shape) for t in ts if t is not None)
    out = [([R], [R if t is not None else None for t in ts])]
    for d in range(nd):
        pl = []
        for t in ts:
            k = None if t is None else d - nd + len(t.shape)
            pl.append(None if t is None else
                      Shard(k) if k >= 0 and t.shape[k] != 1 else R)
        if any(p is not None and p != R for p in pl):
            out.append(([Shard(d)], pl))
    return out


@register_sharding(aten.eq.Tensor)
def _eq(a, b):
    """``a == b`` (:func:`_broadcast_splits`)."""
    return _broadcast_splits(a, b)


@register_sharding(aten.div.Tensor)
def _div(a, b):
    """``a / b`` (:func:`_broadcast_splits`), and a partial ``a`` over a
    replicated ``b``: partial.  A partial ``b`` is reduced whole
    (:func:`_reduce_whole`): the log's backward divides by the loss's
    exp-sum, a partial sum over the vocab split."""
    out = _broadcast_splits(a, b)
    if hasattr(b, "shape"):
        out.append(([Partial()], [Partial(), R]))
    else:
        out.append(([Partial()], [Partial(), None]))
    return out


@register_sharding(aten.log.default)
def _log(x):
    """Elementwise; a partial input is reduced whole
    (:func:`_reduce_whole`)."""
    return [([R], [R])] + [([Shard(d)], [Shard(d)])
                           for d in range(len(x.shape))]


# the rules above serve every version: a torch that keeps a single-dim
# strategy for an op (2.13) consults that before any registered rule
for _op in (aten.index.Tensor, aten.eq.Tensor, aten.div.Tensor,
            aten.log.default):
    getattr(DTensor._op_dispatcher.sharding_propagator,
            "op_single_dim_strategy_funcs", {}).pop(_op, None)


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
    those after the longest leading run of the mesh dims sharing the dim
    whose product divides it (DTensor's view rule can propose such
    splits for a dim sharded over several mesh dims: the batch of 256
    over (2, 16, 16))."""
    bad = set()
    for spec in strategy.strategies:
        bad.update(_undivided(spec.output_specs.placements, shape, mesh))
    return bad


def _undivided(placements, shape, mesh, dims=None) -> set:
    """The mesh dims of ``placements`` that split a dim of ``shape`` (of
    ``dims``, by default any) unevenly: those after the longest leading
    run of the mesh dims sharing the dim whose product divides it."""
    by_dim, bad = {}, set()
    for i, p in enumerate(placements):
        if p.is_shard() and (dims is None or p.dim in dims):
            by_dim.setdefault(p.dim, []).append(i)
    for d, split in by_dim.items():
        n, k = 1, 0
        while k < len(split) and shape[d] % (n * mesh.size(split[k])) == 0:
            n *= mesh.size(split[k])
            k += 1
        bad.update(split[k:])
    return bad


def _uneven_merged(op_schema, shape, mesh) -> set:
    """The mesh dims that split an input dim of a view unevenly where the
    view does not keep that dim alone (:func:`_undivided`): a flatten of
    a batch of 6 rows over 4 ranks (2, 2, 2, 0) into (6 T, ...) rows is
    no split of the flattened rows that DTensor can name (it would take
    each rank's local rows for an even quarter of them: a view of the
    wrong numel)."""
    spec = op_schema.args_schema[0].strategies[0].output_spec
    src = tuple(spec.tensor_meta.shape)
    kept = set()
    lead_in = lead_out = 1
    k = 0
    for d, n in enumerate(src):
        while k < len(shape) and lead_out < lead_in:
            lead_out *= shape[k]
            k += 1
        if k < len(shape) and lead_out == lead_in and shape[k] == n:
            kept.add(d)
        lead_in *= n
    return _undivided(spec.placements, src, mesh,
                      set(range(len(src))) - kept)


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
    ``reshape``'s (``gathering``), which replicates the dim first; and
    where either proposes an output split unevenly, the same with the
    input replicated on the mesh dims at fault -- or, where the view
    unflattens (rows of a product back to (B, T, ...), whose batch the
    mesh dims outnumber), moved there as for a ``_StridedShard``; where
    either proposes a ``_StridedShard`` (:func:`_strided`), the same
    with the input moved, on those mesh dims, to a dim the view keeps
    whole (an all-to-all; :func:`_kept_dim`: an MLP hidden's columns
    rather than the whole hidden gathered) or else replicated.  The view
    then aliases the redistributed copy, not its input: the model's
    views are read, never written through."""
    def strategy(op_schema):
        mesh = op_schema.args_schema[0].strategies[0].output_spec.mesh
        shape = _out_shape(op_schema)
        for _ in range(2 * mesh.ndim + 1):
            merged = _uneven_merged(op_schema, shape, mesh)
            if merged:
                op_schema = _placed_on(op_schema, {
                    i: _kept_dim(op_schema, shape, mesh, i) for i in merged})
                continue
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
            src = op_schema.args_schema[0].strategies[0].output_spec.shape
            moved = strided | (bad if len(shape) > len(src) else set())
            op_schema = _placed_on(op_schema, {
                **dict.fromkeys(bad - moved, R),
                **{i: _kept_dim(op_schema, shape, mesh, i) for i in moved}})
        raise RuntimeError(f"no even split of {op_schema} over {mesh}")

    return strategy


def _unbind_whole(strict: Callable) -> Callable:
    """``unbind``'s strategy: DTensor's own (``strict``), with the unbound
    dim replicated first on the mesh dims that split it, which DTensor
    refuses -- as ``select`` gathers a split dim -- and a partial sum
    reduced whole.  A step loop reads its steps (or chunks) as one
    ``unbind``'s views, then aliasing the redistributed copy: a loop's
    input is reduced once, not each step, where a step's non-linear
    update meets it (Mamba's B and C, the row-parallel ``x_proj``'s
    partial outputs)."""
    def strategy(op_schema):
        spec = op_schema.args_schema[0].strategies[0].output_spec
        dim = op_schema.args_schema[1] if len(op_schema.args_schema) > 1 else 0
        dim %= len(spec.shape)
        whole = {i: R for i, p in enumerate(spec.placements)
                 if p.is_shard(dim) or p.is_partial()}
        return strict(_placed_on(op_schema, whole) if whole else op_schema)

    return strategy


def _register_view_fallback() -> None:
    prop = DTensor._op_dispatcher.sharding_propagator
    funcs = prop.op_strategy_funcs
    for op in (aten.view.default, aten._unsafe_view.default):
        funcs[op] = _gather_where_uneven(funcs[op],
                                         funcs[aten.reshape.default])
    funcs[aten.unbind.int] = _unbind_whole(funcs[aten.unbind.int])
    prop.propagate_op_sharding.cache_clear()


_register_view_fallback()


def _register_column_split(op=aten.mm.dtype) -> None:
    """Narrow ``op``'s strategies by :func:`_keep_column_split` (the
    card's ``mm.dtype``; a test gives the CPU's ``mm`` the card's
    rules)."""
    prop = DTensor._op_dispatcher.sharding_propagator
    funcs = prop.op_strategy_funcs
    funcs[op] = _keep_column_split(funcs[op])
    prop.propagate_op_sharding.cache_clear()


_register_column_split()


def _reduce_whole(strict: Callable) -> Callable:
    """The strategies of ``strict`` that keep a partial input partial or
    reduce it to replicated (an all-reduce), never to a split (a
    reduce-scatter), on every mesh dim where the input is partial.  The
    loss's log of its vocab-split exp-sum, split over ``model`` by token,
    would have its gradient meet the vocab-split logits with another
    split, and DTensor would move the logits (an all-to-all of the whole
    ``(B, T, V)``)."""
    from torch.distributed.tensor._op_schema import OpStrategy

    def strategy(op_schema):
        out = strict(op_schema)
        part = [(j, i) for j, a in enumerate(op_schema.args_schema)
                if isinstance(a, OpStrategy)
                for i, p in enumerate(a.strategies[0].output_spec.placements)
                if p.is_partial()]
        keep = [s for s in out.strategies
                if not any(s.input_specs[j].placements[i].is_shard()
                           for j, i in part)]
        if part and keep:
            out.strategies = keep
        return out

    return strategy


def _register_reduce_whole() -> None:
    prop = DTensor._op_dispatcher.sharding_propagator
    funcs = prop.op_strategy_funcs
    for op in (aten.log.default, aten.div.Tensor):
        funcs[op] = _reduce_whole(funcs[op])
    prop.propagate_op_sharding.cache_clear()


_register_reduce_whole()


def _select(op_call, args, kwargs):
    """``aten.select.int`` of a DTensor without a gradient, along a dim
    that one mesh dim splits -- a stacked cache's layer dim, which
    ``sharding.cache_specs`` splits over ``model`` where the layers number
    the KV heads (olmoe's 16), as the reference does: the rank that holds
    the index gives its slice (a view, written in place), every other
    rank zeros that take no memory (a zero-stride tensor), a partial sum
    (on ``meta`` too, where the dry run's rank 0 holds the first layers).
    DTensor's own rule would gather the whole tensor.
    :func:`split_cache_attention` attends such a layer.  Any other
    select takes DTensor's rule."""
    from torch.distributed.tensor._dtensor_spec import (DTensorSpec,
                                                        TensorMeta)
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    x, dim, index = args[0], args[1] % args[0].ndim, args[2]
    index += x.shape[dim] if index < 0 else 0
    split = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    if (len(split) != 1 or x.requires_grad
            or any(isinstance(p, _StridedShard) for p in x.placements)):
        handlers = DTensor._op_dispatcher._custom_op_handlers
        del handlers[op_call]
        try:
            return op_call(*args, **(kwargs or {}))
        finally:
            handlers[op_call] = _select
    mesh, local = x.device_mesh, x._local_tensor
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, mesh, x.placements)
    at = index - offset[dim]
    if 0 <= at < shape[dim]:
        out = local.select(dim, at)
    else:
        out = local.new_zeros(()).expand(local.select(dim, 0).shape)
    placements = tuple(
        Partial() if i in split
        else Shard(p.dim - 1) if p.is_shard() and p.dim > dim else p
        for i, p in enumerate(x.placements))
    keep = [d for d in range(x.ndim) if d != dim]
    meta = TensorMeta(torch.Size(x.shape[d] for d in keep),
                      tuple(x.stride()[d] for d in keep), x.dtype)
    return DTensor(out, DTensorSpec(mesh, placements, tensor_meta=meta),
                   requires_grad=False)


DTensor._op_dispatcher._custom_op_handlers[aten.select.int] = _select


def _holds(t) -> bool:
    """False for the zero-stride zeros :func:`_select` gives a rank that
    does not hold the selected slice."""
    return t.numel() <= 1 or 0 not in t.stride()


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


def attention_splits(placements, sizes, B: int, Hq: int, Hkv: int,
                     kv_placements=None):
    """Each mesh dim's split of attention on (B, H, T, d) q, k, v whose q
    is placed ``placements`` (k and v ``kv_placements``, by default as
    q) on a mesh of ``sizes``: ``"rows"`` (the batch), ``"heads"`` or
    ``None`` (whole), and the mesh dim whose split of the q heads gives
    each rank one KV head of whole k and v (or None).  In mesh-dim
    order, on the rows and heads left by the dims before it:

    * a batch split of q that divides the rows is kept;
    * else the heads, where they divide (the KV heads too, or the mesh
      dim is a multiple of them: each rank's q heads then share one KV
      head, picked from whole k and v -- on one mesh dim at most, and
      not where k or v is a partial mean, whose gradient DTensor cannot
      give as the partial sum the pick leaves);
    * else the rows, where they divide;
    * else nothing, so every rank attends its rows and heads whole.

    A replicated dim of one rank stays whole.  So no mesh dim that
    splits nothing else leaves a rank all heads of all its rows while a
    split exists (a partial q, k, v is reduce-scattered onto it, never
    all-reduced whole)."""
    rows, hq, hkv, pick = B, Hq, Hkv, None
    out = []
    for i, (p, n) in enumerate(zip(placements, sizes)):
        kv = (kv_placements or placements)[i]
        can_pick = pick is None and n % hkv == 0 and not (
            kv.is_partial() and kv.reduce_op != "sum")
        heads = hq % n == 0 and (hkv % n == 0 or can_pick)
        if p.is_shard(0) and rows % n == 0:
            choice = "rows"
        elif p.is_replicate() and n == 1:
            choice = None
        elif heads:
            choice = "heads"
            if hkv % n:
                pick, hkv = i, 1
            else:
                hkv //= n
            hq //= n
        elif rows % n == 0:
            choice = "rows"
        else:
            choice = None
        if choice == "rows":
            rows //= n
        out.append(choice)
    return out, pick


def attention_plan(q, k, v):
    """:func:`attention_splits` of DTensors q, k, v (B, H, T, d): k's
    placements, or v's where v is a partial mean."""
    kv = [pv if pv.is_partial() and pv.reduce_op != "sum" else pk
          for pk, pv in zip(k.placements, v.placements)]
    return attention_splits(q.placements, tuple(q.device_mesh.mesh.shape),
                            q.shape[0], q.shape[1], k.shape[1], kv)


def local_attention(fn: Callable, q, k, v):
    """``fn(q, k, v)`` -- attention on (B, H, T, d) DTensors -- on each
    rank's local batch rows and heads (``local_map``), split on each
    mesh dim as :func:`attention_splits` chooses: k and v split as q,
    but where the dim picks a KV head, when they come whole and each
    rank takes the one its q heads share.  q, k and v are moved to
    those placements (a partial sum -- they are partial where their
    projections contract a split feature dim -- reduce-scattered), the
    output leaves in q's, and the gradients of whole k and v are partial
    over the picking dim.  Heads and batch rows are independent, so the
    kernels see whole problems."""
    mesh = q.device_mesh
    splits, pick = attention_plan(q, k, v)
    place = {"rows": Shard(0), "heads": Shard(1), None: R}
    q_pl = tuple(place[c] for c in splits)
    kv_pl = tuple(R if i == pick else place[c] for i, c in enumerate(splits))
    kv_grad = kv_pl
    if pick is None:
        local = fn
    else:
        # this rank's q heads all belong to KV head coord // (n / Hkv) of
        # its local k and v; they get a gradient in that head only,
        # summed over the ranks of the split
        hkv = k.shape[1]
        for i, c in enumerate(splits[:pick]):
            hkv //= mesh.size(i) if c == "heads" else 1
        h = mesh.get_coordinate()[pick] // (mesh.size(pick) // hkv)
        kv_grad = tuple(Partial() if i == pick else p
                        for i, p in enumerate(kv_pl))

        def local(q, k, v):
            return fn(q, k[:, h:h + 1], v[:, h:h + 1])

    moved = [tuple(t.placements) != pl
             for t, pl in ((q, q_pl), (k, kv_pl), (v, kv_pl))]

    def dense(*args):
        # the gradient of an input that was moved is gathered back: the
        # gathered DTensor keeps the local gradient's strides, but its
        # local tensor comes out contiguous, so a view in the backward
        # that the strides allow fails on it unless they agree
        return local(*(_DenseGrad.apply(t) if m else t
                       for t, m in zip(args, moved)))

    # one output, given as a 1-tuple so that its placements read alike
    # on every torch version
    return local_map(lambda *a: (dense(*a),), out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)[0]


class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def reduced_logits(lf):
    """The logits ``lf`` (..., V), a DTensor, with every partial sum
    reduced once, before the loss reads them: on each mesh dim where
    they are partial, reduce-scattered onto V where the head's weight is
    split on V (V in :data:`VOCAB_SPLIT`) and V divides, else onto the
    innermost other dim that divides (T: the loss works row by row),
    else all-reduced -- never left whole on every rank where a split
    exists.  The loss's ``amax`` saves its input for a backward that
    compares it with the max: a partial input is reduced again there,
    by another collective in another order (a reduce-scatter onto T
    where the forward all-reduced), and a row whose max then matches no
    logit divides by a count of 0 (NaN, the CPU's smoke step at 2 rows
    over ``model`` 4).  The gradient keeps the reduced layout
    (:class:`_Reduce`): DTensor's own redistribution would gather it
    whole, as a partial sum's."""
    mesh, last = lf.device_mesh, lf.ndim - 1
    ways = [1] * lf.ndim
    for i, p in enumerate(lf.placements):
        if p.is_shard():
            ways[p.dim] *= mesh.size(i)
    dims = ([last] if lf.shape[-1] in VOCAB_SPLIT else []) + list(
        range(last - 1, -1, -1))
    pl = []
    for i, p in enumerate(lf.placements):
        n = mesh.size(i)
        k = next((d for d in dims if lf.shape[d] % (ways[d] * n) == 0),
                 None) if p.is_partial() else None
        if k is not None:
            ways[k] *= n
        pl.append(p if not p.is_partial() else R if k is None else Shard(k))
    pl = tuple(pl)
    return lf if pl == tuple(lf.placements) else _Reduce.apply(lf, pl)


class _Reduce(torch.autograd.Function):
    """``x.redistribute`` to ``placements`` whose gradient stays in
    them: the gradient of a partial sum is the whole tensor's, in any
    layout."""

    @staticmethod
    def forward(ctx, x, placements):
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _spec(mesh, placements, shape, dtype):
    """A DTensor spec of a contiguous ``shape``."""
    from torch.distributed.tensor._dtensor_spec import (DTensorSpec,
                                                        TensorMeta)

    stride, strides = 1, []
    for n in reversed(shape):
        strides.insert(0, stride)
        stride *= n
    return DTensorSpec(mesh, tuple(placements), tensor_meta=TensorMeta(
        torch.Size(shape), tuple(strides), dtype))


def _moved(t, placements):
    """``t.redistribute(...).to_local()`` of a DTensor below autograd (an
    op handler's: DTensor's autograd functions fail there on torch
    2.11)."""
    from torch.distributed.tensor._redistribute import (
        redistribute_local_tensor)

    return redistribute_local_tensor(
        t._local_tensor, t._spec,
        _spec(t.device_mesh, placements, t.shape, t.dtype))


def _vocab_split(table, tokens):
    """For a DTensor ``table`` (V, ...) split on V and ``tokens`` (a
    tensor, or a DTensor on its mesh): the mesh dims that split V, the
    tokens' placements with those dims whole (``t_pl``, their other
    splits kept) and the rank's tokens so placed, the table's placements
    for the lookup (``w_pl``: split on V, whole elsewhere -- an FSDP
    split of d is gathered), and the rank's rows of V (``rows``, from
    ``lo``); None where V is whole."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    if not vocab:
        return None
    if isinstance(tokens, DTensor):
        t_pl = tuple(R if i in vocab else p
                     for i, p in enumerate(tokens.placements))
        tok = _moved(tokens, t_pl)
    else:
        t_pl, tok = (R,) * mesh.ndim, tokens
    w_pl = tuple(Shard(0) if i in vocab else R for i in range(mesh.ndim))
    rows, lo = compute_local_shape_and_global_offset(table.shape, mesh, w_pl)
    return vocab, tok, t_pl, w_pl, rows[0], lo[0]


def _embedding(op_call, args, kwargs):
    """``models.layers.embedding`` -- ``table[tokens]`` -- of a DTensor
    table split on V: Megatron's vocab-parallel lookup.  Each rank looks
    up the rows it holds and gives zeros for the tokens it does not, and
    one all-reduce of the (..., d) output sums them -- exact, one row
    plus zeros.  The tokens keep their splits.  A table whole on V takes
    ``index``'s rule (:func:`_index`)."""
    from torch.distributed.tensor._redistribute import (
        redistribute_local_tensor)

    table, tokens = args
    split = _vocab_split(table, tokens)
    if split is None:
        return table[tokens]
    vocab, tok, t_pl, w_pl, rows, lo = split
    mesh = table.device_mesh
    w = _moved(table, w_pl)
    local = tok - lo
    ok = (local >= 0) & (local < rows)
    out = torch.where(ok[..., None], w[local.clamp(0, rows - 1)], 0)
    shape = (*tokens.shape, *table.shape[1:])
    partial = _spec(mesh, [Partial() if i in vocab else p
                           for i, p in enumerate(t_pl)], shape, out.dtype)
    whole = _spec(mesh, t_pl, shape, out.dtype)
    return DTensor(redistribute_local_tensor(out, partial, whole), whole,
                   requires_grad=False)


def _embedding_backward(op_call, args, kwargs):
    """``models.layers.embedding_backward`` of a DTensor table split on V:
    each rank sums the gradient of its own tokens into its own rows, with
    no communication -- partial sums over the mesh dims that split the
    tokens, the table's split of V elsewhere -- in the order the whole
    table's backward sums them.  A table whole on V: autograd's
    ``index`` backward under the rules above."""
    grad, tokens, table = args
    split = _vocab_split(table, tokens)
    if split is None:
        return grad.new_zeros(table.shape).index_put(
            (tokens,), grad, accumulate=True)
    vocab, tok, t_pl, w_pl, rows, lo = split
    g = _moved(grad, t_pl)
    local = tok - lo
    ok = (local >= 0) & (local < rows)
    out = g.new_zeros((rows, *table.shape[1:])).index_put_(
        (local.clamp(0, rows - 1),), torch.where(ok[..., None], g, 0),
        accumulate=True)
    return DTensor(out, _spec(
        table.device_mesh, [Partial() if p.is_shard() else q
                            for p, q in zip(t_pl, w_pl)],
        table.shape, out.dtype), requires_grad=False)


def _register_embedding() -> None:
    from ..models import layers  # noqa: F401  (defines the two ops)

    handlers = DTensor._op_dispatcher._custom_op_handlers
    handlers[torch.ops.repro_torch.embedding.default] = _embedding
    handlers[torch.ops.repro_torch.embedding_backward.default] = (
        _embedding_backward)


_register_embedding()


def _local_rows(t, placements):
    """The rows of dim 1 that the rank holds of ``t`` so placed: their
    first global index and their count."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, placements)
    return offset[1], shape[1]


def _ep_dims(src, index):
    """The mesh dims that place the MoE row ops' operands (G, S, d), (G,
    J): those that split the groups -- the token axes of
    ``models.moe._EP_SPEC`` where their ranks divide G, and any dim that
    splits both operands' groups already -- and the expert axis's dim,
    where its ranks divide J (an expert-major (G, E C) axis split evenly
    gives each rank its own experts' slots), else None."""
    from ..models import moe

    mesh = src.device_mesh
    names = mesh.mesh_dim_names or ()
    e_ax, t_axes = moe._EP_SPEC or (None, ())
    G, J = index.shape

    def placed(i):
        return (src.placements[i].is_shard(0)
                and index.placements[i].is_shard(0))

    groups = [i for i in range(mesh.ndim) if names[i] in t_axes or placed(i)]
    n = 1
    for i in groups:
        n *= mesh.size(i)
    if G % n:
        groups = [i for i in groups if placed(i)]
    expert = next((i for i in range(mesh.ndim) if names[i] == e_ax
                   and i not in groups and J % mesh.size(i) == 0), None)
    return groups, expert


def _dtensors(args):
    """The handler's tensor arguments as DTensors: a plain one (a tensor
    the model made) replicated on the others' mesh."""
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    return [a if isinstance(a, DTensor) else DTensor(
        a, _spec(mesh, [R] * mesh.ndim, a.shape, a.dtype),
        requires_grad=False) for a in args]


def _gather_rows(op_call, args, kwargs):
    """``models.moe.gather_rows`` of DTensors: the dispatch buffer placed
    expert-parallel as the reference constrains it (each rank gathers
    its experts' slots from its groups' whole tokens), and the combine
    from a source split over the experts as Megatron's vocab-parallel
    lookup reads a split table (each rank its rows, zeros for the
    others: a partial sum, which the combine's sum over the top k
    reduces, :func:`_sum_top_k`).  The groups stay split over the token
    axes (:func:`_ep_dims`); any other dim is gathered."""
    src, index = _dtensors(args)
    mesh = src.device_mesh
    groups, expert = _ep_dims(src, index)
    src_pl, idx_pl, out_pl = [], [], []
    for i in range(mesh.ndim):
        if i in groups:
            pl = (Shard(0), Shard(0), Shard(0))
        elif src.placements[i].is_shard(1):
            pl = (Shard(1), R, Partial())
        elif i == expert:
            pl = (R, Shard(1), Shard(1))
        else:
            pl = (R, R, R)
        for out, p in zip((src_pl, idx_pl, out_pl), pl):
            out.append(p)
    s = _moved(src, src_pl)
    idx = _moved(index, idx_pl)
    if any(p.is_partial() for p in out_pl):
        lo, rows = _local_rows(src, src_pl)
        at = idx - lo
        ok = (at >= 0) & (at < rows)
        got = torch.gather(s, 1, at.clamp(0, rows - 1)[..., None].expand(
            *at.shape, s.shape[-1]))
        out = torch.where(ok[..., None], got, 0)
    else:
        out = torch.gather(s, 1, idx[..., None].expand(*idx.shape,
                                                      s.shape[-1]))
    return DTensor(out, _spec(mesh, out_pl, (*index.shape, src.shape[-1]),
                              out.dtype), requires_grad=False)


def _scatter_add_rows(op_call, args, kwargs):
    """``models.moe.scatter_add_rows`` of DTensors: the transpose of
    :func:`_gather_rows`.  Into a result split over the experts like its
    ``like`` (the combine source's gradient), each rank sums the
    entries of its own rows in order; from a J side split by experts'
    slots (the dispatch buffer's gradient, the expert-side combine),
    each rank sums its slots into its groups' whole rows; so does it a
    partial J side.  Partial sums are reduced here (:func:`_reduced`;
    Megatron reduces a column-parallel input's gradient at once: a
    partial gradient of the tokens would reach the attention's
    backward, where DTensor gathers whole weights to meet it).  No
    zeros of the global (G, S, d) on a rank, which autograd's
    ``gather`` backward would make."""
    src, index, like = _dtensors(args)
    mesh = src.device_mesh
    groups, expert = _ep_dims(src, index)
    src_pl, idx_pl, out_pl = [], [], []
    for i in range(mesh.ndim):
        if i in groups:
            pl = (Shard(0), Shard(0), Shard(0))
        elif like.placements[i].is_shard(1):
            pl = (R, R, Shard(1))
        elif src.placements[i].is_partial():
            pl = (Partial(), R, Partial())     # a scatter is linear
        elif src.placements[i].is_shard(1) or i == expert:
            pl = (Shard(1), Shard(1), Partial())
        else:
            pl = (R, R, R)
        for out, p in zip((src_pl, idx_pl, out_pl), pl):
            out.append(p)
    s = _moved(src, src_pl)
    idx = _moved(index, idx_pl)
    shape = tuple(like.shape)
    if any(p.is_shard(1) for p in out_pl):
        lo, rows = _local_rows(like, out_pl)
        at = idx - lo
        ok = (at >= 0) & (at < rows)
        s = torch.where(ok[..., None], s, 0)
        idx = at.clamp(0, rows - 1)
    else:
        rows = shape[1]
    out = s.new_zeros((s.shape[0], rows, s.shape[-1])).scatter_add_(
        1, idx[..., None].expand(*idx.shape, s.shape[-1]), s)
    return _reduced(out, mesh, out_pl, shape)


def _reduced(local, mesh, placements, shape):
    """A DTensor of ``shape`` from a rank's ``local`` (G, N, d) so
    placed, its partial sums reduced: reduce-scattered onto the feature
    dim d where the mesh dim divides it (the residual stream then stays
    split there, as a dense block's sequence-parallel output leaves it),
    else all-reduced."""
    from torch.distributed.tensor._redistribute import (
        redistribute_local_tensor)

    out_pl, feat = [], 1
    for i, p in enumerate(placements):
        if not p.is_partial():
            out_pl.append(p)
        elif shape[2] % (feat * mesh.size(i)) == 0:
            out_pl.append(Shard(2))
            feat *= mesh.size(i)
        else:
            out_pl.append(R)
    out = _spec(mesh, out_pl, shape, local.dtype)
    return DTensor(redistribute_local_tensor(
        local, _spec(mesh, placements, shape, local.dtype), out), out,
        requires_grad=False)


def _sum_top_k(op_call, args, kwargs):
    """``models.moe.sum_top_k`` of a DTensor: each rank sums its rows,
    and a partial sum over the experts' ranks (the combine) is reduced
    here (:func:`_reduced`), on the (G, N, d) sum, ``k`` times smaller
    than the rows.  A split of the groups stays; a split of the rows
    stays where it falls on whole tokens."""
    (rows,), k = _dtensors(args[:1]), args[1]
    mesh = rows.device_mesh
    G, NK, d = rows.shape
    in_pl, ways = [], 1
    for i, p in enumerate(rows.placements):
        if p.is_shard(0) or p.is_partial():
            in_pl.append(p)
        elif p.is_shard(1) and (NK // k) % (ways * mesh.size(i)) == 0:
            in_pl.append(p)
            ways *= mesh.size(i)
        else:
            in_pl.append(R)
    local = _moved(rows, in_pl)
    out = local.reshape(local.shape[0], -1, k, d).sum(dim=2)
    return _reduced(out, mesh, in_pl, (G, NK // k, d))


def _register_rows() -> None:
    from ..models import moe  # noqa: F401  (defines the ops)

    handlers = DTensor._op_dispatcher._custom_op_handlers
    handlers[torch.ops.repro_torch.gather_rows.default] = _gather_rows
    handlers[torch.ops.repro_torch.scatter_add_rows.default] = (
        _scatter_add_rows)
    handlers[torch.ops.repro_torch.sum_top_k.default] = _sum_top_k


_register_rows()


def _scan_rows(op_call, args, kwargs):
    """``models.ssm.scan_rows`` of a DTensor (B, ...): the copy split by
    its rows on every mesh dim where they divide, else by its ``free``
    dim where that divides -- a dim split elsewhere moved there (an
    all-to-all), a partial sum reduce-scattered there, a whole one
    sliced -- else as it comes, a partial sum reduced whole; the local
    copy contiguous, as its spec says.  The mLSTM's steps then run on
    each rank's own rows, all heads, and its state C (B, H, hd, hd) is
    split as the rows are, no step moving data; where the rows do not
    divide (the multi-pod mesh's 8 a data shard under 16), C is split by
    its columns, as v's head dim is, and every rank steps the rest of
    its rows whole.  Heads fewer than ``model`` (xlstm-125m's 4 under
    16) cannot split it, and a split of the dims a step contracts would
    make its products partial sums."""
    x = _dtensors(args[:1])[0]
    free = args[1] if len(args) > 1 else (kwargs or {}).get("free")
    dims = [0] if free is None else [0, free % x.ndim]
    mesh = x.device_mesh
    ways = dict.fromkeys(dims, 1)
    for i, p in enumerate(x.placements):
        if p.is_shard() and p.dim in ways:
            ways[p.dim] *= mesh.size(i)
    pl = []
    for i, p in enumerate(x.placements):
        if not (p.is_shard() and p.dim in ways):
            d = next((d for d in dims
                      if x.shape[d] % (ways[d] * mesh.size(i)) == 0), None)
            if d is not None:
                p = Shard(d)
                ways[d] *= mesh.size(i)
        pl.append(R if p.is_partial() else p)
    local = _moved(x, pl).clone(memory_format=torch.contiguous_format)
    return DTensor(local, _spec(mesh, pl, x.shape, local.dtype),
                   requires_grad=False)


def _register_scan_rows() -> None:
    from ..models import ssm  # noqa: F401  (defines the op)

    handlers = DTensor._op_dispatcher._custom_op_handlers
    handlers[torch.ops.repro_torch.scan_rows.default] = _scan_rows


_register_scan_rows()


def _by_heads(hq: int, hkv: int, ranks: int) -> bool:
    """Whether :func:`split_cache_attention` attends a layer of a cache
    split by layer on each rank's own KV heads: where the query and KV
    heads divide over the ``ranks`` they are split over; else the rank
    that holds the layer attends all of it."""
    return hq % ranks == 0 and hkv % ranks == 0


def split_cache_attention(fn: Callable, q, k, v, cache, cache_index, *,
                          causal: bool):
    """``fn(q, k, v, cache_k, cache_v, cache_index, causal=...)`` -- the
    cache write and the attention over it
    (``kernels.attention.ops._cache_attention``) -- on each rank's own split of
    a DTensor cache (B, Tk, Hkv, hd), placed by ``sharding.cache_shardings``:
    the batch over the data axes, then the KV heads over ``model``, else
    the sequence.  Over a split of the batch or the heads, q, k and v come
    split alike and each rank writes and attends its own rows and heads.
    Over a split of the sequence they come whole; each rank writes the
    new rows that fall in its slots and scores its own keys, and the
    softmax's max and sum and the output are reduced over the split
    (flash-decoding's combine: all-reduces of (B, Hq, T, ...), never the
    cache).  Over a split of the head dim, q, k and v come split alike
    and the partial scores are summed.  A layer of a cache split by layer
    (:func:`_select`: the holder's slice, the others' zeros) is attended
    by every rank on its own KV heads where they divide over the split
    (:func:`_by_heads`): q, k and v split alike, the holder's
    slice reduce-scattered onto the ranks' heads where the call reads
    old rows (a decode step: one layer's cache a step, each rank its
    share) and zeros where it does not (a prefill from row 0), and the
    new rows gathered whole for the holder to write -- so that no rank
    scores every head while the others wait.  Else the holder writes and
    attends the whole layer, a partial sum of the others' zeros.  No
    cache leaf is gathered.  Serving only (no autograd)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from ..kernels.attention.ops import reads_old_rows, write_cache

    ck, cv = cache["k"], cache["v"]
    mesh = ck.device_mesh
    Hq, Hkv = q.shape[2], ck.shape[2]
    heads = 1                    # the ranks a mesh dim splits the heads over
    for i, p in enumerate(ck.placements):
        heads *= mesh.size(i) if p.is_shard(2) else 1
    qkv_pl, out_pl, seq, feat, layer = [], [], [], [], []
    for i, p in enumerate(ck.placements):
        n = mesh.size(i)
        if p.is_shard(3):
            # the head dim (the reference's rule splits the longest axis,
            # which at short lengths may be it): partial scores
            qkv_pl.append(Shard(3))
            out_pl.append(Shard(3))
            feat.append(i)
        elif p.is_partial() and not layer and _by_heads(Hq, Hkv, heads * n):
            # a layer of a cache split by layer: each rank its KV heads
            qkv_pl.append(Shard(2))
            out_pl.append(Shard(1))
            layer.append(i)
        elif p.is_partial():
            # ... or the rank that holds it writes and attends, the others
            # give zeros
            qkv_pl.append(R)
            out_pl.append(Partial())
        elif p.is_shard(0):
            qkv_pl.append(Shard(0))
            out_pl.append(Shard(0))
        elif p.is_shard(2) and Hq % mesh.size(i) == 0:
            qkv_pl.append(Shard(2))
            out_pl.append(Shard(1))
        elif p.is_shard(1) or p.is_replicate():
            seq += [i] if p.is_shard(1) else []
            qkv_pl.append(R)
            out_pl.append(R)
        else:
            raise NotImplementedError(
                f"a cache placed {tuple(ck.placements)}")

    def local(t, placements=qkv_pl):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [R] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, placements).to_local()

    shape, offset = compute_local_shape_and_global_offset(
        ck.shape, mesh, ck.placements)
    idx = cache_index
    if isinstance(idx, torch.Tensor) and idx.dim() == 1:
        # per-slot positions: this rank's rows of the batch
        if isinstance(idx, DTensor):
            idx = idx.full_tensor()
        idx = idx[offset[0]:offset[0] + shape[0]]

    def over(dims):
        def reduce(t, op="sum"):
            for i in dims:
                t = funcol.all_reduce(t, op, (mesh, i))
            return funcol.wait_tensor(t)

        return reduce if dims else None

    B, T, _, hd = q.shape
    ckl, cvl = ck.to_local(), cv.to_local()
    kw = dict(causal=causal, lo=offset[1], Tk=ck.shape[1], reduce=over(seq),
              hd=q.shape[3], reduce_scores=over(feat))
    if layer:
        # the new rows of every head (an all-gather over the layer's mesh
        # dim), this rank's heads of them, and its heads of the layer
        i = layer[0]
        whole = [R if j == i else p for j, p in enumerate(qkv_pl)]
        kn, vn = local(k, whole), local(v, whole)
        h = kn.shape[2] // mesh.size(i)
        at = mesh.get_local_rank(i) * h
        mine = [Shard(2) if j == i else p for j, p in enumerate(ck.placements)]
        if reads_old_rows(cache_index):
            ckh, cvh = _moved(ck, mine), _moved(cv, mine)
        else:
            rows, _ = compute_local_shape_and_global_offset(ck.shape, mesh,
                                                            mine)
            ckh, cvh = ckl.new_zeros(rows), cvl.new_zeros(rows)
        o = fn(local(q), kn[:, :, at:at + h], vn[:, :, at:at + h], ckh, cvh,
               idx, **kw)
        if _holds(ckl):
            write_cache(kn, vn, ckl, cvl, idx, lo=offset[1], Tk=ck.shape[1])
    else:
        ql, kl, vl = local(q), local(k), local(v)
        if _holds(ckl):
            o = fn(ql, kl, vl, ckl, cvl, idx, **kw)
        else:
            o = ql.new_zeros((ql.shape[0], ql.shape[2], T, ql.shape[3]))
    return DTensor.from_local(o, mesh, out_pl, run_check=False,
                              shape=torch.Size((B, Hq, T, hd)),
                              stride=(Hq * T * hd, T * hd, hd, 1))
