"""Parameter / activation sharding rules, as the reference's
``repro/distributed/sharding.py``, and their DTensor placements.

Megatron-style TP over the ``model`` axis, DP over ``pod``+``data``:

  * embeddings & LM head: vocab-sharded (the head's logits stay split
    on V and the loss picks its labels by a masked sum; the lookup is
    Megatron's, :mod:`.rules`);
  * attention: head-sharded QKV (column) / output row-sharded;
  * MLP: column-parallel up/gate, row-parallel down;
  * MoE: expert-parallel (experts over ``model``);
  * mamba/xLSTM: inner-dim column/row split, state sharded on the inner
    dim;
  * norms/scalars: replicated.

Rules are matched against flattened parameter path names (``/``-joined
dict keys and list indices, the reference's ``_path_str``), and specs
are left-padded with None to the leaf rank (stacked-layer leading axes
stay unsharded).

A spec is a tuple with one entry a tensor dim: None, an axis name, or a
tuple of axis names (the reference's ``PartitionSpec`` entries).  The
spec functions (:func:`spec_for_param`, :func:`param_specs`,
:func:`batch_specs`, :func:`cache_specs`, :func:`extend_with_dp`) are
pure functions of axis names and sizes: they take a ``DeviceMesh`` or a
:class:`~repro_torch.launch.mesh.MeshShape`, and leaves that are tensors
(``meta`` ones too) or ``(shape, dtype)`` pairs.  :func:`to_placements`
turns a spec into DTensor placements on a ``DeviceMesh``
(:func:`placements_of`: a tree of them); :func:`place` places a tree by
them, :func:`distribute_state` and :func:`distribute_batch` a train
state and a batch.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..launch.mesh import Mesh, axis_names, axis_sizes, data_axes
from ..memory.channels import H100_SXM
from ..tree import named_leaves, tree_leaves, tree_unflatten
from . import rules  # registers DTensor's rules

#: (path regex, spec for trailing dims)
PARAM_RULES: List[Tuple[str, Tuple]] = [
    # embeddings / head
    (r"embed/tok$", ("model", None)),
    (r"head/w$", (None, "model")),
    # attention
    (r"(attn|self_attn|cross_attn)/wq/w$", (None, "model")),
    (r"(attn|self_attn|cross_attn)/wk/w$", (None, "model")),
    (r"(attn|self_attn|cross_attn)/wv/w$", (None, "model")),
    (r"(attn|self_attn|cross_attn)/w[qkv]/b$", ("model",)),
    (r"(attn|self_attn|cross_attn)/wo/w$", ("model", None)),
    (r"(attn|self_attn|cross_attn)/wo/b$", (None,)),
    (r"(q_norm|k_norm)/scale$", (None,)),
    # dense MLP
    (r"mlp/(gate|up)/w$", (None, "model")),
    (r"mlp/(gate|up)/b$", ("model",)),
    (r"mlp/down/w$", ("model", None)),
    (r"mlp/down/b$", (None,)),
    # MoE: expert parallel
    (r"moe/router/w$", (None, None)),
    (r"moe/w_(gate|up)$", ("model", None, None)),
    (r"moe/w_down$", ("model", None, None)),
    # mamba
    (r"mamba/in_proj/w$", (None, "model")),
    (r"mamba/conv_w$", (None, "model")),
    (r"mamba/conv_b$", ("model",)),
    (r"mamba/x_proj/w$", ("model", None)),
    (r"mamba/dt_proj/w$", (None, "model")),
    (r"mamba/dt_proj/b$", ("model",)),
    (r"mamba/A_log$", ("model", None)),
    (r"mamba/D$", ("model",)),
    (r"mamba/out_proj/w$", ("model", None)),
    # xLSTM
    (r"core/w[zqkv]/w$", (None, "model")),
    (r"core/w(i|f|o_gate)/w$", (None, "model")),
    (r"core/w(i|f|o_gate|z|q|k|v)/b$", ("model",)),
    (r"core/wo/w$", ("model", None)),
    # norms and anything else scalar-ish: replicated (fallback below)
]


#: the params split on the vocab: the embedding table and the LM head
VOCAB_PARAMS = r"(^|/)(embed/tok|head/w)$"

#: when True, params replicate and the batch shards over EVERY mesh axis
#: -- the right mapping for models too small to amortize TP collectives
DP_ONLY = False

Spec = Tuple[Any, ...]


# -- trees ----------------------------------------------------------------------

def _is_leaf(t) -> bool:
    """A spec, a placement tuple or a ``(shape, dtype)`` pair: a leaf."""
    return isinstance(t, tuple)


def _leaves(tree) -> list:
    return tree_leaves(tree, is_leaf=_is_leaf)


def _map(fn, tree, *rest):
    """A tree like ``tree`` with ``fn(path_str, leaf, *leaves of rest)`` at
    every leaf (paths ``/``-joined, the reference's ``_path_str``; ``rest``
    trees shaped alike)."""
    named = named_leaves(tree, is_leaf=_is_leaf)
    others = [_leaves(r) for r in rest]
    return tree_unflatten(
        tree, [fn(path.replace(".", "/"), leaf, *(o[i] for o in others))
               for i, (path, leaf) in enumerate(named)], is_leaf=_is_leaf)


def _shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, tuple):        # (shape, dtype)
        return tuple(leaf[0])
    return tuple(leaf.shape)


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


# -- specs ----------------------------------------------------------------------

def spec_for_param(path_str: str, ndim: int, mesh: Mesh) -> Spec:
    if DP_ONLY:
        return ()
    axis_ok = set(axis_names(mesh))
    for pat, trailing in PARAM_RULES:
        if re.search(pat, path_str):
            t = tuple(a if (a in axis_ok) else None for a in trailing)
            pad = (None,) * (ndim - len(t))
            return pad + t
    return ()  # replicated


def _divisible(shape, spec: Spec, mesh: Mesh) -> Spec:
    """Drop sharding on axes that do not divide evenly (e.g. 6 heads on a
    16-way model axis for whisper-tiny): correctness first."""
    sizes = axis_sizes(mesh)
    fixed = []
    for dim, s in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if s is None:
            fixed.append(None)
            continue
        axes = s if isinstance(s, tuple) else (s,)
        total = _prod(sizes[a] for a in axes)
        fixed.append(s if dim % total == 0 else None)
    return tuple(fixed)


def param_specs(params: Any, mesh: Mesh) -> Any:
    """A spec for every leaf of a params tree (tensors or (shape, dtype)).
    The vocab the tree's embedding or head splits becomes
    ``rules.VOCAB_SPLIT``, replacing the last tree's (its head's product
    keeps the split)."""
    vocab = set()

    def one(path, leaf):
        shape = _shape(leaf)
        spec = _divisible(shape, spec_for_param(path, len(shape), mesh), mesh)
        dim = {"tok": 0, "w": 1}.get(path.rsplit("/", 1)[-1])
        if re.search(VOCAB_PARAMS, path) and spec[dim - len(shape)]:
            vocab.add(shape[dim - len(shape)])
        return spec

    out = _map(one, params)
    rules.set_vocab_split(vocab)
    return out


def _dp(mesh: Mesh) -> tuple:
    return (tuple(axis_names(mesh)) if DP_ONLY else data_axes(mesh))


def _entry(axes: tuple):
    """A spec entry for ``axes``: a lone axis by its name, as a
    ``PartitionSpec`` normalizes ``("data",)``; none as None."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def batch_specs(batch: Any, mesh: Mesh) -> Any:
    """Shard the leading (global-batch) axis over the DP axes when it
    divides; else replicate."""
    dp = _dp(mesh)
    total = _prod(axis_sizes(mesh)[a] for a in dp)

    def one(path, leaf):
        shape = _shape(leaf)
        if len(shape) == 0:
            return ()
        if shape[0] % total == 0:
            return (_entry(dp),) + (None,) * (len(shape) - 1)
        return ()

    return _map(one, batch)


def cache_specs(cache: Any, cfg, mesh: Mesh, *, batch: int) -> Any:
    """KV-cache / recurrent-state specs for serving.

    Preference order per leaf: shard batch over DP if divisible; shard the
    kv-head axis over ``model`` if divisible; otherwise shard the longest
    (sequence) axis over ``model`` (flash-decoding combine), else
    replicate.  For batch=1 long-context decode this naturally picks the
    sequence axis.
    """
    sizes = axis_sizes(mesh)
    dp = data_axes(mesh)
    dp_total = _prod(sizes[a] for a in dp)
    m = sizes.get("model", 1)

    def one(path, leaf):
        shape = _shape(leaf)
        if len(shape) == 0:
            return ()
        spec: List = [None] * len(shape)
        # find the batch axis: the first axis equal to `batch`
        b_ax = next((i for i, d in enumerate(shape) if d == batch), None)
        used_model = False
        if b_ax is not None and batch % dp_total == 0 and batch >= dp_total:
            spec[b_ax] = _entry(dp)
        # kv-head / feature axis over model: prefer an axis == n_kv_heads
        for i, d in enumerate(shape):
            if i == b_ax:
                continue
            if d == cfg.n_kv_heads and d % m == 0:
                spec[i] = "model"
                used_model = True
                break
        if not used_model:
            # longest remaining axis over model (sequence, inner dim, ...)
            cand = max(
                (d, i) for i, d in enumerate(shape) if i != b_ax
            )[1] if len(shape) > (0 if b_ax is None else 1) else None
            if cand is not None and shape[cand] % m == 0 and shape[cand] >= m:
                spec[cand] = "model"
        # batch not shardable over full dp: try just "data"
        if b_ax is not None and spec[b_ax] is None:
            d_sz = sizes.get("data", 1)
            if batch % d_sz == 0 and batch >= d_sz:
                spec[b_ax] = "data"
        return tuple(spec)

    return _map(one, cache)


def extend_with_dp(specs: Any, shapes: Any, mesh: Mesh) -> Any:
    """Add data-parallel sharding on top of the TP specs (ZeRO/FSDP).

    For each leaf, the first dimension that is still unsharded and divides
    by the DP degree gets the DP axes.  Used for optimizer moments
    (ZeRO-1) and for weight-gathered serving of very large models: the
    stacked-layer leading axis usually absorbs it (e.g. 64 layers over 16
    data shards), otherwise a feature dim does.
    """
    dp = data_axes(mesh)
    sizes = axis_sizes(mesh)
    dp_total = _prod(sizes[a] for a in dp)

    def one(path, leaf, sh):
        shape = _shape(leaf)
        spec = list(tuple(sh) + (None,) * (len(shape) - len(sh)))
        for i, d in enumerate(shape):
            if spec[i] is None and d % dp_total == 0 and d >= dp_total:
                spec[i] = _entry(dp)
                break
        return tuple(spec)

    return _map(one, shapes, specs)


def params_fit_replicated_dp(params: Any, mesh: Mesh,
                             hbm_budget: int = H100_SXM.hbm_bytes) -> bool:
    """True if TP-only params fit the per-device budget (else use FSDP).

    The default budget is the H100's 80 GiB of HBM (the reference's 8 GiB
    is a TPU figure); pass ``hbm_budget`` to hold another device."""
    m = axis_sizes(mesh).get("model", 1)
    total = 0
    for leaf in _leaves(params):
        dtype = leaf[1] if isinstance(leaf, tuple) else leaf.dtype
        total += _prod(_shape(leaf)) * dtype.itemsize
    return total / m <= hbm_budget


# -- placements -------------------------------------------------------------------

def replicated(mesh) -> tuple:
    """Every mesh dim replicated."""
    return (Replicate(),) * mesh.ndim


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that tensor dim ``d`` names (a tuple of axes shards ``d`` over
    each of them, major to minor in mesh order), ``Replicate()`` on the
    rest."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, s in enumerate(spec):
        for a in (s if isinstance(s, tuple) else (() if s is None else (s,))):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def param_shardings(params: Any, mesh) -> Any:
    """The placements of every leaf of a params tree."""
    return _map(lambda path, leaf, spec: to_placements(spec, mesh), params,
                param_specs(params, mesh))


def batch_shardings(batch: Any, mesh) -> Any:
    """The placements of every leaf of a batch (:func:`batch_specs`)."""
    return _map(lambda path, leaf, spec: to_placements(spec, mesh), batch,
                batch_specs(batch, mesh))


def cache_shardings(cache: Any, cfg, mesh, *, batch: int) -> Any:
    """The placements of every leaf of a cache (:func:`cache_specs`)."""
    return _map(lambda path, leaf, spec: to_placements(spec, mesh), cache,
                cache_specs(cache, cfg, mesh, batch=batch))


def placements_of(specs: Any, mesh) -> Any:
    """The placements of every spec of a tree (:func:`to_placements`)."""
    return _map(lambda path, spec: to_placements(spec, mesh), specs)


def local_shard(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of a full tensor that every rank holds alike (no
    communication; at world size 1 the tensor itself)."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if t.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                                 f"divide over {n} ranks")
            t = t.chunk(n, dim=p.dim)[coord[i]]
    return t.contiguous()


def distribute(t: torch.Tensor, mesh, placements) -> DTensor:
    """A full tensor, alike on every rank, as a DTensor of ``placements``
    (its local shard may share storage with ``t``)."""
    return DTensor.from_local(local_shard(t, mesh, placements), mesh,
                              placements, run_check=False)


def place(tree: Any, placements: Any, mesh) -> Any:
    """Every leaf of ``tree`` (full tensors, alike on every rank) as a
    DTensor of its placements in ``placements``, a tree shaped alike."""
    return _map(lambda path, t, p: distribute(t, mesh, p), tree, placements)


def distribute_state(state: Dict[str, Any], mesh) -> Dict[str, Any]:
    """A train state (``params``, ``opt_state`` {mu, nu, step}, ``step``),
    alike on every rank, as DTensors: params by :func:`param_shardings`,
    the moments by their params' placements (as the reference's launcher
    places them), the steps replicated."""
    pl = param_shardings(state["params"], mesh)
    opt = state["opt_state"]
    rep = replicated(mesh)
    return {
        "params": place(state["params"], pl, mesh),
        "opt_state": {"mu": place(opt["mu"], pl, mesh),
                      "nu": place(opt["nu"], pl, mesh),
                      "step": distribute(opt["step"], mesh, rep)},
        "step": distribute(state["step"], mesh, rep),
    }


def distribute_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """A global batch, alike on every rank, as DTensors: the leading axis
    over the data axes where it divides, else replicated; each rank keeps
    its share."""
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    pl = batch_shardings(batch, mesh)
    return {k: distribute(v, mesh, pl[k]) for k, v in batch.items()}

