"""Multi-pod dry run of the port, as the reference's
``repro/launch/dryrun.py``.

For every (architecture x input-shape) cell, build the step (train step,
prefill or decode) with the production placements on the single-pod
16x16 mesh and the 2x16x16 multi-pod mesh, run it once as rank 0 of the
mesh on ``meta`` tensors, and record:

  * the memory of one device (the reference's ``memory_analysis()``
    fields) -- whether the sharded step fits;
  * per-device FLOPs and bytes for the roofline;
  * per-device collective bytes, by kind.

The reference forces 512 placeholder host devices (``XLA_FLAGS``) so
that GSPMD can partition and compile for them.  The port's counterpart
is a fake process group (``torch.testing._internal.distributed.fake_pg``)
of 256 or 512 ranks, of which this process is rank 0: the state, batch
and cache are ``meta`` tensors (shapes and dtypes, no storage) placed as
DTensors by the port's sharding rules, and a collective completes at
once without data.  Nothing is placed on the card, by design: the dry
run needs none, and runs alike on a host.

What is counted (:class:`Meter`, a dispatch mode beneath DTensor: it
sees the ops DTensor runs on rank 0's local shards, never the global
ones; the ops DTensor's sharding propagation runs on global shapes to
learn an output's shape are not counted):

  * ``flops``: the FLOPs of the matrix products, by
    ``torch.utils.flop_counter``'s registry (the ops ``FlopCounterMode``
    counts, with ``FLOP_FORMULAS``).  XLA's count adds the elementwise
    FLOPs.  With ``attn_impl="auto"`` attention runs the flash kernels'
    ops (``repro_torch::flash_fwd``, ``repro_torch::flash_bwd``: shapes
    only on ``meta``), counted by their work -- 4 d flops a visible
    (query, key) pair forward, 10 d backward -- where ``"xla"`` counts
    its two whole (B, H, T, T) products and their gradients;
  * ``bytes``: the operand bytes plus result bytes of every local op
    that moves data -- views move nothing, collectives are booked apart.
    An eager program's traffic, where XLA's ``bytes accessed`` is its
    fused program's;
  * collective bytes: the result bytes of every collective DTensor
    issues for rank 0 (the reference's convention,
    ``analysis.roofline``), booked under the reference's five kinds; an
    all-to-all DTensor asks for is booked as one where a CPU group would
    run it as an all-gather;
  * memory: ``argument_size_in_bytes`` is rank 0's local bytes of the
    arguments the step reads, exact from the placements (``jax.jit``
    drops unused arguments; a decode's write position, a Python int
    here, counts as the reference's int32 scalar); ``temp_size_in_bytes`` the
    peak of live local bytes above them while the step runs, by storage
    lifetime; ``output_size_in_bytes`` the local bytes of the results,
    ``alias_size_in_bytes`` those of them written into an argument in
    place -- the port's donation: the train step updates its state in
    place, prefill and decode write the cache.

The meter replaces private DTensor functions while it runs (sharding
propagation's pass over global shapes, its all-to-all, and the
redistribution planner's graph search where the version has one); a
torch without them is refused with its version, never counted
otherwise.  DTensor's choice of collectives differs between torch
versions, so every record carries ``torch_version``.

Products of bfloat16 operands take the card's route on ``meta``
(``core.precision.matmul_f32``), so the counts are the card's.  The
xLSTM's and jamba's step loops run ``T`` steps in Python; their long
cells are composed from short runs (:mod:`..analysis.scancost`).

Results land in ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference's keys (``lower_s``: building the placed state;
``compile_s``: running the step on ``meta``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k --mesh single           # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k --attn-impl auto        # the kernel path
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all       # sweep
  PYTHONPATH=src python -m repro_torch.analysis.aggregate        # tables
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.distributed.tensor.placement_types import _StridedShard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

from .. import configs
from ..analysis import roofline, scancost
from ..configs import shapes as shape_mod
from ..distributed import sharding as shard_rules
from ..kernels.attention import attention as _flash_ops  # noqa: F401  (ops)
from ..kernels.attention import ref as attn_ref
from ..models import build_model
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_init
from ..runtime.train import make_train_step
from . import mesh as mesh_mod

RESULTS_DIR = os.path.join("results", "dryrun_torch")
#: a cell still propagating shardings after this long is recorded as an
#: error, so that a sweep ends (torch 2.13's DTensor expands an op's
#: sharding strategies over every mesh dim: minutes an op on the 3-D mesh)
CELL_BUDGET_S = 600
MESHES = {"single": mesh_mod.make_production_mesh(),
          "multipod": mesh_mod.make_production_mesh(multi_pod=True)}

_CAP_FACTOR_OVERRIDE: Optional[float] = None


def _moe_capacity(cfg: ModelConfig, n_tokens: int) -> Optional[int]:
    if cfg.moe is None:
        return None
    m = cfg.moe
    f = _CAP_FACTOR_OVERRIDE if _CAP_FACTOR_OVERRIDE else m.capacity_factor
    cap = int(n_tokens * m.top_k / m.n_experts * f)
    return max(cap, 8)


def _active_params(cfg: ModelConfig) -> int:
    """Active parameter count for MODEL_FLOPS (MoE: top_k of n_experts)."""
    total = cfg.param_count()
    if cfg.moe is None:
        return total
    # subtract inactive expert fraction
    m = cfg.moe
    d = cfg.d_model
    expert = (3 if cfg.act == "swiglu" else 2) * d * m.d_ff_expert
    if cfg.family == "moe":
        n_moe_layers = cfg.n_layers
    else:  # jamba: MoE on odd layers
        n_moe_layers = cfg.n_layers // 2
    inactive = n_moe_layers * (m.n_experts - m.top_k) * expert
    return total - inactive


# -- the fake group and its mesh ----------------------------------------------------

def fake_mesh(shape: mesh_mod.MeshShape):
    """A ``DeviceMesh`` of ``shape`` over a fake process group of its
    size, this process rank 0 (a fake group of another size is replaced;
    any other default group is refused)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 1
    for n in shape.shape:
        world *= n
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a default process group exists; the dry run "
                               "needs a fake one of its own")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return init_device_mesh("cpu", shape.shape,
                            mesh_dim_names=shape.axis_names)


def release_fake_group() -> None:
    """Destroy the fake default group, if one exists."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


# -- the meter ---------------------------------------------------------------------

def _bmm_flops(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """``bmm``'s FLOPs, of the plain overload and of ``bmm.dtype`` (its
    ``out_dtype`` argument, which ``torch.utils.flop_counter``'s own
    formula refuses)."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[2]


def _flash_fwd_flops(q_shape, k_shape, v_shape, n_q_heads, n_kv_heads,
                     causal, scale, block_q, block_k, *_, out_shape=None,
                     **__) -> int:
    """The flash forward's work (``repro_torch::flash_fwd``): 4 d flops
    (QK^T and PV) a visible pair of each query head, pairs by the
    reference's visit rule (``kernels.attention.ref.visible_pairs``)."""
    G, Tq, d = q_shape
    Tk = k_shape[1]
    bq, bk = attn_ref.check_blocks(Tq, Tk, block_q, block_k)
    return 4 * d * G * attn_ref.visible_pairs(Tq, Tk, bq, bk, causal)


def _flash_bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape,
                     do_shape, n_q_heads, n_kv_heads, causal, *_,
                     out_shape=None, **__) -> int:
    """The flash backward's work (``repro_torch::flash_bwd``): 10 d flops
    a visible pair (S, dP, dV, dQ, dK), every row seeing a key (``Tq <=
    Tk``)."""
    G, Tq, d = q_shape
    Tk = k_shape[1]
    return 10 * d * G * attn_ref.visible_pairs(Tq, Tk, Tq, Tk, causal)


#: formulas beside ``torch.utils.flop_counter``'s, by shapes: give them
#: to ``FlopCounterMode(custom_mapping=FLOP_FORMULAS)`` to count alike.
#: The flash kernels' ops count the work, not a kernel's own products
FLOP_FORMULAS = {torch.ops.aten.bmm: _bmm_flops,
                 torch.ops.repro_torch.flash_fwd: _flash_fwd_flops,
                 torch.ops.repro_torch.flash_bwd: _flash_bwd_flops}


def _shape(x):
    return x.shape if isinstance(x, torch.Tensor) else x


def _flops(func, args, kwargs, out) -> int:
    packet = func._overloadpacket
    own = FLOP_FORMULAS.get(packet)
    if own is not None:
        args, kwargs, out = tree_map(_shape, (args, kwargs, out))
        return own(*args, out_shape=out, **kwargs)
    count = flop_registry.get(packet)
    return 0 if count is None else count(*args, **kwargs, out_val=out)


_KINDS = (("all_reduce", "all-reduce"), ("all_gather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
          ("permute", "collective-permute"))


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _size(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _key(t) -> int:
    return t.untyped_storage()._cdata


def _greedy(_search: Callable) -> Callable:
    """DTensor's redistribution planner, greedy as by default where torch
    2.13 would switch to its graph search (shard orders off the mesh
    order): on the 3-D mesh that search held one xLSTM cell for over 40
    minutes.  The greedy plan cannot read ``_StridedShard``, which the
    port's view rule (``distributed.rules``) leaves on no activation."""
    from torch.distributed.tensor import _redistribute

    def plan(src, dst, use_graph_based_transform=None):
        return _redistribute.get_redistribute_planner(
            src.device_mesh, src.tensor_meta
        ).generate_greedy_transform_infos(src, dst)

    return plan


class Meter(TorchDispatchMode):
    """Counts rank 0's local work while active (see the module
    docstring): ``flops``, ``bytes``, ``coll`` ({kind: result bytes})
    and the peak of live bytes above ``args`` (``peak``, and ``top``,
    the largest temporaries live at it: bytes, shape, dtype and the op
    that made each, snapshot where the peak grew 1 %); ``strided``,
    the DTensor ops that read an input placed ``_StridedShard`` (the
    port's rules leave none: DTensor plans such a placement's
    redistributions by a graph search)."""

    def __init__(self, args: Any = ()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = dict.fromkeys(roofline.COLLECTIVES, 0)
        self.arg_keys = {_key(_local(t)) for t in _tensors(args)}
        self.used = set()
        self.live = 0
        self.peak = 0
        self.top: list = []
        self._top_at = 0
        self.strided = 0
        self._refs: Dict[int, list] = {}
        self._quiet = 0
        self._views: Dict[Any, bool] = {}
        self._patches: list = []

    # ops run for DTensor's bookkeeping, not by a rank
    def _quietly(self, fn: Callable, book: Optional[str] = None) -> Callable:
        def wrapped(*args, **kwargs):
            self._quiet += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self._quiet -= 1
            if book is not None and not self._quiet:
                ins, outs = _tensors(args), _tensors(out)
                self.coll[book] += _size(outs)
                self._read(ins)
                self._track(outs, ins, book)
            return out
        return wrapped

    @staticmethod
    def _need(owner, name: str):
        fn = owner.__dict__.get(name)
        if fn is None:
            raise RuntimeError(
                f"torch {torch.__version__}: DTensor has no "
                f"{owner.__name__}.{name}, which the dry run's meter "
                "needs; without it the counts would be wrong")
        return fn

    def _patch(self, owner, name: str, wrap: Callable) -> None:
        fn = self._need(owner, name)
        self._patches.append((owner, name, fn))
        setattr(owner, name, wrap(fn))

    def __enter__(self):
        import inspect

        from torch.distributed.tensor import (_redistribute, _sharding_prop,
                                              placement_types)

        try:
            # every path of sharding propagation to a global output shape
            self._patch(_sharding_prop.ShardingPropagator,
                        "_propagate_tensor_meta_non_cached", self._quietly)
            # a Shard(i) -> Shard(j) redistribution: DTensor's all-to-all
            self._patch(placement_types, "shard_dim_alltoall",
                        lambda fn: self._quietly(fn, book="all-to-all"))
            # a planner with a graph search plans greedily here
            plan = self._need(_redistribute,
                              "_gen_transform_infos_non_cached")
            self._need(_redistribute, "_gen_transform_infos")
            if "use_graph_based_transform" in inspect.signature(
                    plan).parameters:
                self._need(_redistribute, "get_redistribute_planner")
                self._patch(_redistribute, "_gen_transform_infos_non_cached",
                            _greedy)
        except RuntimeError:
            self._restore()
            raise
        _redistribute._gen_transform_infos.cache_clear()
        return super().__enter__()

    def _restore(self) -> None:
        for owner, name, fn in reversed(self._patches):
            setattr(owner, name, fn)
        self._patches.clear()

    def __exit__(self, *exc):
        from torch.distributed.tensor import _redistribute

        self._restore()
        _redistribute._gen_transform_infos.cache_clear()
        return super().__exit__(*exc)

    def _read(self, tensors) -> None:
        for t in tensors:
            k = _key(t)
            if k in self.arg_keys:
                self.used.add(k)

    def _release(self, key: int) -> None:
        ref = self._refs[key]
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]

    def _track(self, outs, ins, op: str) -> None:
        ids = {id(t) for t in ins}
        for t in outs:
            if id(t) in ids:
                continue                         # written in place
            key = _key(t)
            if key in self.arg_keys:
                continue
            ref = self._refs.get(key)
            if ref is None:
                ref = self._refs[key] = [t.untyped_storage().nbytes(), 0,
                                         (tuple(t.shape), str(t.dtype), op)]
                self.live += ref[0]
                self.peak = max(self.peak, self.live)
            ref[1] += 1
            weakref.finalize(t, self._release, key)
        if self.peak > 1.01 * self._top_at:
            self._top_at = self.peak
            self.top = sorted(([r[0], *r[2]] for r in self._refs.values()),
                              reverse=True)[:5]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self.strided += any(
                isinstance(p, _StridedShard)
                for t in _tensors((args, kwargs)) if isinstance(t, DTensor)
                for p in t.placements)
            return NotImplemented                # DTensor runs it locally
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        view = self._views.get(func)
        if view is None:
            view = self._views[func] = _is_view(func)
        if not view:
            self._read(ins)
        if "c10d" in func.namespace:
            name = func._schema.name
            kind = next((k for s, k in _KINDS if s in name), None)
            if kind is not None:
                self.coll[kind] += _size(outs)
            self._track(outs, ins, str(func))
            return out
        self.flops += _flops(func, args, kwargs, out)
        if not view:
            self.bytes += _size(ins) + _size(outs)
        self._track(outs, ins, str(func))
        return out


def measure(fn: Callable, args: tuple, *, donated: tuple = (),
            scalar_args: int = 0) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under a :class:`Meter`: its counts and the
    reference's ``memory_analysis()`` fields.  ``donated``: the indices
    of the arguments the step may write (for ``alias_size_in_bytes``);
    ``scalar_args``: int32 scalars the step takes as Python ints, which
    the reference passes as arguments (a decode's write position)."""
    arg_locals = [_local(t) for t in _tensors(args)]
    donated_keys = {_key(_local(t)) for i in donated
                    for t in _tensors(args[i])}
    meter = Meter(args)
    t0 = time.time()
    with meter:
        out = fn(*args)
    seconds = time.time() - t0
    seen, out_bytes, alias = set(), 0, 0
    for t in _tensors(out):
        t = _local(t)
        if _key(t) in seen:
            continue
        seen.add(_key(t))
        n = t.numel() * t.element_size()
        out_bytes += n
        alias += n if _key(t) in donated_keys else 0
    return {
        "flops": int(meter.flops),
        "bytes": int(meter.bytes),
        "collectives": dict(meter.coll),
        "memory": {
            "argument_size_in_bytes": 4 * scalar_args + sum(
                t.numel() * t.element_size() for t in arg_locals
                if _key(t) in meter.used),
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": meter.peak,
            "alias_size_in_bytes": alias,
        },
        "seconds": seconds,
        "strided_ops": meter.strided,
        "peak_top": meter.top,
    }


# -- cells ---------------------------------------------------------------------------

def _meta(spec_tree):
    """``meta`` tensors of a tree of ``(shape, dtype)`` pairs."""
    if isinstance(spec_tree, dict):
        return {k: _meta(v) for k, v in spec_tree.items()}
    shape, dtype = spec_tree
    return torch.empty(shape, dtype=dtype, device="meta")


def _placed_batch(batch, mesh):
    return shard_rules.place(batch, shard_rules.batch_shardings(batch, mesh),
                             mesh)


def build_cell(cfg: ModelConfig, shape_name: str, mesh,
               attn_impl: str = "xla", grad_accum: int = 1,
               seq_len: Optional[int] = None) -> Dict[str, Any]:
    """The cell's step as ``fn``, its placed ``meta`` arguments ``args``,
    the indices it writes in place ``donated`` (and ``scalar_args``, see
    :func:`measure`), and ``model_flops``.
    ``seq_len`` replaces the shape's length of the tokens (a prefill's
    prompt; the cache keeps the shape's length)."""
    spec = shape_mod.SHAPES[shape_name]
    B = spec.global_batch
    T = spec.seq_len if seq_len is None else seq_len
    model = build_model(cfg, attn_impl=attn_impl, device="meta")
    params = model.init(None)
    pspecs = shard_rules.param_specs(params, mesh)
    fits = shard_rules.params_fit_replicated_dp(params, mesh)
    batch_specs = shape_mod.input_specs(cfg, shape_name)
    batch_specs = {k: ((B, T) if k in ("tokens", "labels") else s, dt)
                   for k, (s, dt) in batch_specs.items()}
    n_tokens = B * T
    kw = dict(params=cfg.param_count(), active_params=_active_params(cfg))

    if spec.kind == "train":
        # ZeRO-1: optimizer moments additionally sharded over the DP axes
        # (the stacked-layer axis usually absorbs it); FSDP the params
        # themselves when TP-only residency is too large
        mspecs = shard_rules.extend_with_dp(pspecs, params, mesh)
        if not fits:
            pspecs = mspecs
        opt = adamw_init(params)
        rep = shard_rules.replicated(mesh)
        m_pl = shard_rules.placements_of(mspecs, mesh)
        state = {
            "params": shard_rules.place(
                params, shard_rules.placements_of(pspecs, mesh), mesh),
            "opt_state": {
                "mu": shard_rules.place(opt["mu"], m_pl, mesh),
                "nu": shard_rules.place(opt["nu"], m_pl, mesh),
                "step": shard_rules.distribute(opt["step"], mesh, rep),
            },
            "step": shard_rules.distribute(
                torch.zeros((), dtype=torch.int32, device="meta"), mesh, rep),
        }
        step = make_train_step(model, AdamWConfig(),
                               moe_capacity=_moe_capacity(cfg, n_tokens),
                               grad_accum=grad_accum)
        return {
            "fn": step,
            "args": (state, _placed_batch(_meta(batch_specs), mesh)),
            "donated": (0,),
            "model_flops": roofline.model_flops(
                tokens=n_tokens, kind="train", **kw),
        }

    # serving cells (the plain tensors the model makes meet DTensors as
    # replicated, as in the train step): weight-gathered (FSDP-style)
    # placement when the model is too large for TP-only residency
    if not fits:
        pspecs = shard_rules.extend_with_dp(pspecs, params, mesh)
    placed = shard_rules.place(params, shard_rules.placements_of(pspecs, mesh),
                               mesh)
    cache = model.init_cache(B, spec.seq_len)
    cache = shard_rules.place(
        cache, shard_rules.cache_shardings(cache, cfg, mesh, batch=B), mesh)

    if spec.kind == "prefill":
        cap = _moe_capacity(cfg, n_tokens)

        def prefill(params, batch, cache):
            with implicit_replication():
                return model.prefill(params, batch, cache, moe_capacity=cap)

        return {
            "fn": prefill,
            "args": (placed, _placed_batch(_meta(batch_specs), mesh), cache),
            "donated": (2,),
            "model_flops": roofline.model_flops(
                tokens=n_tokens, kind="prefill", **kw),
        }

    # decode: one token against a seq_len cache, written at its last slot
    dcap = _moe_capacity(cfg, B)

    def decode(params, token, cache):
        with implicit_replication():
            return model.decode_step(params, token, cache, spec.seq_len - 1,
                                     moe_capacity=dcap)

    token = _placed_batch({"token": _meta(batch_specs["token"])}, mesh)
    return {
        "fn": decode,
        "args": (placed, token["token"], cache),
        "donated": (2,),
        # the xLSTM's decode ignores its position, and jit drops it
        "scalar_args": 0 if cfg.family == "ssm_xlstm" else 1,
        "model_flops": roofline.model_flops(
            tokens=B, kind="decode", **kw),
    }


def set_dispatch(mesh, dp_only: bool) -> None:
    """The MoE dispatch's placement (``models.moe.set_ep_sharding``):
    grouped dispatch -- one group per DP shard, experts over the model
    axis (GShard 2D layout); ``dp_only`` replicates the experts and
    shards groups over every axis."""
    from ..models import moe as moe_mod

    names = mesh_mod.axis_names(mesh)
    sizes = mesh_mod.axis_sizes(mesh)
    dp_axes = mesh_mod.data_axes(mesh)
    dp_total = 1
    for a in dp_axes:
        dp_total *= sizes[a]
    if dp_only:
        total = 1
        for a in names:
            total *= sizes[a]
        moe_mod.set_ep_sharding(None, tuple(names), num_groups=total)
        shard_rules.DP_ONLY = True
    else:
        moe_mod.set_ep_sharding("model", dp_axes, num_groups=dp_total)
        shard_rules.DP_ONLY = False


def count_cell(cfg: ModelConfig, shape_name: str, mesh, *,
               attn_impl: str = "xla", grad_accum: int = 1,
               seq_len: Optional[int] = None) -> Dict[str, Any]:
    """Build one cell on ``mesh`` and :func:`measure` its step; adds
    ``model_flops`` and ``build_seconds``."""
    t0 = time.time()
    cell = build_cell(cfg, shape_name, mesh, attn_impl=attn_impl,
                      grad_accum=grad_accum, seq_len=seq_len)
    built = time.time() - t0
    counts = measure(cell["fn"], cell["args"], donated=cell["donated"],
                     scalar_args=cell.get("scalar_args", 0))
    counts.update(model_flops=cell["model_flops"], build_seconds=built)
    return counts


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             *, results_dir: str = RESULTS_DIR,
             attn_impl: str = "xla",
             mlstm_chunk: Optional[int] = None,
             grad_accum: int = 1,
             dp_only: bool = False,
             variant: str = "baseline") -> Dict[str, Any]:
    """Count one cell on ``mesh_kind``'s production mesh (its looping
    cells composed, :mod:`..analysis.scancost`) and write its record;
    a ruled skip is written as such, a failure (or a cell over
    ``CELL_BUDGET_S``) with its traceback."""
    cfg = configs.get(arch)
    skip = shape_mod.applicable(cfg, shape_name)
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "variant": variant, "attn_impl": attn_impl,
        "mlstm_chunk": mlstm_chunk,
        # DTensor's choice of collectives differs between versions
        "torch_version": torch.__version__,
    }
    from ..models import ssm as ssm_mod
    ssm_mod.MLSTM_CHUNK = mlstm_chunk
    if skip is not None:
        record["status"] = "skipped"
        record["reason"] = skip
        _write(record, results_dir)
        return record

    shape = MESHES[mesh_kind]
    chips = 1
    for n in shape.shape:
        chips *= n

    def expired(signum, frame):
        raise TimeoutError(f"the cell was not done in {CELL_BUDGET_S} s")

    budget = signal.signal(signal.SIGALRM, expired)
    signal.alarm(CELL_BUDGET_S)
    try:
        mesh = fake_mesh(shape)
        set_dispatch(mesh, dp_only)
        spec = shape_mod.SHAPES[shape_name]

        def count_at(seq_len):
            return count_cell(cfg, shape_name, mesh, attn_impl=attn_impl,
                              grad_accum=grad_accum, seq_len=seq_len)

        lengths = scancost.loop_lengths(cfg, shape_name, mesh,
                                        mlstm_chunk=mlstm_chunk)
        if lengths is None:
            counts = count_at(None)
            samples = {spec.seq_len: counts}
        else:
            samples = {t: count_at(t) for t in lengths}
            # MODEL_FLOPS are linear in the tokens: the full cell's
            counts = dict(samples[lengths[0]], model_flops=(
                samples[lengths[0]]["model_flops"] * spec.seq_len
                / lengths[0]))
        # loop composition (the reference corrects XLA's once-counted
        # while bodies; the port composes its long step loops)
        corr = scancost.corrections(cfg, shape_name, samples,
                                    mlstm_chunk=mlstm_chunk)
        counts = dict(counts, memory=corr["memory"])
        t_lower = sum(c["build_seconds"] for c in samples.values())
        t_compile = sum(c["seconds"] for c in samples.values())
        report = roofline.analyze(
            counts, arch=arch, shape=shape_name, mesh_name=mesh_kind,
            chips=chips, model_flops_value=counts["model_flops"],
            extra_flops=corr["flops"], extra_bytes=corr["bytes"],
        )
        report.coll_bytes += corr["coll"]
        for kind, extra in corr["coll_breakdown"].items():
            report.coll_breakdown[kind] += extra
        record["scan_correction"] = {
            "flops": corr["flops"], "bytes": corr["bytes"],
            "coll": corr["coll"], "detail": corr["detail"],
        }
        record.update(
            status="ok",
            lower_s=round(t_lower, 2),
            compile_s=round(t_compile, 2),
            memory_analysis=corr["memory"],
            # [bytes, shape, dtype, op] of the largest temporaries at the
            # peak (a composed cell's: at its shortest run)
            peak_temporaries=counts["peak_top"],
            strided_ops=sum(c["strided_ops"] for c in samples.values()),
            roofline=report.to_dict(),
        )
        ma = record["memory_analysis"]
        print(
            f"[ok] {arch} {shape_name} {mesh_kind}: "
            f"t_comp={report.t_compute:.4g}s t_mem={report.t_memory:.4g}s "
            f"t_coll={report.t_collective:.4g}s bound={report.bottleneck} "
            f"mem/dev={ma['argument_size_in_bytes']/2**30:.2f}+"
            f"{ma['temp_size_in_bytes']/2**30:.2f} GiB "
            f"(build {t_lower:.0f}s run {t_compile:.0f}s)",
            flush=True,
        )
    except Exception as e:  # a failing cell is a bug in the system
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[ERROR] {arch} {shape_name} {mesh_kind}: {e}", flush=True)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, budget)
    _write(record, results_dir)
    return record


def _write(record: Dict[str, Any], results_dir: str) -> None:
    os.makedirs(results_dir, exist_ok=True)
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}.json"
    with open(os.path.join(results_dir, name), "w") as f:
        json.dump(record, f, indent=1, default=str)


def main(argv=None) -> int:
    """The reference's CLI; exit 1 when a cell errs."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(shape_mod.SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multipod"])
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch, shape) on both meshes")
    ap.add_argument("--results", default=RESULTS_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--attn-impl", default="xla",
                    choices=["xla", "xla_flash", "auto"],
                    help="auto: the flash kernels' ops, as the card trains")
    ap.add_argument("--mlstm-chunk", type=int, default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--moe-combine", default="gather",
                    choices=["gather", "scatter"])
    ap.add_argument("--moe-cap-factor", type=float, default=None)
    ap.add_argument("--bf16-reduce", action="store_true")
    ap.add_argument("--dp-only", action="store_true",
                    help="map the model axis as extra DP (small models): "
                         "replicated params, batch over every mesh axis")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for mesh_kind in ("single", "multipod"):
            for arch in configs.ARCH_IDS:
                for shape in shape_mod.SHAPES:
                    cells.append((arch, shape, mesh_kind))
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        shapes_ = [args.shape] if args.shape else list(shape_mod.SHAPES)
        cells = [(args.arch, s, args.mesh) for s in shapes_]

    from ..models import layers as _layers, moe as _moe
    _moe.COMBINE_MODE = args.moe_combine
    _layers.REDUCE_IN_COMPUTE_DTYPE = args.bf16_reduce
    global _CAP_FACTOR_OVERRIDE
    _CAP_FACTOR_OVERRIDE = args.moe_cap_factor

    n_ok = n_skip = n_err = 0
    t0 = time.time()
    try:
        for arch, shape, mesh_kind in cells:
            out = os.path.join(
                args.results, f"{arch}__{shape}__{mesh_kind}.json"
            )
            if args.skip_existing and os.path.exists(out):
                with open(out) as f:
                    prev = json.load(f)
                if prev.get("status") in ("ok", "skipped"):
                    continue
            rec = run_cell(
                arch, shape, mesh_kind, results_dir=args.results,
                attn_impl=args.attn_impl, mlstm_chunk=args.mlstm_chunk,
                grad_accum=args.grad_accum, dp_only=args.dp_only,
                variant=args.variant,
            )
            st = rec["status"]
            n_ok += st == "ok"
            n_skip += st == "skipped"
            n_err += st == "error"
    finally:
        release_fake_group()
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"in {time.time() - t0:.1f} s", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
