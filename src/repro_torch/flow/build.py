"""The end-to-end tool flow: CFDlang source in, planned executable
memory architecture out (the paper's headline pipeline, Fig. 5).

``compile()`` wires the repo's two halves together with no per-operator
hand-written builder code:

  1. **front-end**   -- ``core.dsl`` parses the source (``elem`` markers
     or ``element_vars`` name the batched streams);
  2. **middle-end**  -- ``core.rewrite`` factorizes/CSEs the tensor
     expressions;
  3. **schedule**    -- ``core.schedule`` partitions the value graph into
     dataflow groups; ``stage_partition`` turns group boundaries into
     pipeline-stage boundaries (or explicit named cuts are honored);
  4. **liveness**    -- ``core.liveness.classify_boundary_streams``
     decides which cross-stage values stay device-resident and which
     cross the host link;
  5. **backend**     -- each stage is compiled by ``core.emit`` (plain
     PyTorch ``xla`` or ``staged``, or a hand-written CUDA kernel via
     structural pattern dispatch, ``flow.patterns``);
  6. **memory**      -- the derived :class:`ProgramChain` is planned by
     ``memory.plan_chain`` (optionally fused by ``memory.fusion`` and
     swept by ``dse.explore_chain``); on the H100 a kernel stage
     without a pinned block runs at the block its plan carries, the CUDA
     kernel's tile (on the reference's datasheets the plan's block is a
     VMEM block and the kernel takes its default tile), and
     ``tune_blocks`` times the kernel's candidate tiles and keeps the
     fastest.

The result is a :class:`CompiledSystem`: per-stage callables, the
:class:`ChainPlan`, and a human-readable system report -- the generated-
architecture description the paper's flow emits, byte for byte the
reference's.  ``CompiledSystem.run`` executes the artifact through the
K-deep chain pipeline driver.  :func:`cache_key` (over
:func:`program_fingerprint` and :func:`topology_fingerprint`) keys the
serving layer's plan cache, equal to the reference's for the same
source and knobs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from ..core import dsl, emit, ir, liveness, rewrite
from ..core.schedule import (Group, Schedule, schedule as make_schedule,
                             stage_partition)
from ..core.precision import get_policy
from ..memory import channels, layout
from ..memory.chain import ChainPlan, ChainStage, ProgramChain, plan_chain
from ..memory.fusion import FusionSpec, fuse_chain_auto
from ..memory.fusion import _collapse, _collapse_backends
from ..memory.placement import DeviceTopology
from . import patterns


class FlowError(ValueError):
    """Raised when a program cannot be lowered to a pipelined system."""


#: Explicit stage cuts: ``(stage_name, (value_name, ...))`` where value
#: names refer to the program's declared temporaries/outputs.
StageSpec = Sequence[Tuple[str, Sequence[str]]]


def resolve_target(
    target: Union[None, str, channels.MemoryTarget],
    device=None,
) -> channels.MemoryTarget:
    """None -> detect on ``device`` (the CUDA card unless ``"cpu"``);
    str -> datasheet lookup ('alveo_u280' ~ 'alveo-u280').

    Delegates to :func:`repro_torch.memory.channels.resolve_target` so
    every caller normalizes names identically; typos raise a FlowError
    listing the known targets."""
    try:
        return channels.resolve_target(target, device)
    except channels.UnknownTargetError as e:
        raise FlowError(str(e)) from e


# ---------------------------------------------------------------------------
# compile-identity fingerprints (the serving layer's plan-cache key)
# ---------------------------------------------------------------------------


def program_fingerprint(prog: ir.Program) -> str:
    """Canonical sha1 of a program's structure.

    Node uids and einsum index ids are process-global fresh counters, so
    two parses of the same source produce different raw objects; this
    renumbers both (nodes in topological order, einsum ids per node in
    first-use order) so equal graphs hash equal while any structural
    change -- shapes, ops, bindings, outputs, element marking -- does
    not.  Fingerprint the *post-rewrite* program to key a plan cache:
    sources that optimize to the same graph then share one entry.
    """
    import hashlib

    topo = prog.toposort()
    num = {n.uid: i for i, n in enumerate(topo)}
    parts: List[str] = []
    for n in topo:
        if isinstance(n, ir.Input):
            parts.append(f"in:{n.name}:{tuple(n.shape)}")
        elif isinstance(n, ir.Einsum):
            ids: Dict[int, int] = {}

            def ren(j: int) -> int:
                return ids.setdefault(j, len(ids))

            subs = ";".join(
                ",".join(str(ren(j)) for j in s) for s in n.in_subs
            )
            out = ",".join(str(ren(j)) for j in n.out_subs)
            ops = ",".join(str(num[o.uid]) for o in n.ops)
            parts.append(f"ein:{ops}:{subs}->{out}:{tuple(n.shape)}")
        elif isinstance(n, ir.Ewise):
            ops = ",".join(str(num[o.uid]) for o in n.operands())
            parts.append(f"ew:{n.op}:{ops}:{n.const}:{tuple(n.shape)}")
        else:  # future node kinds still hash deterministically
            ops = ",".join(str(num[o.uid]) for o in n.operands())
            parts.append(f"{type(n).__name__}:{ops}:{tuple(n.shape)}")
    parts.append("outs:" + ",".join(
        f"{name}={num[v.uid]}" for name, v in sorted(prog.outputs.items())
    ))
    parts.append("elem:" + ",".join(sorted(prog.element_vars)))
    return hashlib.sha1("|".join(parts).encode()).hexdigest()


def topology_fingerprint(
    devices: Union[None, int, str, DeviceTopology],
) -> str:
    """The cache-key view of ``compile(devices=...)``: what machine the
    placement was co-scheduled for.  ``0`` (detect) counts the local
    CUDA cards *now*, so a cache entry can never leak across pool
    changes.
    Heterogeneous specs (``"cpu:2,tpu:4"`` strings or explicit
    :class:`DeviceTopology` values) hash their full per-group layout via
    ``spec_string()`` -- two fleets with the same device count but
    different kind mixes never share a plan-cache entry."""
    if devices is None:
        return "auto"
    if isinstance(devices, DeviceTopology):
        return devices.spec_string()
    if isinstance(devices, str):
        return DeviceTopology.parse(devices).spec_string()
    if devices == 0:
        t = DeviceTopology.detect()
        return t.spec_string()
    return f"{devices}xgeneric"


def cache_key(
    source: str,
    *,
    element_vars: Sequence[str] = (),
    target: Union[None, str, channels.MemoryTarget] = None,
    policy: Union[str, object] = "float32",
    optimize: bool = True,
    devices: Union[None, int, str, DeviceTopology] = None,
    **kwargs,
) -> str:
    """The plan-cache key for one :func:`compile` call: ``(sha of the
    post-rewrite program, target name, policy, topology fingerprint)``
    plus a digest of every remaining compile knob, ``/``-joined.

    Runs only the front/middle-end (parse + rewrite) -- the expensive
    planning/DSE work is exactly what a cache hit skips.  Knobs that are
    ``None`` (the compile defaults) are excluded from the digest, so
    spelling a default out does not split the cache; the serving layer
    passes one normalized kwarg dict for the rest.  ``device`` is a knob
    like any other: a system compiled for the host never answers a
    compile call for the card.
    """
    import hashlib

    pol = policy if isinstance(policy, str) else policy.name
    tgt = resolve_target(target, kwargs.get("device"))
    prog = dsl.parse(source, element_vars=element_vars)
    if optimize:
        prog = rewrite.optimize(prog)
    extra = hashlib.sha1(repr(sorted(
        (k, repr(v)) for k, v in kwargs.items()
        if v is not None and k not in ("name", "profile")
    )).encode()).hexdigest()[:12]
    return "/".join([
        program_fingerprint(prog), tgt.name, pol,
        topology_fingerprint(devices), extra,
    ])


# ---------------------------------------------------------------------------
# stage extraction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Stage:
    """One extracted pipeline stage, pre-compilation."""

    name: str
    nodes: List[ir.Node]           # slice of the whole program, topo order
    program: ir.Program            # standalone rebuilt subprogram
    bindings: Dict[str, str]       # input name -> "producer.output"
    group: Group                   # report view (streams/flops/liveness)


@dataclasses.dataclass(frozen=True)
class StreamInfo:
    """One cross-stage value and where it lives."""

    name: str
    klass: str                     # liveness.STREAM_{RESIDENT,HOST,BOTH}
    bytes_per_element: int
    producer: str
    consumers: Tuple[str, ...]     # empty for host-only outputs


def _named_partitions(
    prog: ir.Program, stages: StageSpec
) -> List[Tuple[str, List[ir.Node]]]:
    """Partition the program at explicit named cuts: each stage owns the
    nodes needed for its named values that no earlier stage claimed."""
    by_name: Dict[str, ir.Node] = dict(prog.temps)
    by_name.update(prog.outputs)
    topo = prog.toposort()
    topo_pos = {n.uid: i for i, n in enumerate(topo)}
    input_uids = {v.uid for v in prog.inputs.values()}
    claimed: set = set()
    parts: List[Tuple[str, List[ir.Node]]] = []
    seen_names: set = set()
    for name, value_names in stages:
        if not name or "." in name or name in seen_names:
            raise FlowError(f"bad or duplicate stage name {name!r}")
        seen_names.add(name)
        nodes: List[ir.Node] = []
        stack = []
        for vn in value_names:
            if vn not in by_name:
                raise FlowError(
                    f"stage {name!r}: unknown value {vn!r} (stage cuts "
                    "name declared temporaries or outputs)"
                )
            stack.append(by_name[vn])
        while stack:
            n = stack.pop()
            if n.uid in claimed or n.uid in input_uids:
                continue
            claimed.add(n.uid)
            nodes.append(n)
            stack.extend(n.operands())
        if not nodes:
            raise FlowError(
                f"stage {name!r} is empty: its values are computed by "
                "earlier stages (cut order conflicts with the dataflow)"
            )
        nodes.sort(key=lambda n: topo_pos[n.uid])
        parts.append((name, nodes))
    for out_name, v in prog.outputs.items():
        if v.uid not in claimed:
            raise FlowError(
                f"stage cuts do not cover output {out_name!r}"
            )
    return parts


def _stream_namer(prog: ir.Program):
    """Deterministic cross-stage stream names: declared temp names where
    available, else t0, t1, ... in topological order (uids never leak
    into reports)."""
    taken = set(prog.inputs) | set(prog.outputs) | set(prog.temps)
    temp_of = {v.uid: k for k, v in prog.temps.items()}
    fresh = iter(range(10 ** 6))
    cache: Dict[int, str] = {}

    def name_of(node: ir.Node) -> str:
        if node.uid not in cache:
            got = temp_of.get(node.uid)
            if got is None:
                got = f"t{next(fresh)}"
                while got in taken:
                    got = f"t{next(fresh)}"
                taken.add(got)
            cache[node.uid] = got
        return cache[node.uid]

    return name_of


def _extract_stages(
    prog: ir.Program,
    parts: List[Tuple[str, List[ir.Node]]],
    bytes_per_scalar: int,
) -> Tuple[List[_Stage], List[StreamInfo]]:
    """Turn a node partition into standalone stage programs + bindings.

    Cross-stage values become the producer stage's outputs and fresh
    inputs of each consumer (same stream name on both sides, so chain
    bindings are by construction never dangling).  A program output that
    later stages also consume is exported twice: under its output name
    (host stream) and under a ``<name>_res`` alias (the HBM-resident
    copy consumers bind to), so the host still receives every program
    output.
    """
    elem_dep = prog.element_dependent_uids()
    classes = liveness.classify_boundary_streams(
        prog, [nodes for _, nodes in parts]
    )
    out_names: Dict[int, List[str]] = {}
    for name, v in prog.outputs.items():
        out_names.setdefault(v.uid, []).append(name)
    input_name_of = {v.uid: k for k, v in prog.inputs.items()}
    stream_name = _stream_namer(prog)

    stage_of: Dict[int, int] = {}
    for i, (_, nodes) in enumerate(parts):
        for n in nodes:
            stage_of[n.uid] = i

    # pre-name pure-resident streams in topo order for determinism
    stream_name_by_uid: Dict[int, str] = {}
    for _, nodes in parts:
        for n in nodes:
            if (n.uid in classes
                    and classes[n.uid] == liveness.STREAM_RESIDENT
                    and n.uid not in out_names):
                stream_name_by_uid[n.uid] = stream_name(n)

    def export_name(uid: int) -> str:
        """The producer-side output name consumers bind to."""
        if classes[uid] == liveness.STREAM_BOTH:
            return f"{out_names[uid][0]}_res"
        if uid in out_names:
            return out_names[uid][0]
        return stream_name_by_uid[uid]

    stages: List[_Stage] = []
    consumers: Dict[int, List[str]] = {}
    for i, (name, nodes) in enumerate(parts):
        node_uids = {n.uid for n in nodes}
        # --- boundary inputs ------------------------------------------------
        inputs: Dict[str, ir.Node] = {}
        bindings: Dict[str, str] = {}
        in_elem: List[str] = []
        for n in nodes:
            for op in n.operands():
                if op.uid in node_uids:
                    continue
                if op.uid in input_name_of:        # whole-program input
                    in_name = input_name_of[op.uid]
                    src = None
                else:                               # earlier stage's value
                    in_name = (
                        stream_name_by_uid.get(op.uid)
                        or out_names[op.uid][0]
                    )
                    p = stage_of[op.uid]
                    src = f"{parts[p][0]}.{export_name(op.uid)}"
                if in_name in inputs:
                    continue
                inputs[in_name] = op
                if src is not None:
                    bindings[in_name] = src
                    consumers.setdefault(op.uid, []).append(name)
                if op.uid in elem_dep:
                    in_elem.append(in_name)
        # --- boundary outputs ----------------------------------------------
        outputs: Dict[str, ir.Node] = {}
        out_elem: List[str] = []
        for n in nodes:
            klass = classes.get(n.uid)
            if klass is None:
                continue
            names: List[str] = list(out_names.get(n.uid, ()))
            if klass == liveness.STREAM_BOTH:
                names.append(f"{out_names[n.uid][0]}_res")
            elif klass == liveness.STREAM_RESIDENT and n.uid not in out_names:
                names = [stream_name_by_uid[n.uid]]
            for nm in names:
                outputs[nm] = n
                if n.uid in elem_dep:
                    out_elem.append(nm)
            if n.uid not in elem_dep:
                raise FlowError(
                    f"stream {names[0]!r} does not depend on any element "
                    "input; the flow pipelines element streams only "
                    "(precompute shared values on the host instead)"
                )
        stage_prog = ir.subprogram(
            nodes, inputs, outputs, element_vars=in_elem + out_elem
        )
        group = Group(
            nodes=nodes,
            in_streams=list(inputs.values()),
            out_streams=[prog_out for prog_out in dict.fromkeys(
                outputs.values()
            )],
            name=name,
            bytes_per_scalar=bytes_per_scalar,
        )
        stages.append(_Stage(
            name=name, nodes=nodes, program=stage_prog,
            bindings=bindings, group=group,
        ))

    streams = [
        StreamInfo(
            name=(
                out_names[uid][0] if uid in out_names
                else stream_name_by_uid[uid]
            ),
            klass=klass,
            bytes_per_element=(
                next(n for n in parts[stage_of[uid]][1] if n.uid == uid).size
                * bytes_per_scalar
            ),
            producer=parts[stage_of[uid]][0],
            consumers=tuple(consumers.get(uid, ())),
        )
        for uid, klass in sorted(
            classes.items(),
            key=lambda kv: (stage_of[kv[0]], kv[0]),
        )
    ]
    return stages, streams


# ---------------------------------------------------------------------------
# stage compilation (with kernel pattern dispatch)
# ---------------------------------------------------------------------------


def _compile_stages(
    stages: List[_Stage],
    policy,
    backends: Sequence[str],
    stage_blocks: Mapping[str, int],
) -> Tuple[List[ChainStage], Tuple[str, ...]]:
    """Compile every stage program; ``pallas`` stages are structurally
    matched against the CUDA kernels and fall back to ``xla`` when no
    kernel fits.  Returns the chain stages + effective backends."""
    chain_stages: List[ChainStage] = []
    effective: List[str] = []
    for st, backend in zip(stages, backends):
        pallas_impl = None
        if backend == "pallas":
            pallas_impl = patterns.pallas_impl_for(
                st.program, block_elements=stage_blocks.get(st.name)
            )
            if pallas_impl is None:
                backend = "xla"
        compiled = emit.compile_program(
            st.program, policy=policy, backend=backend,
            pallas_impl=pallas_impl,
        )
        chain_stages.append(ChainStage(st.name, compiled, dict(st.bindings)))
        effective.append(backend)
    return chain_stages, tuple(effective)


def _at_blocks(
    chain: ProgramChain,
    stages: List[_Stage],
    policy,
    backends: Sequence[str],
    blocks: Mapping[str, int],
) -> ProgramChain:
    """The chain with every kernel stage compiled at its block in
    ``blocks`` (absent: the kernel's default tile); other stages kept."""
    out = []
    for st, cs, backend in zip(stages, chain.stages, backends):
        if backend == "pallas":
            (cs,), _ = _compile_stages([st], policy, [backend], blocks)
        out.append(cs)
    return ProgramChain(out)


def _plan_at_blocks(
    plan: ChainPlan,
    stages: List[_Stage],
    backends: Sequence[str],
    blocks: Mapping[str, int],
    policy,
    target: channels.MemoryTarget,
) -> ChainPlan:
    """The plan with the stages named in ``blocks`` at those blocks (and
    their on-chip bytes: a kernel stage's CTA shared memory on the
    H100)."""
    bps = policy.bits // 8
    stage_plans = []
    for i, (sp, st, backend) in enumerate(zip(plan.stages, stages, backends)):
        if sp.name in blocks and blocks[sp.name] != sp.block_elements:
            blk, ws = layout.stage_block(
                st.program, target, plan.stage_e(i), bytes_per_scalar=bps,
                kernel=backend == "pallas" and not policy.is_fixed_point,
                te=blocks[sp.name],
            )
            sp = dataclasses.replace(
                sp, block_elements=blk, block_working_set_bytes=ws
            )
        stage_plans.append(sp)
    return dataclasses.replace(plan, stages=tuple(stage_plans))


@dataclasses.dataclass(frozen=True)
class StageTuning:
    """What ``tune_blocks`` measured for one kernel stage: each candidate
    block with its class and its best time (seconds for one batch of
    the stage's E), and the winner."""

    stage: str
    batch_elements: int
    candidates: Tuple[Tuple[int, str, float], ...]  # (block, klass, s)
    block_elements: int
    #: the blocks are the CUDA kernel's tiles (else the reference's
    #: VMEM blocks, timed off the card on a reference datasheet)
    kernel_tile: bool = True

    def describe(self) -> str:
        """One report line: every candidate's time, the winner starred."""
        times = "  ".join(
            f"{be}{'*' if be == self.block_elements else ''}"
            f"({klass}) {t * 1e3:.3f}ms"
            for be, klass, t in self.candidates
        )
        return f"    {self.stage:<12} E={self.batch_elements}  {times}"


def _block_candidates(
    prog: ir.Program,
    target: channels.MemoryTarget,
    policy,
    e: int,
    *,
    card: bool,
) -> List[Tuple[int, str]]:
    """``(block, class)`` candidates for one kernel stage at batch ``e``.

    Where the blocks are timed on the card, or planned for it (``card``),
    they are the CUDA kernel's own tiles, ``te = 1 .. max_tile``
    (``kernels.gemm.card_tile_candidates``), so no block is timed that
    the card cannot launch.  Otherwise they are the reference's: the
    CHARM-style tile classes (``kernels.gemm.tile_candidates``) for a
    GEMM-chain stage, else the power-of-two blocks under the stage's
    VMEM cap; both divide E."""
    from ..kernels import gemm

    bps = policy.bits // 8
    if card:
        max_te = patterns.kernel_tile_for(prog, bps)[3]
        return [
            (te, klass) for te, klass, _ in gemm.card_tile_candidates(
                lambda te: patterns.kernel_tile_for(prog, bps, te)[:3],
                max_te, batch_elements=e,
            )
        ]
    recipe = patterns.match_gemm_chain(prog)
    if recipe is not None:
        klass = {
            c.block_elements: c.klass for c in gemm.tile_candidates(
                recipe, vmem_bytes=target.vmem_bytes,
                peak_flops=target.peak_flops, hbm_bandwidth=target.hbm_bw,
                bytes_per_scalar=bps, batch_elements=e,
            )
        }
    else:
        cap = layout.vmem_block_elements(prog, target, bytes_per_scalar=bps)
        klass, be = {}, 1
        while be <= min(cap, e):
            if e % be == 0:
                klass[be] = "-"
            be *= 2
    return sorted((b, k) for b, k in klass.items() if b <= e and e % b == 0)


def _tune_stage_blocks(
    stage_specs: List[_Stage],
    effective: Sequence[str],
    plan: ChainPlan,
    policy,
    target: channels.MemoryTarget,
    device,
    profile=None,
) -> Dict[str, StageTuning]:
    """Measured block-size autotuning for the plan's kernel stages.

    For each ``pallas`` stage with at least two candidate blocks
    (:func:`_block_candidates`: the kernel's tiles on the H100 datasheet
    or wherever ``device`` is a card, else the reference's VMEM blocks),
    each candidate is compiled and timed on
    synthetic data at the stage's batch size, made on ``device`` from a
    ``torch.Generator`` seeded 0: one warm-up call, then the best of
    three (CUDA events on the current stream on the card,
    ``time.perf_counter`` on the CPU).  The fastest wins.  A candidate
    that fails to build or launch raises.  Returns ``{stage name:
    StageTuning}``.  With a ``profile`` store the winners (with their
    predicted-vs-measured sample) are deposited in it, keyed by the
    plan's signature and by ``device``'s fingerprint
    (:meth:`~repro_torch.trace.ProfileStore.for_device`), so later
    sessions start from the measured choice.
    """
    import torch

    dev = channels.resolve_device(device)
    card = layout.kernel_tiles(target) or dev.type == "cuda"
    out: Dict[str, StageTuning] = {}
    for i, (st, backend) in enumerate(zip(stage_specs, effective)):
        if backend != "pallas":
            continue
        e = plan.stage_e(i)
        cands = _block_candidates(st.program, target, policy, e, card=card)
        if len(cands) < 2:
            continue
        gen = torch.Generator(device=dev).manual_seed(0)
        elem = set(st.program.element_vars)
        env = {
            n: torch.randn(
                ((e,) + tuple(v.shape)) if n in elem else tuple(v.shape),
                generator=gen, device=dev, dtype=torch.float32,
            ).to(policy.torch_dtype)
            for n, v in st.program.inputs.items()
        }
        times = []
        for be, klass in cands:
            fn = emit.compile_program(
                st.program, policy=policy, backend="pallas",
                pallas_impl=patterns.pallas_impl_for(
                    st.program, block_elements=be),
            ).batched_fn
            _timed(fn, env, dev)  # warm-up: builds and loads the kernels
            times.append((be, klass, min(_timed(fn, env, dev)
                                         for _ in range(3))))
        best = min(times, key=lambda c: c[2])
        out[st.name] = StageTuning(
            stage=st.name, batch_elements=e, candidates=tuple(times),
            block_elements=best[0], kernel_tile=card,
        )
    if out and profile is not None:
        from ..trace.profile import ProfileStore  # lazy: no import cycle

        store = ProfileStore.open(profile)
        if store is not None:
            sp_by_name = {sp.name: sp for sp in plan.stages}
            store.for_device(dev).record(target.name, plan.signature, [
                {
                    "name": f"tune:{name}",
                    "scope": "tune",
                    "predicted_s": max(c.t_compute, c.t_hbm, c.t_host),
                    "measured_s": min(t for _, _, t in tune.candidates),
                    "block_elements": tune.block_elements,
                }
                for name, tune in out.items()
                if name in sp_by_name
                for c in (sp_by_name[name].cost,)
            ])
    return out


def _timed(fn, env, dev) -> float:
    """Seconds of one call: CUDA events on the current stream on the
    card, the host clock (the outputs are ready on return) on the CPU."""
    import time

    import torch

    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(env)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn(env)
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# the compiled artifact
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledSystem:
    """Everything the flow generates for one program: the executable
    chain, its memory architecture, and the derivation record."""

    name: str
    source: str
    policy: str
    target: channels.MemoryTarget
    program: ir.Program            # whole program after rewrites
    schedule: Schedule
    chain: ProgramChain
    plan: ChainPlan
    backends: Tuple[str, ...]      # effective per-stage backends
    streams: Tuple[StreamInfo, ...]
    sharing: Dict[str, "liveness.SharingPlan"]
    stage_groups: Tuple[Group, ...]
    candidates: Optional[list] = None   # ChainCandidate ranking (dse=True)
    #: per-stage block measurements (tune_blocks=True)
    tuning: Optional[Dict[str, StageTuning]] = None

    @property
    def stage_names(self) -> Tuple[str, ...]:
        """Planned stage names, in execution order (post-fusion)."""
        return tuple(s.name for s in self.chain.stages)

    def run(self, **kwargs):
        """Execute the system through the chain pipeline driver: the
        plan's ``pipeline`` spec decides whether stages are cross-batch
        pipelined (one dispatch ring per stage) or run back-to-back
        (pass ``pipeline_stages=False`` to force the serial baseline;
        see ``repro_torch.cfd.simulation.run_chain`` for all arguments,
        ``devices`` among them: the device pool the plan's placement runs
        over, every visible card by default; ``device`` is the one-slot
        shorthand, ``"cpu"`` for the host).
        ``tracer=repro_torch.trace.Tracer()`` records the run's
        span/counter trace; ``monitor=runtime.StepMonitor()`` watches for
        straggler batches -- both pass straight through to
        ``run_chain``."""
        from ..cfd.simulation import run_chain  # lazy: cfd builds on flow

        return run_chain(self.chain, self.plan, **kwargs)

    def report(self, tracer=None) -> str:
        """The generated-architecture description (golden-checked).

        Pass the tracer of a completed ``run(tracer=...)`` to append the
        ``measured:`` section -- the per-stage predicted-vs-measured
        attribution table (``repro_torch.trace.attribution_report``)."""
        prog = self.program
        elem = set(prog.element_vars)
        n_elem_in = sum(1 for n in prog.inputs if n in elem)
        bps = self.schedule.bytes_per_scalar
        fu = self.plan.fusion
        if fu is None:
            fusion_line = (
                "  fusion: off (fuse='auto' merges stages whose handoff "
                "the cost model prices above their combined roofline)"
            )
        elif fu.fused:
            fusion_line = (
                f"  fusion: {fu.mode} ({fu.n_stages_before} -> "
                f"{fu.n_stages_after} stages)"
            )
        else:
            fusion_line = (
                f"  fusion: {fu.mode} (kept all {fu.n_stages_after} "
                "stages)"
            )
        lines = [
            f"repro.flow system: {self.name}",
            "  pipeline: DSL source -> teil IR -> schedule -> chain -> "
            "plan -> execute",
            f"  target={self.target.name}  policy={self.policy}  "
            f"stages={len(self.chain.stages)}",
            f"  program: {len(prog.inputs)} inputs ({n_elem_in} element), "
            f"{len(prog.outputs)} outputs, "
            f"{sum(1 for n in prog.toposort() if not isinstance(n, ir.Input))}"
            f" ir nodes, {prog.total_flops()} flops/element",
            f"  schedule: {len(self.schedule.groups)} groups -> "
            f"{len(self.chain.stages)} stages",
            fusion_line,
            "",
            f"  {'stage':<12} {'backend':<8} {'nodes':>5} "
            f"{'flops/elem':>12} {'in B/elem':>10} {'out B/elem':>10} "
            f"{'sharing':>8}",
        ]
        for g, backend in zip(self.stage_groups, self.backends):
            share = self.sharing[g.name]
            lines.append(
                f"  {g.name:<12} {backend:<8} {len(g.nodes):>5} "
                f"{g.flops:>12} {g.in_stream_bytes(bps):>10} "
                f"{g.out_stream_bytes(bps):>10} "
                f"{share.savings_frac * 100:>7.1f}%"
            )
        lines += [
            "",
            f"  {'stream':<12} {'class':<9} {'B/elem':>8}  route",
        ]
        for s in self.streams:
            route = s.producer + " -> " + (
                ", ".join(s.consumers) if s.consumers else "host"
            )
            if s.klass == liveness.STREAM_BOTH:
                route += " + host"
            lines.append(
                f"  {s.name:<12} {s.klass:<9} "
                f"{s.bytes_per_element:>8}  {route}"
            )
        lines += ["", self.plan.report()]
        if self.tuning:
            lines += ["", "  tuned blocks (block(class) best of 3, "
                      "* the winner):"]
            lines += [t.describe() for t in self.tuning.values()]
        if tracer:
            from ..trace.attribution import attribution_report

            lines += ["", attribution_report(tracer, self.plan)]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def compile(
    source: str,
    *,
    name: str = "program",
    element_vars: Sequence[str] = (),
    stages: Optional[StageSpec] = None,
    target: Union[None, str, channels.MemoryTarget] = None,
    device=None,
    policy: Union[str, object] = "float32",
    backend: str = "xla",
    backends: Optional[Sequence[str]] = None,
    stage_blocks: Optional[Mapping[str, int]] = None,
    optimize: bool = True,
    max_stages: Optional[int] = None,
    vmem_budget: Optional[int] = None,
    batch_elements: Optional[int] = None,
    prefetch_depth: Union[int, Sequence[int]] = 1,
    cu_count: Union[int, Sequence[int]] = 1,
    devices: Union[None, int, str, DeviceTopology] = None,
    n_eq: Optional[int] = None,
    channel_bytes: Optional[int] = None,
    dse: bool = False,
    dse_space=None,
    measure_top: int = 0,
    profile=None,
    fuse: Optional[str] = None,
    tune_blocks: bool = False,
) -> CompiledSystem:
    """Compile a CFDlang program end-to-end into a planned, executable
    memory architecture.

    Args:
        source: CFDlang program text (``var input/output [elem]`` decls
            plus tensor statements).
        name: Label used in reports.
        element_vars: Names of batched streams when the source does not
            mark them with ``elem``.
        stages: Explicit named cuts (:data:`StageSpec`); ``None``
            derives the pipeline from the scheduler's dataflow groups.
        target: Memory datasheet -- a :class:`~repro_torch.memory.
            channels.MemoryTarget`, a name like ``'h100-sxm'``, or
            ``None`` to detect it from ``device``.
        device: The device a detected target describes: ``None`` is the
            CUDA card (and raises without one), ``"cpu"`` the host.
        policy: Numeric precision policy name (or policy object).
        backend: Backend for every stage unless ``backends`` is given.
        backends: Per-stage backend overrides; ``pallas`` stages are
            structurally matched to the hand-written CUDA kernels and
            fall back to ``xla`` (plain PyTorch) when nothing fits.
        stage_blocks: Per-stage ``block_elements`` pins for kernel
            stages; an unpinned kernel stage runs at its plan's block.
            On the H100 a block is the CUDA kernel's tile (elements a
            CTA step), and the plan carries the pins.
        optimize: Run the middle-end rewrites (factorize/CSE) first.
        max_stages: With ``stages=None``, cap the schedule's stage
            count.
        vmem_budget: Override the scheduler's on-chip working-set budget.
        batch_elements: Explicit E; ``None`` co-sizes it per the
            paper's channel rule.
        prefetch_depth: Pipeline depth K, one value or one per stage.
        cu_count: Compute units per stage, one value or one per stage.
        devices: Device topology the stage CU groups are planned on: an
            int (homogeneous pool of that size; ``0`` = the local CUDA
            pool), a spec string like ``"cpu:2,tpu:4"``, or an explicit
            :class:`~repro_torch.memory.placement.DeviceTopology`.
        n_eq: Total equations/elements the plan should assume.
        channel_bytes: Override the target's pseudo-channel capacity.
        dse: Sweep chain design points (``dse.explore_chain``) and adopt
            the best feasible plan, recompiling stages if the winning
            backends, policy or blocks differ.
        dse_space: A :class:`~repro_torch.memory.dse.ChainDesignSpace`
            restricting that sweep.
        measure_top: Verify the k best candidates by measurement on
            ``device`` (the CUDA card unless ``"cpu"``).
        fuse: ``'auto'`` makes the stage count itself a design axis:
            after scheduling, adjacent stages are greedily merged
            whenever the planner prices the device-resident handoff
            between them above the fused stage's combined roofline
            (:mod:`repro_torch.memory.fusion`); merged stages re-enter
            kernel pattern matching.  Explicit ``stages`` cuts are
            barriers -- fusion never merges across a named cut.
            ``'off'``/``None`` keeps every boundary.
        profile: Profile store (store, path, or ``True``) that
            warm-starts the DSE ranking (``dse=True``), exactly
            ``explore_chain(profile=...)``; also receives the
            ``tune_blocks`` winners keyed by the plan signature.  Keyed
            for ``device`` where one is given (host samples never feed
            a card plan).
        tune_blocks: Measure the candidate blocks of every kernel stage
            on ``device`` and run each at the fastest (on the card the
            CUDA kernel's legal tiles, timed with CUDA events);
            ``CompiledSystem.tuning`` records what was measured.  The
            plan carries the winners where they are its kind of block:
            tiles on the H100 datasheet, VMEM blocks timed off the card
            on a reference datasheet.

    Returns:
        A :class:`CompiledSystem`: per-stage callables, the
        :class:`~repro_torch.memory.chain.ChainPlan` (``plan.fusion`` records
        the fusion decision when ``fuse`` ran), and the derivation
        record rendered by :meth:`CompiledSystem.report`.

    Raises:
        FlowError: On parse errors, unknown targets/policies/backends,
            malformed stage cuts, or non-element outputs.
    """
    if fuse not in (None, "off", "auto"):
        raise FlowError(f"unknown fuse mode {fuse!r}; use 'auto' or 'off'")
    try:
        pol = get_policy(policy) if isinstance(policy, str) else policy
    except ValueError as e:
        raise FlowError(str(e)) from e
    if pol.is_fixed_point and "pallas" in (backends or (backend,)):
        raise FlowError(
            f"the CUDA kernels compute in floating point; policy "
            f"{pol.name} runs on 'xla' or 'staged' stages"
        )
    bps = pol.bits // 8
    target = resolve_target(target, device)

    prog = dsl.parse(source, element_vars=element_vars)
    if not prog.outputs:
        raise FlowError("program has no outputs; nothing to compile")
    if not prog.element_vars:
        raise FlowError(
            "program has no element-marked streams; qualify batched "
            "inputs/outputs with 'elem' (or pass element_vars=...)"
        )
    if optimize:
        prog = rewrite.optimize(prog)
    elem_dep = prog.element_dependent_uids()
    for out_name, v in prog.outputs.items():
        if v.uid not in elem_dep:
            raise FlowError(
                f"output {out_name!r} does not depend on any element "
                "input; the flow pipelines element streams only"
            )

    sched_kwargs = {}
    if vmem_budget is not None:
        sched_kwargs["vmem_budget"] = vmem_budget
    if max_stages is not None:
        sched_kwargs["max_groups"] = max_stages
    sched = make_schedule(prog, bytes_per_scalar=bps, **sched_kwargs)

    if stages is None:
        parts = [
            (f"s{i}", nodes)
            for i, nodes in enumerate(stage_partition(sched))
        ]
    else:
        parts = _named_partitions(prog, stages)

    stage_specs, streams = _extract_stages(prog, parts, bps)

    if backends is None:
        backends = [backend] * len(stage_specs)
    if len(backends) != len(stage_specs):
        raise FlowError(
            f"need {len(stage_specs)} per-stage backends "
            f"({', '.join(s.name for s in stage_specs)}), "
            f"got {len(backends)}"
        )
    stage_blocks = dict(stage_blocks or {})
    chain_stages, effective = _compile_stages(
        stage_specs, pol, backends, stage_blocks
    )
    chain = ProgramChain(chain_stages)

    if devices is None:
        topology = None  # plan_chain sizes it to the widest stage
    elif isinstance(devices, DeviceTopology):
        topology = devices
    elif isinstance(devices, str):
        try:
            topology = DeviceTopology.parse(devices)
        except ValueError as e:
            raise FlowError(str(e)) from e
    elif devices == 0:
        topology = DeviceTopology.detect()
    else:
        topology = DeviceTopology.homogeneous(devices)

    plan = plan_chain(
        chain, target=target, policy=pol.name, backends=effective,
        batch_elements=batch_elements, prefetch_depth=prefetch_depth,
        cu_count=cu_count, topology=topology, n_eq=n_eq,
        channel_bytes=channel_bytes,
    )

    fusion_spec = None
    if fuse == "auto":
        if stages is not None or len(chain.stages) == 1:
            # every explicit named cut is a barrier: fusion is a no-op
            fusion_spec = FusionSpec(
                mode="auto",
                groups=tuple((s.name,) for s in chain.stages),
                n_stages_before=len(chain.stages),
                n_stages_after=len(chain.stages),
                t_unfused=plan.cost.t_pipelined,
                t_fused=plan.cost.t_pipelined,
                saved_handoff_bytes=0,
                barriers=(
                    tuple(s.name for s in chain.stages)
                    if stages is not None else ()
                ),
            )
        else:
            decision = fuse_chain_auto(
                chain, mode="auto", target=target, policy=pol.name,
                backends=effective, batch_elements=batch_elements,
                prefetch_depth=prefetch_depth, cu_count=cu_count,
                topology=topology, n_eq=n_eq, channel_bytes=channel_bytes,
            ).fusion
            fusion_spec = dataclasses.replace(decision, chain=None)
            if decision.fused:
                # rebuild the flow's own stages over the merged
                # partition, so streams/groups/reports stay native and
                # the merged programs re-enter kernel pattern matching
                idx_of = {pname: i for i, (pname, _) in enumerate(parts)}
                groups_idx = [
                    tuple(idx_of[n] for n in g) for g in decision.groups
                ]
                topo_pos = {
                    n.uid: i for i, n in enumerate(prog.toposort())
                }
                parts = [
                    (
                        "+".join(names),
                        sorted(
                            (n for i in g for n in parts[i][1]),
                            key=lambda n: topo_pos[n.uid],
                        ),
                    )
                    for g, names in zip(groups_idx, decision.groups)
                ]
                stage_specs, streams = _extract_stages(prog, parts, bps)
                prefetch_depth = _collapse(prefetch_depth, groups_idx)
                cu_count = _collapse(cu_count, groups_idx)
                chain_stages, effective = _compile_stages(
                    stage_specs, pol,
                    _collapse_backends(list(backends), groups_idx),
                    stage_blocks,
                )
                chain = ProgramChain(chain_stages)
                plan = plan_chain(
                    chain, target=target, policy=pol.name,
                    backends=effective, batch_elements=batch_elements,
                    prefetch_depth=prefetch_depth, cu_count=cu_count,
                    topology=topology, n_eq=n_eq,
                    channel_bytes=channel_bytes,
                )
                fusion_spec = dataclasses.replace(
                    fusion_spec, t_fused=plan.cost.t_pipelined
                )

    candidates = None
    if dse:
        from ..memory import dse as dse_mod  # lazy: dse measures via cfd

        space = dse_space or dse_mod.ChainDesignSpace(policies=(pol.name,))
        candidates = dse_mod.explore_chain(
            chain, target=target, n_eq=n_eq if n_eq else 1 << 16,
            space=space, topology=topology, measure_top=measure_top,
            profile=profile, device=device,
        )
        winner = next((c for c in candidates if c.plan.feasible), None)
        if winner is not None:
            plan = winner.plan
            won = tuple(sp.backend for sp in plan.stages)
            won_pol = (
                get_policy(plan.policy) if plan.policy != pol.name else pol
            )
            # kernel stages move to the winner's blocks below
            if won != effective or won_pol is not pol:
                chain_stages, effective = _compile_stages(
                    stage_specs, won_pol, won, stage_blocks
                )
                chain = ProgramChain(chain_stages)
                pol = won_pol
            if won != effective:
                # the winning combo asked for a kernel no stage matches
                # (e.g. 'pallas' on a stage no kernel class covers):
                # re-plan at the winner's design point with the backends
                # that actually compiled, so plan and executable agree
                plan = plan_chain(
                    chain, target=target, policy=pol.name,
                    backends=effective,
                    batch_elements=plan.batch_elements,
                    placement=plan.placement, n_eq=n_eq,
                    channel_bytes=channel_bytes,
                )

    tuning = None
    if tune_blocks:
        tuning = _tune_stage_blocks(
            stage_specs, effective, plan, pol, target, device, profile
        )
    tuned = tuning or {}
    if layout.kernel_tiles(target):
        # the plan's block is the tile the stage's kernel launches with:
        # a pin, a winner, else the block the plan carries
        blocks = {**stage_blocks,
                  **{n: t.block_elements for n, t in tuned.items()}}
        plan = _plan_at_blocks(
            plan, stage_specs, effective, blocks, pol, target
        )
        for sp, backend in zip(plan.stages, effective):
            if backend == "pallas" and sp.block_elements:
                blocks.setdefault(sp.name, sp.block_elements)
    else:
        # a reference datasheet's blocks (pins, the plan's, winners timed
        # off the card) are VMEM blocks: the plan keeps them, and a
        # kernel launches at its default tile or at one timed on the card
        plan = _plan_at_blocks(
            plan, stage_specs, effective,
            {n: t.block_elements for n, t in tuned.items()
             if not t.kernel_tile},
            pol, target,
        )
        blocks = {n: t.block_elements for n, t in tuned.items()
                  if t.kernel_tile}
    chain = _at_blocks(chain, stage_specs, pol, effective, blocks)

    if fusion_spec is not None:
        plan = dataclasses.replace(
            plan, fusion=dataclasses.replace(fusion_spec, chain=chain)
        )

    sharing = liveness.plan_program(
        [s.group for s in stage_specs], bytes_per_scalar=bps
    )
    return CompiledSystem(
        name=name, source=source, policy=pol.name, target=target,
        program=prog, schedule=sched, chain=chain, plan=plan,
        backends=effective, streams=tuple(streams), sharing=sharing,
        stage_groups=tuple(s.group for s in stage_specs),
        candidates=candidates, tuning=tuning,
    )
