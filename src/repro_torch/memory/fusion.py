"""Cost-driven stage fusion: make the stage count itself a DSE axis.

The scheduler's auto-partition and the flow's named cuts fix the chain's
stage boundaries *before* the memory planner prices them -- but every
boundary has a concrete HBM cost the planner can already see: the
producer writes the handoff stream once, the consumer reads it once
(``BufferSpec`` role ``resident``), and the boundary adds a pipeline
fill/drain step plus a dispatch.  Whenever that handoff traffic costs
more than the merged stage's added device time (the two rooflines
combined), the boundary should not exist.

This module erases such boundaries *after* scheduling and *before* the
final plan, by greedy pairwise merging:

  * :func:`fuse_chain` mechanically merges arbitrary groups of adjacent
    stages of a :class:`~repro_torch.memory.chain.ProgramChain` into single
    stages -- stitching the member programs together at their bound
    streams, dropping handoffs that become internal, and re-qualifying
    every binding that crosses a group edge.
  * :func:`fuse_chain_auto` is the decision procedure: starting from the
    unfused chain it prices every adjacent-pair merge with the real
    planner (:func:`~repro_torch.memory.chain.plan_chain` on the candidate
    chain -- the exact ``ChainCost`` handoff-vs-roofline comparison, not
    a proxy) and keeps merging while the predicted pipelined time
    improves, or while a ``max_stages`` budget forces it.  Explicit
    ``barriers`` (named cuts) are never merged across.

Merged stages re-enter pattern matching (``flow.patterns``), so a fused
interpolation+gradient chain still dispatches to the GEMM-chain CUDA
kernel (``csrc/gemm_chain.cu``) instead of falling back to plain
PyTorch.  A port of ``repro.memory.fusion``: equal decisions, specs and
report text.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..core import ir
from .chain import ChainStage, ProgramChain


@dataclasses.dataclass(frozen=True)
class FusionSpec:
    """What the fusion pass decided, attached to the resulting plan.

    ``groups`` records the original stage names merged into each fused
    stage (singleton tuples for stages left alone).  ``t_unfused`` /
    ``t_fused`` are the planner's predicted pipelined seconds per batch
    before and after; ``saved_handoff_bytes`` is the per-batch
    inter-stage resident traffic the merges removed.  ``chain`` carries
    the fused :class:`ProgramChain` for execution; it is excluded from
    equality so plans stay comparable across recompiles.
    """

    mode: str
    groups: Tuple[Tuple[str, ...], ...]
    n_stages_before: int
    n_stages_after: int
    t_unfused: float
    t_fused: float
    saved_handoff_bytes: int
    barriers: Tuple[str, ...] = ()
    chain: Optional[ProgramChain] = dataclasses.field(
        default=None, compare=False, repr=False
    )

    @property
    def fused(self) -> bool:
        """True when at least one boundary was erased."""
        return self.n_stages_after < self.n_stages_before

    def describe(self) -> str:
        """One-line summary for plan reports."""
        mib = 2 ** 20
        groups = "".join(
            "[" + "+".join(g) + "]" for g in self.groups if len(g) > 1
        )
        return (
            f"fusion: mode={self.mode}   {self.n_stages_before} -> "
            f"{self.n_stages_after} stages{' ' + groups if groups else ''}"
            f"   saved handoff {self.saved_handoff_bytes / mib:.1f} "
            f"MiB/batch   predicted {self.t_unfused * 1e3:.3f} -> "
            f"{self.t_fused * 1e3:.3f} ms/batch"
        )


def _merge_group(
    chain: ProgramChain, group: Tuple[int, ...]
) -> Tuple[ir.Program, Dict[str, Tuple[int, str]], Dict[Tuple[int, str], str]]:
    """Stitch consecutive stages ``group`` into one program.

    Returns ``(program, binding_sources, out_map)``: the merged program,
    each merged input's origin ``(producer stage index, output name)``
    for inputs still bound outside the group, and the new name of every
    surviving member output (handoffs consumed only inside the group are
    dropped -- that is the fusion).  Unbound inputs (host element
    streams and shared operands) are deduplicated group-wide by bare
    name, matching the chain's shared-operand convention.
    """
    gset = set(group)
    produced: Dict[Tuple[int, str], ir.Node] = {}
    new_inputs: Dict[str, ir.Input] = {}
    by_source: Dict[Tuple[int, str], str] = {}
    by_name: Dict[str, str] = {}
    binding_sources: Dict[str, Tuple[int, str]] = {}
    elem_inputs: List[str] = []
    used = set()

    def uniq(base: str) -> str:
        name, k = base, 2
        while name in used:
            name = f"{base}_{k}"
            k += 1
        used.add(name)
        return name

    for i in group:
        prog = chain.stages[i].program
        elem = set(prog.element_vars)
        mapping: Dict[int, ir.Node] = {}
        for in_name, node in prog.inputs.items():
            src = chain.resolved[i].get(in_name)
            if src is not None and src[0] in gset:
                mapping[node.uid] = produced[src]
            elif src is not None:
                if src not in by_source:
                    name = uniq(in_name)
                    inp = ir.Input(shape=node.shape, name=name)
                    new_inputs[name] = inp
                    by_source[src] = name
                    binding_sources[name] = src
                    elem_inputs.append(name)
                mapping[node.uid] = new_inputs[by_source[src]]
            else:
                if in_name not in by_name:
                    name = uniq(in_name)
                    inp = ir.Input(shape=node.shape, name=name)
                    new_inputs[name] = inp
                    by_name[in_name] = name
                    if in_name in elem:
                        elem_inputs.append(name)
                mapping[node.uid] = new_inputs[by_name[in_name]]
        rebuilt = prog.replace(mapping)
        for out_name, out_node in rebuilt.outputs.items():
            produced[(i, out_name)] = out_node

    out_map: Dict[Tuple[int, str], str] = {}
    merged_outputs: Dict[str, ir.Node] = {}
    out_elem: List[str] = []
    for i in group:
        s = chain.stages[i]
        for out_name in s.program.outputs:
            key = (i, out_name)
            consumed_outside = any(
                src == key
                for j, binds in enumerate(chain.resolved)
                if j not in gset
                for src in binds.values()
            )
            if not consumed_outside and key in chain.consumed:
                continue                    # internal handoff: fused away
            name = (
                out_name if out_name not in merged_outputs
                else f"{s.name}_{out_name}"
            )
            merged_outputs[name] = produced[key]
            out_map[key] = name
            if out_name in s.program.element_vars:
                out_elem.append(name)

    merged = ir.Program(
        inputs=dict(new_inputs),
        outputs=merged_outputs,
        element_vars=tuple(elem_inputs) + tuple(out_elem),
    )
    return merged, binding_sources, out_map


def _compile_merged(merged: ir.Program, members: Sequence[ChainStage]):
    """Compile a merged program, re-running kernel pattern matching.

    Backend choice: if every member used the same backend it is kept;
    any ``pallas`` member makes the merged stage *try* the kernel
    matchers again (``flow.patterns.pallas_impl_for``) and fall back to
    ``xla`` only when the fused program fits no kernel class.  A program
    that matches always compiles onto its kernel: a kernel that later
    refuses the recipe raises at launch, never turning into ``xla``.
    """
    from ..core import emit
    policy = members[0].compiled.policy
    backends = {s.backend for s in members}
    if "pallas" in backends:
        from ..flow import patterns  # lazy: flow imports memory
        impl = patterns.pallas_impl_for(merged)
        if impl is not None:
            return emit.compile_program(
                merged, policy=policy, backend="pallas", pallas_impl=impl
            )
        return emit.compile_program(merged, policy=policy, backend="xla")
    backend = backends.pop() if len(backends) == 1 else "xla"
    return emit.compile_program(merged, policy=policy, backend=backend)


def fuse_chain(
    chain: ProgramChain, groups: Sequence[Tuple[int, ...]]
) -> ProgramChain:
    """Merge adjacent-stage ``groups`` of a chain into single stages.

    ``groups`` must partition ``range(len(chain.stages))`` into runs of
    consecutive indices, in order.  Singleton groups keep their compiled
    program untouched (bindings are re-qualified only); multi-stage
    groups are stitched by :func:`_merge_group` and recompiled, with
    kernel pattern matching re-run on the merged program.  Raises
    ``ValueError`` on a malformed grouping.
    """
    flat = [i for g in groups for i in g]
    if flat != list(range(len(chain.stages))):
        raise ValueError(
            f"groups {list(groups)} must partition "
            f"0..{len(chain.stages) - 1} in order"
        )

    metas = []  # (name, compiled, binding_sources, out_map)
    for g in groups:
        members = [chain.stages[i] for i in g]
        name = "+".join(s.name for s in members)
        if len(g) == 1:
            i = g[0]
            srcs = dict(chain.resolved[i])
            out_map = {
                (i, o): o for o in chain.stages[i].program.outputs
            }
            metas.append((name, members[0].compiled, srcs, out_map))
        else:
            merged, srcs, out_map = _merge_group(chain, tuple(g))
            metas.append(
                (name, _compile_merged(merged, members), srcs, out_map)
            )

    out_name_of: Dict[Tuple[int, str], Tuple[str, str]] = {}
    for name, _, _, out_map in metas:
        for src, new_out in out_map.items():
            out_name_of[src] = (name, new_out)

    new_stages = []
    for name, compiled, srcs, _ in metas:
        binds = {}
        for in_name, src in srcs.items():
            p_name, p_out = out_name_of[src]
            binds[in_name] = f"{p_name}.{p_out}"
        new_stages.append(ChainStage(name, compiled, binds))
    return ProgramChain(new_stages)


def _collapse(value, groups):
    """Collapse a per-original-stage vector knob group-wise (by max)."""
    if isinstance(value, (list, tuple)):
        return [max(value[i] for i in g) for g in groups]
    return value


def _collapse_backends(backends, groups):
    if backends is None:
        return None
    out = []
    for g in groups:
        got = {backends[i] for i in g}
        if len(got) == 1:
            out.append(got.pop())
        elif "pallas" in got:
            out.append("pallas")
        else:
            out.append("xla")
    return out


def fuse_chain_auto(
    chain: ProgramChain,
    *,
    mode: str = "auto",
    max_stages: Optional[int] = None,
    barriers: Sequence[str] = (),
    target=None,
    policy: str = "float32",
    backends: Optional[Sequence[str]] = None,
    batch_elements: Optional[int] = None,
    prefetch_depth=1,
    cu_count=1,
    topology=None,
    n_eq: Optional[int] = None,
    channel_bytes: Optional[int] = None,
    profile=None,
):
    """Greedy cost-driven fusion: merge stages while the planner agrees.

    Starting from the unfused chain, every adjacent-pair merge candidate
    is priced by planning the *actual* fused chain (cheap: compilation
    is lazy, planning is analytic), and the best one is adopted while it
    strictly improves the predicted pipelined time -- i.e. while the
    HBM-resident handoff plus its fill/drain and dispatch cost more than
    the merged stage's combined roofline.  With ``max_stages`` set,
    least-harm merges continue past the profit point until the stage
    budget is met (``max_stages=1`` fully fuses).  Boundaries after a
    stage named in ``barriers`` are never merged.

    Remaining keyword arguments mirror
    :func:`~repro_torch.memory.chain.plan_chain`; per-original-stage vector
    knobs (``prefetch_depth``, ``cu_count``, ``backends``) are collapsed
    group-wise as stages merge.  Returns the fused chain's
    :class:`~repro_torch.memory.chain.ChainPlan` with a :class:`FusionSpec`
    attached (``plan.fusion``), spec'd against the unfused baseline; its
    ``chain``'s kernel stages run at their kernel's default tile, which
    is the block the plan carries on the H100.
    ``profile`` re-prices the returned plan's contention from measured
    stage samples (:func:`~repro_torch.memory.chain.apply_profile_contention`).
    """
    from .chain import apply_profile_contention, plan_chain

    n = len(chain.stages)
    barrier_set = set(barriers)
    unknown = barrier_set - {s.name for s in chain.stages}
    if unknown:
        raise ValueError(
            f"fusion barriers name unknown stages: {sorted(unknown)}"
        )

    def plan_for(fused_chain, groups):
        return plan_chain(
            fused_chain,
            target=target,
            policy=policy,
            backends=_collapse_backends(backends, groups),
            batch_elements=batch_elements,
            prefetch_depth=_collapse(prefetch_depth, groups),
            cu_count=_collapse(cu_count, groups),
            topology=topology,
            n_eq=n_eq,
            channel_bytes=channel_bytes,
        )

    def score(plan):
        return (not plan.feasible, plan.cost.t_pipelined)

    groups: List[Tuple[int, ...]] = [(i,) for i in range(n)]
    cur_chain = chain
    cur_plan = plan_for(chain, groups)
    base_plan = cur_plan
    want = max(1, max_stages) if max_stages is not None else None

    while len(groups) > 1:
        best = None
        for k in range(len(groups) - 1):
            if chain.stages[groups[k][-1]].name in barrier_set:
                continue
            cand_groups = (
                groups[:k] + [groups[k] + groups[k + 1]] + groups[k + 2:]
            )
            cand_chain = fuse_chain(chain, cand_groups)
            cand_plan = plan_for(cand_chain, cand_groups)
            if best is None or score(cand_plan) < score(best[1]):
                best = (cand_groups, cand_plan, cand_chain)
        if best is None:
            break                              # every boundary is a barrier
        improves = score(best[1]) < score(cur_plan)
        forced = want is not None and len(groups) > want
        if not improves and not forced:
            break
        groups, cur_plan, cur_chain = best

    spec = FusionSpec(
        mode=mode,
        groups=tuple(
            tuple(chain.stages[i].name for i in g) for g in groups
        ),
        n_stages_before=n,
        n_stages_after=len(groups),
        t_unfused=base_plan.cost.t_pipelined,
        t_fused=cur_plan.cost.t_pipelined,
        saved_handoff_bytes=max(
            0,
            base_plan.resident_stream_bytes
            - cur_plan.resident_stream_bytes,
        ),
        barriers=tuple(sorted(barrier_set)),
        chain=cur_chain,
    )
    plan = dataclasses.replace(cur_plan, fusion=spec)
    if profile is not None:
        plan = apply_profile_contention(plan, profile)
    return plan
