"""Operator scheduling: partition the tensor value graph into dataflow
groups (paper section 3.4.3).

The paper's heuristic, ported to the TPU cost model:

  * start with the most aggressive partition -- one group per tensor value;
  * collapse chains greedily under a *memory budget* (PLM/DSP on the FPGA,
    VMEM bytes here) because fewer stages use fewer resources;
  * the group with the longest interval (cycle estimate ~ sum of trip
    counts ~ FLOPs here) lower-bounds the pipeline latency, so that
    interval is used as the collapse budget: merging must never create a
    group longer than the current critical group.

On TPU the "streams" between groups are HBM round-trips (group boundary =
materialized intermediate), while everything inside one group stays in
VMEM of a single fused kernel.  So the schedule directly controls the
memory-roofline term; the perf loop (EXPERIMENTS.md section Perf) iterates
on this structure.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

from . import ir

#: Default budget: a fused group's working set must fit comfortably in
#: TPU v5e VMEM (128 MiB per core; keep half for double buffering).
DEFAULT_VMEM_BUDGET = 64 * 1024 * 1024


@dataclasses.dataclass
class Group:
    """One dataflow stage: a connected set of IR nodes.

    ``bytes_per_scalar`` records the scalar width of the policy the
    schedule was built for; byte-count methods default to it, so a
    bfloat16 schedule reports 2-byte streams without every caller having
    to re-thread the width (historically they defaulted to 4, silently
    disagreeing with low-precision policies).
    """

    nodes: List[ir.Node]
    #: values flowing in from other groups or program inputs
    in_streams: List[ir.Node]
    #: values consumed by later groups or program outputs
    out_streams: List[ir.Node]
    name: str = ""
    bytes_per_scalar: int = 4

    @property
    def flops(self) -> int:
        return sum(n.flops() for n in self.nodes)

    def _bps(self, bytes_per_scalar: int | None) -> int:
        return (
            self.bytes_per_scalar
            if bytes_per_scalar is None else bytes_per_scalar
        )

    def working_set(self, bytes_per_scalar: int | None = None) -> int:
        """Bytes resident while the group executes: inputs + outputs +
        internal temporaries (before liveness sharing)."""
        bps = self._bps(bytes_per_scalar)
        vals: Set[int] = set()
        total = 0
        for n in list(self.nodes) + list(self.in_streams):
            if n.uid not in vals:
                vals.add(n.uid)
                total += n.size * bps
        return total

    def in_stream_bytes(self, bytes_per_scalar: int | None = None) -> int:
        """Bytes flowing into this group per element (HBM reads)."""
        return sum(n.size for n in self.in_streams) * self._bps(
            bytes_per_scalar
        )

    def out_stream_bytes(self, bytes_per_scalar: int | None = None) -> int:
        """Bytes this group materializes per element (HBM writes)."""
        return sum(n.size for n in self.out_streams) * self._bps(
            bytes_per_scalar
        )


@dataclasses.dataclass
class Schedule:
    groups: List[Group]
    program: ir.Program
    #: scalar width the schedule was built for (policy.bits // 8); byte
    #: methods use it when no explicit width is passed
    bytes_per_scalar: int = 4

    @property
    def critical_flops(self) -> int:
        """The longest group bounds pipeline throughput (paper 3.4.3)."""
        return max(g.flops for g in self.groups) if self.groups else 0

    def _bps(self, bytes_per_scalar: int | None) -> int:
        return (
            self.bytes_per_scalar
            if bytes_per_scalar is None else bytes_per_scalar
        )

    def stream_bytes(
        self, bytes_per_scalar: int | None = None
    ) -> Dict[str, int]:
        """Bytes each group materializes across its boundary, per element
        (the HBM round-trip cost the memory planner prices)."""
        bps = self._bps(bytes_per_scalar)
        return {
            g.name: g.out_stream_bytes(bps) for g in self.groups
        }

    def stream_io_bytes(
        self, bytes_per_scalar: int | None = None
    ) -> Dict[str, Tuple[int, int]]:
        """Per-group (in, out) stream bytes per element -- the planner's
        view of every dataflow edge (paper Fig. 14's FIFO widths)."""
        bps = self._bps(bytes_per_scalar)
        return {
            g.name: (
                g.in_stream_bytes(bps),
                g.out_stream_bytes(bps),
            )
            for g in self.groups
        }

    def summary(self, bytes_per_scalar: int | None = None) -> str:
        bps = self._bps(bytes_per_scalar)
        lines = [
            f"{'group':<12} {'nodes':>5} {'flops':>12} {'ws_bytes':>10} "
            f"{'in_B':>8} {'out_B':>8}"
        ]
        for g in self.groups:
            lines.append(
                f"{g.name:<12} {len(g.nodes):>5} {g.flops:>12} "
                f"{g.working_set(bps):>10} "
                f"{g.in_stream_bytes(bps):>8} "
                f"{g.out_stream_bytes(bps):>8}"
            )
        return "\n".join(lines)


def schedule(
    prog: ir.Program,
    *,
    vmem_budget: int = DEFAULT_VMEM_BUDGET,
    bytes_per_scalar: int = 4,
    max_groups: int | None = None,
) -> Schedule:
    """Greedy chain-collapse scheduling (paper heuristic).

    ``max_groups`` optionally forces further collapsing (the paper's
    1/2/3/7-compute-module experiments are reproduced by sweeping it).
    """
    order = [n for n in prog.toposort() if not isinstance(n, ir.Input)]
    if not order:
        return Schedule(
            groups=[], program=prog, bytes_per_scalar=bytes_per_scalar
        )

    # --- initial partition: one group per value --------------------------
    group_of: Dict[int, int] = {n.uid: i for i, n in enumerate(order)}
    members: Dict[int, List[ir.Node]] = {i: [n] for i, n in enumerate(order)}

    uses: Dict[int, List[ir.Node]] = {}
    for n in order:
        for op in n.operands():
            uses.setdefault(op.uid, []).append(n)
    outputs = {v.uid for v in prog.outputs.values()}

    def group_flops(gid: int) -> int:
        return sum(n.flops() for n in members[gid])

    def group_ws(gid: int) -> int:
        vals: Set[int] = set()
        tot = 0
        node_uids = {n.uid for n in members[gid]}
        for n in members[gid]:
            for v in (n, *n.operands()):
                if v.uid not in vals:
                    vals.add(v.uid)
                    tot += v.size * bytes_per_scalar
        return tot

    critical = max(group_flops(i) for i in members)

    # --- collapse chains: producer feeding a single consumer -------------
    def try_merge(budget_flops: int) -> bool:
        merged_any = False
        for n in order:
            gid = group_of[n.uid]
            users = [u for u in uses.get(n.uid, []) if group_of[u.uid] != gid]
            distinct = {group_of[u.uid] for u in users}
            if len(distinct) != 1 or n.uid in outputs:
                continue
            tgt = distinct.pop()
            combined_flops = group_flops(gid) + group_flops(tgt)
            if combined_flops > budget_flops:
                continue
            # memory check on the union
            union_nodes = members[gid] + members[tgt]
            vals: Set[int] = set()
            ws = 0
            for m in union_nodes:
                for v in (m, *m.operands()):
                    if v.uid not in vals:
                        vals.add(v.uid)
                        ws += v.size * bytes_per_scalar
            if ws > vmem_budget:
                continue
            for m in members[gid]:
                group_of[m.uid] = tgt
            members[tgt] = members[gid] + members[tgt]
            del members[gid]
            merged_any = True
        return merged_any

    # collapse under the critical interval first (never lengthen the
    # critical path), then, if a stage-count target is given, relax.
    while try_merge(critical):
        pass
    if max_groups is not None:
        budget = critical
        while len(members) > max_groups:
            budget *= 2
            if not try_merge(budget):
                if budget > sum(n.flops() for n in order) * 4:
                    break

    # --- build Group objects in topo order --------------------------------
    gids_in_order: List[int] = []
    for n in order:
        gid = group_of[n.uid]
        if gid not in gids_in_order:
            gids_in_order.append(gid)

    groups: List[Group] = []
    for idx, gid in enumerate(gids_in_order):
        nodes = [n for n in order if group_of[n.uid] == gid]
        node_uids = {n.uid for n in nodes}
        ins: List[ir.Node] = []
        seen_in: Set[int] = set()
        for n in nodes:
            for op in n.operands():
                if op.uid not in node_uids and op.uid not in seen_in:
                    seen_in.add(op.uid)
                    ins.append(op)
        outs: List[ir.Node] = []
        for n in nodes:
            external_use = any(
                group_of[u.uid] != gid for u in uses.get(n.uid, [])
            )
            if external_use or n.uid in outputs:
                outs.append(n)
        groups.append(
            Group(nodes=nodes, in_streams=ins, out_streams=outs,
                  name=f"g{idx}", bytes_per_scalar=bytes_per_scalar)
        )

    # human-friendly names for the paper's canonical 3-stage split
    if len(groups) == 3:
        groups[0].name, groups[1].name, groups[2].name = (
            "gemm", "mmult", "gemm_inv",
        )
    return Schedule(
        groups=groups, program=prog, bytes_per_scalar=bytes_per_scalar
    )


def stage_partition(sched: Schedule) -> List[List[ir.Node]]:
    """Scheduled groups as pipeline-stage node lists (the ``repro.flow``
    stage-extraction hook).

    Group boundaries become chain-stage boundaries, with one adjustment:
    a group containing no element-dependent work (a pure function of
    shared operands, e.g. a precomputed operator product) cannot stream
    batches on its own, so its nodes are duplicated into *every* group
    that consumes one of its values -- folding into only the earliest
    consumer would leave the later consumers reading an element-free
    cross-stage stream, which the flow rejects (it pipelines element
    streams only).  The recompute is batch-invariant and tiny, exactly
    the paper's precomputed-operand case.  Node order inside each stage
    follows the program's topological order.
    """
    prog = sched.program
    elem_dep = prog.element_dependent_uids()
    topo_pos = {n.uid: i for i, n in enumerate(prog.toposort())}

    stages: List[List[ir.Node]] = [list(g.nodes) for g in sched.groups]
    # fold element-free groups forward, last-to-first so cascades settle
    for i in range(len(stages) - 1, -1, -1):
        if any(n.uid in elem_dep for n in stages[i]):
            continue
        produced = {n.uid for n in stages[i]}
        consumers = [
            j for j in range(i + 1, len(stages))
            if any(
                op.uid in produced
                for n in stages[j] for op in n.operands()
            )
        ]
        if not consumers:
            continue  # feeds nothing later (an element-free output)
        for j in consumers:
            stages[j] = stages[i] + stages[j]
        stages[i] = []
    out: List[List[ir.Node]] = []
    for s in stages:
        if not s:
            continue
        dedup = list({n.uid: n for n in s}.values())
        out.append(sorted(dedup, key=lambda n: topo_pos[n.uid]))
    return out
