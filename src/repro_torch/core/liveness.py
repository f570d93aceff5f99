"""Buffer liveness + sharing plan (the Mnemosyne analogue).

Mnemosyne assigns kernel-internal arrays with disjoint lifetimes to the
same physical BRAM banks.  On TPU the scarce tier is VMEM scratch inside a
fused kernel (and, at the XLA level, donated HBM buffers).  We compute the
same interval-graph coloring:

  * linear-scan liveness over the topological order of a group;
  * greedy first-fit assignment of values to *slots*, where a slot can be
    reused once every reader of its previous occupant has executed;
  * slots are size-classed by byte size (a value only reuses a slot at
    least as large as itself).

The resulting plan feeds (a) `scratch_shapes` sizing for fused Pallas
kernels and (b) the memory-sharing numbers reported in the benchmarks
(paper Table 3, "Mem Sharing" row).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from . import ir
from .schedule import Group


@dataclasses.dataclass
class SharingPlan:
    #: value uid -> slot index
    slot_of: Dict[int, int]
    #: slot index -> byte size
    slot_bytes: List[int]
    #: total bytes without sharing
    naive_bytes: int

    @property
    def shared_bytes(self) -> int:
        return sum(self.slot_bytes)

    @property
    def savings_frac(self) -> float:
        if self.naive_bytes == 0:
            return 0.0
        return 1.0 - self.shared_bytes / self.naive_bytes


def liveness_intervals(
    nodes: Sequence[ir.Node],
) -> Dict[int, Tuple[int, int]]:
    """[def, last_use] index intervals over the given order."""
    pos = {n.uid: i for i, n in enumerate(nodes)}
    last_use: Dict[int, int] = {n.uid: pos[n.uid] for n in nodes}
    for i, n in enumerate(nodes):
        for op in n.operands():
            if op.uid in last_use:
                last_use[op.uid] = max(last_use[op.uid], i)
    return {uid: (pos[uid], last_use[uid]) for uid in pos}


def plan_sharing(group: Group, bytes_per_scalar: int = 4) -> SharingPlan:
    """First-fit interval packing of the group's internal values.

    Streams (group inputs/outputs) are excluded: they are pinned for the
    whole stage, exactly as Mnemosyne only shares kernel-local buffers.
    """
    pinned = {n.uid for n in group.in_streams} | {
        n.uid for n in group.out_streams
    }
    internal = [n for n in group.nodes if n.uid not in pinned]
    intervals = liveness_intervals(group.nodes)

    slot_of: Dict[int, int] = {}
    slot_bytes: List[int] = []
    slot_free_at: List[int] = []  # order index after which the slot is free
    naive = 0
    for n in sorted(internal, key=lambda m: intervals[m.uid][0]):
        size = n.size * bytes_per_scalar
        naive += size
        start, end = intervals[n.uid]
        placed = False
        for s in range(len(slot_bytes)):
            if slot_free_at[s] < start and slot_bytes[s] >= size:
                slot_of[n.uid] = s
                slot_free_at[s] = end
                placed = True
                break
        if not placed:
            slot_of[n.uid] = len(slot_bytes)
            slot_bytes.append(size)
            slot_free_at.append(end)
    return SharingPlan(slot_of=slot_of, slot_bytes=slot_bytes, naive_bytes=naive)


def plan_program(groups: Sequence[Group], bytes_per_scalar: int = 4) -> Dict[str, SharingPlan]:
    return {g.name: plan_sharing(g, bytes_per_scalar) for g in groups}


# ---------------------------------------------------------------------------
# cross-stage stream classification (the repro.flow residency hook)
# ---------------------------------------------------------------------------

#: classification labels for values crossing a stage boundary
STREAM_RESIDENT = "resident"   # consumed by a later stage only: stays in HBM
STREAM_HOST = "host"           # program output only: crosses the host link
STREAM_BOTH = "both"           # program output also consumed downstream


def classify_boundary_streams(
    prog, stage_nodes: Sequence[Sequence["ir.Node"]]
) -> Dict[int, str]:
    """Classify every value that crosses a stage boundary.

    Given a partition of the program's nodes into pipeline stages (see
    ``schedule.stage_partition``), the liveness of each produced value
    decides where it lives: a value whose only readers are later stages
    never needs the host link (``resident`` -- the chain planner prices
    it as an HBM round-trip), a program output with no later readers is
    ``host``-streamed, and an output that later stages also read is
    ``both``.  Values consumed only inside their producing stage do not
    appear in the result.
    """
    stage_of: Dict[int, int] = {}
    stage_sets = [
        {n.uid for n in nodes} for nodes in stage_nodes
    ]
    for i, nodes in enumerate(stage_nodes):
        for n in nodes:
            stage_of[n.uid] = i
    output_uids = {v.uid for v in prog.outputs.values()}
    crossers: Dict[int, str] = {}
    for i, nodes in enumerate(stage_nodes):
        for n in nodes:
            for op in n.operands():
                if op.uid in stage_sets[i]:
                    # produced in this very stage (possibly a duplicated
                    # element-free node): no boundary crossing
                    continue
                if op.uid in stage_of:
                    crossers[op.uid] = (
                        STREAM_BOTH if op.uid in output_uids
                        else STREAM_RESIDENT
                    )
    for uid in output_uids:
        if uid in stage_of and uid not in crossers:
            crossers[uid] = STREAM_HOST
    return crossers
