"""Buffer layout: map a program's streams onto the channel model.

Performs the paper's section-3 sizing decisions explicitly:

  * **stream discovery** -- element-streamed inputs/outputs vs. shared
    (batch-invariant) operands, straight from ``ir.Program.element_vars``;
    with a staged schedule, per-group intermediates become HBM round-trip
    buffers too (``core.schedule`` exposes their byte counts).
  * **packing/padding** -- each element record is padded to the target's
    burst quantum (the paper packs p^3 scalars into 256-bit HBM words).
  * **batch sizing** -- E is derived so one batch's combined stream I/O
    fills one pseudo-channel, exactly the rule behind
    ``SimConfig.batch_for_channel`` but computed from the program instead
    of hardcoded in the driver.
  * **channel assignment** -- round-robin placement of every replica
    (ping/pong copies for a K-deep prefetch) over the pseudo-channels.
  * **VMEM block sizing** -- the largest per-dispatch element block whose
    working set fits the target's on-chip memory, which is what drives
    the Pallas kernel's ``block_elements`` (the paper's PLM sizing).  On
    the H100 a kernel stage's block is the CUDA kernel's tile instead
    (:func:`stage_block`), and E is not padded to it.

``ProgramChain`` planning (``memory.chain``) reuses these primitives with
a shared :class:`ChannelAllocator` so all stages of a multi-operator
program place their buffers without conflicts.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..core import ir
from ..core.schedule import Schedule
from .channels import (
    KERNEL_TILE_TARGETS, MemoryTarget, channels_for, pad_to_burst,
)
from .plan import BufferSpec


def element_streams(prog: ir.Program):
    """Split program arrays into (element inputs, element outputs, shared).

    Element arrays carry the implicit leading batch axis; shared arrays
    (the paper's S operator) are broadcast across the batch.
    """
    elem = set(prog.element_vars)
    ins = [(n, v) for n, v in prog.inputs.items() if n in elem]
    outs = [(n, v) for n, v in prog.outputs.items() if n in elem]
    shared = [(n, v) for n, v in prog.inputs.items() if n not in elem]
    return ins, outs, shared


def stream_bytes_per_element(prog: ir.Program, bytes_per_scalar: int) -> int:
    """Unpadded host-stream bytes per element (in + out), the quantity
    ``SimConfig.batch_for_channel`` divides a channel by."""
    ins, outs, _ = element_streams(prog)
    return sum(v.size for _, v in ins + outs) * bytes_per_scalar


def auto_batch_elements(
    prog: ir.Program,
    target: MemoryTarget,
    *,
    bytes_per_scalar: int,
    channel_bytes: Optional[int] = None,
    n_eq: Optional[int] = None,
) -> int:
    """The paper's E: largest batch whose stream I/O fits one channel.

    ``n_eq`` caps E at the problem size (no point staging a batch larger
    than the whole simulation).
    """
    cb = channel_bytes if channel_bytes is not None else target.channel_bytes
    per = stream_bytes_per_element(prog, bytes_per_scalar)
    e = max(1, cb // per)
    if n_eq is not None:
        e = min(e, max(1, n_eq))
    return int(e)


class ChannelAllocator:
    """Round-robin pseudo-channel assignment (Fig. 14's array->channel
    map).  A buffer spanning more channels than exist wraps -- capacity
    feasibility is checked globally by the DSE, not here.  One take never
    repeats a channel (no double-booking within one replica set); chain
    planning shares a single allocator across all stages so no two
    stages' hot streams pile onto channel 0.

    ``base`` offsets the allotted ids into a global channel namespace:
    heterogeneous chain planning runs one allocator per device group, so
    a stream lands on the pseudo-channels of the group that owns its
    producing stage (group 0 gets ids ``[0, n0)``, group 1 gets
    ``[n0, n0+n1)``, ...)."""

    def __init__(self, n_channels: int, base: int = 0):
        self.n = n_channels
        self.base = base
        self.next = 0

    def take(self, count: int) -> Tuple[int, ...]:
        """Allot the next ``count`` channel ids round-robin (capped at
        the channel count -- wide buffers stripe what exists)."""
        count = max(1, count)
        ids = tuple(
            self.base + (self.next + i) % self.n
            for i in range(min(count, self.n))
        )
        self.next = (self.next + count) % self.n
        return ids


#: Backwards-compatible alias (pre-chain name).
_ChannelAllocator = ChannelAllocator


def make_buffer(
    name: str,
    node: ir.Node,
    role: str,
    replicas: int,
    *,
    target: MemoryTarget,
    bytes_per_scalar: int,
    batch_elements: int,
    alloc: ChannelAllocator,
    group: str = "",
) -> BufferSpec:
    """Size, pad, and channel-assign one stream (shared by single-program
    and chain planning)."""
    eb = node.size * bytes_per_scalar
    pb = pad_to_burst(eb, target)
    bb = pb * batch_elements if role != "shared" else pb
    ch = alloc.take(replicas * channels_for(bb, target))
    return BufferSpec(
        name=name, role=role, shape=tuple(node.shape),
        element_bytes=eb, padded_bytes=pb, batch_bytes=bb,
        replicas=replicas, channels=ch, group=group,
    )


def build_buffers(
    prog: ir.Program,
    target: MemoryTarget,
    *,
    bytes_per_scalar: int,
    batch_elements: int,
    prefetch_depth: int,
    schedule: Optional[Schedule] = None,
) -> Tuple[BufferSpec, ...]:
    """Assign every stream of the program to sized, channel-mapped buffers."""
    ins, outs, shared = element_streams(prog)
    alloc = ChannelAllocator(target.n_channels)
    bufs: List[BufferSpec] = []

    # K-deep prefetch keeps K staged batches, one computing, and -- since
    # JAX allocates fresh buffers instead of swapping a ping/pong pair in
    # place -- one retiring batch whose async compute has not yet freed
    # it.  Peak input residency is therefore K+2 (K=1 is the paper's
    # ping/pong pair plus the retiring slot).
    in_replicas = prefetch_depth + 2 if prefetch_depth > 0 else 1
    out_replicas = 2 if prefetch_depth > 0 else 1  # result drains while next computes

    def add(name, node, role, replicas, group=""):
        bufs.append(
            make_buffer(
                name, node, role, replicas, target=target,
                bytes_per_scalar=bytes_per_scalar,
                batch_elements=batch_elements, alloc=alloc, group=group,
            )
        )

    for name, node in ins:
        add(name, node, "in", in_replicas)
    for name, node in outs:
        add(name, node, "out", out_replicas)
    for name, node in shared:
        add(name, node, "shared", 1)

    # staged backend: group-boundary intermediates are HBM round-trips
    if schedule is not None:
        out_uids = {v.uid for v in prog.outputs.values()}
        input_uids = {v.uid for v in prog.inputs.values()}
        for g in schedule.groups:
            streamed = [
                n for n in g.out_streams
                if n.uid not in out_uids and n.uid not in input_uids
            ]
            for i, node in enumerate(streamed):
                add(f"{g.name}.s{i}", node, "inter", 1, group=g.name)
    return tuple(bufs)


# ---------------------------------------------------------------------------
# on-chip (VMEM / PLM) block sizing -- what drives the Pallas kernel's
# block_elements (the paper sizes its PLM buffers the same way)
# ---------------------------------------------------------------------------


def block_working_set_bytes(
    prog: ir.Program, block_elements: int, *, bytes_per_scalar: int
) -> int:
    """On-chip bytes while one element block flows through the fused
    kernel: every element stream's block slice, double-buffered scratch
    for the largest intermediate (Mnemosyne-style t/r sharing keeps two
    live), plus the batch-invariant operands held resident."""
    ins, outs, shared = element_streams(prog)
    elem = sum(v.size for _, v in ins + outs)
    scratch = 2 * max(
        (n.size for n in prog.toposort() if not isinstance(n, ir.Input)),
        default=0,
    )
    shared_b = sum(v.size for _, v in shared)
    return (shared_b + block_elements * (elem + scratch)) * bytes_per_scalar


def vmem_block_elements(
    prog: ir.Program,
    target: MemoryTarget,
    *,
    bytes_per_scalar: int,
    reserve_fraction: float = 0.5,
) -> int:
    """Largest power-of-two element block whose working set fits the
    target's on-chip memory (half is reserved for the grid pipeline's
    DMA double buffering, mirroring ``core.schedule``'s VMEM budget)."""
    budget = int(target.vmem_bytes * reserve_fraction)
    be = 1
    while block_working_set_bytes(
        prog, be * 2, bytes_per_scalar=bytes_per_scalar
    ) <= budget:
        be *= 2
    return be


def pad_batch_for_block(
    e: int,
    block_cap: int,
    *,
    limit: Optional[int] = None,
    caps: Optional[Sequence[int]] = None,
) -> Tuple[int, int]:
    """Auto-pad E to a block-composite size (ROADMAP: a prime-ish
    natural E must never force the Pallas block divisor tiny).

    Rounds E up to the next multiple of the (power-of-two) VMEM block
    cap, so ``largest_divisor_leq(E, cap) == cap`` -- the paper pads the
    tail batch the same way it pads records to HBM words.  E is left
    alone when its natural block is already at least half the cap (no
    filler for a near-optimal divisor); for chain planning, pass every
    stage's cap via ``caps`` so that check covers the *smallest* stage
    too (a multiple of the largest power-of-two cap divides the rest).
    ``limit`` (the problem size ``n_eq``) bounds the padded batch: when
    rounding up would exceed it, E snaps *down* to the nearest block
    multiple instead (never below one block).  Returns ``(padded_e,
    pad)`` with ``pad = padded_e - e`` (negative when snapped down);
    the plan reports the pad so the host knows how many tail elements
    per batch are filler.
    """
    all_caps = [block_cap] + [c for c in (caps or ())]
    block_cap = max(all_caps)
    if block_cap <= 1 or e <= block_cap:
        return e, 0
    if all(
        c <= 1 or e <= c or largest_divisor_leq(e, c) * 2 >= c
        for c in all_caps
    ):
        return e, 0  # natural E already composite enough: no filler
    up = -(-e // block_cap) * block_cap
    if limit is None or up <= limit:
        return up, up - e
    down = (e // block_cap) * block_cap
    if down >= block_cap:
        return down, down - e
    return e, 0


def largest_divisor_leq(n: int, bound: int) -> int:
    """Largest divisor of ``n`` that is <= ``bound`` (>= 1).  Pallas grids
    require block_elements to divide the batch, so the VMEM-derived block
    is snapped to the nearest feasible divisor of E."""
    n, bound = max(1, n), max(1, bound)
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            if d <= bound:
                best = max(best, d)
            if n // d <= bound:
                best = max(best, n // d)
        d += 1
    return best


# ---------------------------------------------------------------------------
# the H100: the plan's block is the CUDA kernel's tile
# ---------------------------------------------------------------------------

def kernel_tiles(target: MemoryTarget) -> bool:
    """True where the plan's block is the CUDA kernels' tile
    (``channels.KERNEL_TILE_TARGETS`` says why)."""
    return target.name in KERNEL_TILE_TARGETS


def batch_block_cap(
    prog: ir.Program, target: MemoryTarget, *, bytes_per_scalar: int
) -> int:
    """The block an auto-sized batch is padded to a multiple of: the
    VMEM block on the reference's targets (a Pallas grid needs it to
    divide E), 1 on the H100, whose kernels walk a ragged last tile."""
    if kernel_tiles(target):
        return 1
    return vmem_block_elements(
        prog, target, bytes_per_scalar=bytes_per_scalar
    )


def stage_block(
    prog: ir.Program,
    target: MemoryTarget,
    batch_elements: int,
    *,
    bytes_per_scalar: int,
    kernel: bool,
    te: Optional[int] = None,
) -> Tuple[int, int]:
    """A stage's block and its on-chip bytes, ``(BE, working set)``.

    A ``kernel`` stage (a float ``pallas`` stage) on the H100 takes the
    tile of the CUDA kernel ``flow.patterns`` matches -- ``te`` or the
    kernel's default -- and its CTA's shared bytes.  Everywhere else BE
    is the reference's: the largest divisor of E whose working set fits
    the VMEM block cap."""
    if kernel and kernel_tiles(target):
        from ..flow import patterns  # lazy: flow builds on memory

        tile = patterns.kernel_tile_for(prog, bytes_per_scalar, te)
        if tile is not None:
            return tile[0], tile[2]
    cap = vmem_block_elements(prog, target, bytes_per_scalar=bytes_per_scalar)
    blk = te or largest_divisor_leq(batch_elements, cap)
    return blk, block_working_set_bytes(
        prog, blk, bytes_per_scalar=bytes_per_scalar
    )
