"""MemoryPlan: the explicit memory architecture for one compiled program.

This is the artifact the paper's Olympus flow produces implicitly when it
instantiates Fig. 14: which array lives in which pseudo-channel, how many
ping/pong replicas each stream keeps resident, how big a batch (E) is,
and what the transfer/compute overlap is predicted to cost.  The plan is
pure data (frozen dataclasses) so it can be diffed, cached, and compared
across DSE candidates; ``report()`` renders the human-readable dump.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

from .channels import MemoryTarget


def host_stream_bytes(buffers: Iterable["BufferSpec"]) -> int:
    """Host-link bytes moved per batch (in + out streams, padded)."""
    return sum(b.batch_bytes for b in buffers if b.role in ("in", "out"))


def hbm_stream_bytes(buffers: Iterable["BufferSpec"]) -> int:
    """Device-memory traffic per batch: every stream crosses HBM once;
    stage intermediates and chain-resident streams cross twice (the
    producer writes, the consumer reads back) -- but never the host
    link."""
    total = 0
    for b in buffers:
        if b.role in ("in", "out"):
            total += b.batch_bytes
        elif b.role in ("inter", "resident"):
            total += 2 * b.batch_bytes
    return total


def channels_used(buffers: Iterable["BufferSpec"]) -> int:
    """Distinct pseudo-channel ids the buffers map to."""
    used = set()
    for b in buffers:
        used.update(b.channels)
    return len(used)


@dataclasses.dataclass(frozen=True)
class BufferSpec:
    """One device-resident buffer and its pseudo-channel placement.

    Roles:
      * ``in``     -- host-streamed input (E-element batch; a K-deep
                      prefetch pipeline keeps K+2 replicas resident:
                      K staged + 1 computing + 1 retiring -- Fig. 14a's
                      ping/pong pair generalized, plus the slot JAX
                      frees only when the async compute completes).
      * ``out``    -- device-produced batch streamed back / reduced.
      * ``shared`` -- batch-invariant operand (the paper's S matrix),
                      resident once.
      * ``inter``  -- scheduled-group intermediate (staged backend): an
                      HBM round-trip between dataflow stages.
      * ``resident`` -- chain stream (``memory.chain``): a producer
                      stage's output consumed by a later stage of the
                      same ProgramChain.  It stays in HBM -- written once,
                      read once, never crossing the host link.
    """

    name: str
    role: str
    shape: Tuple[int, ...]      # per-element shape (element axis excluded)
    element_bytes: int          # unpadded bytes per element record
    padded_bytes: int           # after burst/word packing
    batch_bytes: int            # padded_bytes * E (shared: padded_bytes)
    replicas: int               # concurrently-resident copies
    channels: Tuple[int, ...]   # assigned pseudo-channel ids
    group: str = ""             # producing schedule group (inter only)

    @property
    def resident_bytes(self) -> int:
        """HBM footprint: one batch per ping/pong replica."""
        return self.batch_bytes * self.replicas

    @property
    def padding_overhead(self) -> float:
        """Fraction of the buffer that is alignment padding."""
        if self.element_bytes == 0:
            return 0.0
        return self.padded_bytes / self.element_bytes - 1.0


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """Predicted per-batch seconds under the three-term transfer model."""

    t_compute: float     # FLOPs / (peak * policy efficiency * CUs)
    t_hbm: float         # device-memory traffic / assigned-channel bw
    t_host: float        # host->device stream / host link bw
    t_overhead: float    # per-dispatch launch/sync cost
    t_serial: float      # no overlap: host + max(compute, hbm) + overhead
    t_pipelined: float   # K-deep overlap: max(host, compute, hbm) + overhead

    @property
    def bottleneck(self) -> str:
        """The dominating term's label (the correction-fit key)."""
        terms = {
            "compute": self.t_compute,
            "hbm": self.t_hbm,
            "host-link": self.t_host,
        }
        return max(terms, key=terms.get)

    @property
    def overlap_speedup(self) -> float:
        """Predicted serial/pipelined ratio for this stage."""
        return self.t_serial / self.t_pipelined if self.t_pipelined else 1.0


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """The complete memory architecture for one operator + target."""

    operator: str               # e.g. "inverse_helmholtz_p11"
    target: MemoryTarget
    policy: str
    backend: str
    batch_elements: int         # E -- elements per dispatched batch
    prefetch_depth: int         # K -- batches staged ahead (0 = serial)
    cu_count: int               # replicated compute units (mesh devices)
    buffers: Tuple[BufferSpec, ...]
    cost: CostBreakdown
    feasible: bool = True
    infeasible_reason: str = ""
    flops_per_element: int = 0
    #: largest element block whose fused-kernel working set fits on-chip
    #: memory (drives the Pallas kernel's ``block_elements``); divides E.
    block_elements: int = 0
    block_working_set_bytes: int = 0
    #: elements added to (or, negative, trimmed from) the auto-sized E so
    #: it is a multiple of the VMEM block (0 when E was given explicitly
    #: or already composite).  Padded tail elements are host-side filler.
    batch_pad_elements: int = 0

    # -- aggregates ---------------------------------------------------------
    @property
    def resident_bytes(self) -> int:
        """Device memory held while the pipeline is in flight."""
        return sum(b.resident_bytes for b in self.buffers)

    @property
    def host_stream_bytes(self) -> int:
        """Host-link bytes moved per batch (in + out streams, padded)."""
        return host_stream_bytes(self.buffers)

    @property
    def hbm_stream_bytes(self) -> int:
        """Device-memory traffic per batch (intermediates cross twice)."""
        return hbm_stream_bytes(self.buffers)

    @property
    def channels_used(self) -> int:
        """Distinct pseudo-channels this plan's buffers map to."""
        return channels_used(self.buffers)

    @property
    def signature(self) -> str:
        """Stable short id of what would execute (operator, backend,
        policy, E, K, CU) -- the profile-store key for single-op runs."""
        import hashlib

        parts = [
            self.operator, self.backend, self.policy,
            str(self.batch_elements), str(self.prefetch_depth),
            str(self.cu_count), str(self.flops_per_element),
        ]
        return hashlib.sha1("|".join(parts).encode()).hexdigest()[:12]

    @property
    def donation(self) -> Tuple[str, ...]:
        """Input buffers safe to donate to XLA (each staged batch is
        consumed exactly once, so its device buffer can be reused for
        outputs).  Only meaningful for the jitted ``xla`` backend."""
        if self.backend != "xla":
            return ()
        return tuple(sorted(b.name for b in self.buffers if b.role == "in"))

    def batches_for(self, n_eq: int) -> int:
        """Batches needed to cover an ``n_eq``-element problem."""
        return max(1, n_eq // self.batch_elements)

    # -- the "Fig. 14" dump -------------------------------------------------
    def report(self) -> str:
        """Human-readable plan dump (the paper's Fig. 14 analog)."""
        t = self.target
        c = self.cost
        mib = 2 ** 20
        lines = [
            f"MemoryPlan {self.operator}  target={t.name}  "
            f"backend={self.backend}  policy={self.policy}",
            f"  E={self.batch_elements} elements/batch   "
            f"prefetch K={self.prefetch_depth}   CUs={self.cu_count}   "
            f"feasible={'yes' if self.feasible else 'NO: ' + self.infeasible_reason}",
            f"  channels: {self.channels_used}/{t.n_channels} used "
            f"({t.channel_bytes // mib} MiB each)   "
            f"resident {self.resident_bytes / mib:.1f} MiB "
            f"of {t.usable_hbm_bytes / mib:.0f} MiB usable",
            f"  host stream {self.host_stream_bytes / mib:.1f} MiB/batch   "
            f"hbm traffic {self.hbm_stream_bytes / mib:.1f} MiB/batch",
        ]
        if self.block_elements:
            lines.append(
                f"  vmem block BE={self.block_elements} elements   "
                f"working set {self.block_working_set_bytes / mib:.2f} MiB "
                f"of {t.vmem_bytes / mib:.0f} MiB VMEM"
            )
        if self.batch_pad_elements:
            lines.append(
                f"  E auto-padded {self.batch_pad_elements:+d} elements "
                f"(from {self.batch_elements - self.batch_pad_elements}) "
                "to keep the VMEM block divisor composite"
            )
        lines += [
            "",
            f"  {'buffer':<14} {'role':<7} {'elem B':>7} {'padded':>7} "
            f"{'batch MiB':>10} {'repl':>5}  channels",
        ]
        for b in self.buffers:
            ch = ",".join(str(i) for i in b.channels[:6])
            if len(b.channels) > 6:
                ch += f",..x{len(b.channels)}"
            lines.append(
                f"  {b.name:<14} {b.role:<7} {b.element_bytes:>7} "
                f"{b.padded_bytes:>7} {b.batch_bytes / mib:>10.2f} "
                f"{b.replicas:>5}  [{ch}]"
            )
        lines += [
            "",
            f"  predicted/batch: compute {c.t_compute * 1e3:.3f} ms   "
            f"hbm {c.t_hbm * 1e3:.3f} ms   host {c.t_host * 1e3:.3f} ms"
            f"   -> {c.bottleneck}-bound",
            f"  serial {c.t_serial * 1e3:.3f} ms/batch   "
            f"pipelined {c.t_pipelined * 1e3:.3f} ms/batch   "
            f"(overlap speedup {c.overlap_speedup:.2f}x)",
        ]
        return "\n".join(lines)
