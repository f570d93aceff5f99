"""Placement: co-scheduling CU replication and stage pipelining over an
explicit device topology.

The paper's generator allocates HBM pseudo-channels and compute units
*jointly*: replicated CUs and the streaming pipeline contend for the
same physical resources, and the tool flow prices that contention before
any hardware is generated.  This module is the execution-substrate half
of that decision for the PyTorch port:

  * :class:`DeviceTopology` -- the machine the chain will actually run
    on (local CUDA devices, or a hypothetical machine for planning).  A
    topology is an ordered list of :class:`DeviceGroupSpec` groups, each
    carrying a device *kind* and (for known kinds) the
    :class:`~repro.memory.channels.MemoryTarget` datasheet that prices
    it -- so one plan can span a mixed CPU/TPU/FPGA fleet and each
    stage is priced against the memory system it actually lands on,
  * :class:`StagePlacement` -- one stage's resource grant: how many CUs
    (mesh devices) it shards elements over, how deep its dispatch ring
    runs, and *which* devices it owns,
  * :class:`PlacementPlan` -- the per-stage vector plus the stage ->
    device-group assignment, with the structural quantity the cost model
    prices: **contention**, the number of pipeline stages whose device
    groups overlap a given stage's group.  Under cross-batch stage
    pipelining every stage is live on a different batch simultaneously,
    so stages sharing a device time-slice it -- replication and overlap
    compete for the same devices (ROADMAP, PR-4 next steps).

Placement is pure data (frozen dataclasses), deterministic, and cheap:
``plan_chain`` derives one per plan, ``dse.explore_chain`` searches the
joint per-stage ``(group, cu_count, prefetch_depth, E_s)`` space over a
fixed topology, and ``cfd.simulation.run_chain`` executes the winning
plan (one dispatch ring per device group, element-sharded intra-stage,
HBM-resident handoffs resharded -- and re-blocked -- between groups).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

from .channels import MemoryTarget, TARGETS, canonical_target_name


class PlacementError(ValueError):
    """Raised on malformed placements (bad groups, topology mismatch)."""


#: Spellings accepted for a device kind (CLI ``--devices cpu:2,tpu:4``,
#: torch device types from ``from_torch``, and the datasheet names
#: themselves).  Unknown kinds stay as-is with no datasheet attached.
KIND_ALIASES = {
    "cpu": "cpu-host",
    "host": "cpu-host",
    "cpu-host": "cpu-host",
    "tpu": "tpu-v5e",
    "tpu-v5e": "tpu-v5e",
    "fpga": "alveo-u280",
    "alveo": "alveo-u280",
    "u280": "alveo-u280",
    "alveo-u280": "alveo-u280",
    "h100": "h100-sxm",
    "h100-sxm": "h100-sxm",
}


def resolve_kind_target(kind: str) -> Optional[MemoryTarget]:
    """The ``channels.py`` datasheet a device kind prices against, or
    None for kinds with no datasheet (``generic``, ``gpu``, ...) --
    those fall back to the plan-wide target."""
    key = KIND_ALIASES.get(canonical_target_name(kind))
    return TARGETS.get(key) if key else None


@dataclasses.dataclass(frozen=True)
class DeviceGroupSpec:
    """One contiguous run of same-kind devices in a topology.

    ``target`` is the memory datasheet stages placed here are priced
    against; ``None`` means "use the plan-wide target" (the homogeneous
    legacy behavior, and the fallback for unknown kinds)."""

    kind: str
    n_devices: int
    target: Optional[MemoryTarget] = None

    def __post_init__(self):
        if self.n_devices < 1:
            raise PlacementError(
                f"device group {self.kind!r} needs >= 1 device, "
                f"got {self.n_devices}"
            )


@dataclasses.dataclass(frozen=True)
class DeviceTopology:
    """The devices a chain executes on, grouped into kind groups.

    ``n_devices`` counts accelerator devices (local CUDA devices here; CU
    sites on the paper's FPGA).  ``groups`` partitions them into
    contiguous same-kind runs; a topology built the legacy way (just
    ``n_devices`` + ``device_kind``) synthesizes a single group, so
    every homogeneous call site keeps working unchanged.  A hypothetical
    topology (for planning a machine you are not on) is just a different
    spec -- placement and pricing never touch the runtime.
    """

    n_devices: int
    device_kind: str = "generic"
    groups: Tuple[DeviceGroupSpec, ...] = ()

    def __post_init__(self):
        if self.n_devices < 1:
            raise PlacementError(
                f"topology needs >= 1 device, got {self.n_devices}"
            )
        if not self.groups:
            object.__setattr__(self, "groups", (
                DeviceGroupSpec(kind=self.device_kind,
                                n_devices=self.n_devices),
            ))
        else:
            total = sum(g.n_devices for g in self.groups)
            if total != self.n_devices:
                raise PlacementError(
                    f"groups sum to {total} devices but topology has "
                    f"{self.n_devices}"
                )
            if self.device_kind == "generic":
                kinds = [g.kind for g in self.groups]
                object.__setattr__(
                    self, "device_kind",
                    kinds[0] if len(set(kinds)) == 1 else "mixed",
                )

    # -- constructors --------------------------------------------------------
    @classmethod
    def detect(cls) -> "DeviceTopology":
        """The local CUDA device pool (import deferred: planning stays
        importable without a runtime)."""
        import torch

        n = torch.cuda.device_count()
        return cls.from_torch([torch.device("cuda", i) for i in range(n)])

    @classmethod
    def from_torch(cls, devs: Sequence) -> "DeviceTopology":
        """Derive the topology from a list of torch devices, *per device*
        -- a mixed pool becomes one group per contiguous same-type run
        (instead of assuming ``devs[0].type`` fleet-wide).  Mixed pools
        resolve each kind's datasheet; interleaved kinds (a kind
        recurring after another kind) are rejected -- the executor
        shards a stage over one contiguous group only."""
        if not devs:
            raise PlacementError("from_torch needs >= 1 device")
        kinds = [str(getattr(d, "type", "generic")) for d in devs]
        runs: List[Tuple[str, int]] = []
        for k in kinds:
            if runs and runs[-1][0] == k:
                runs[-1] = (k, runs[-1][1] + 1)
            else:
                runs.append((k, 1))
        seen = [k for k, _ in runs]
        if len(seen) != len(set(seen)):
            raise PlacementError(
                f"unsupported device mix: kinds interleave ({kinds}); "
                "group same-kind devices contiguously"
            )
        if len(runs) == 1:
            # homogeneous pool: the legacy single group, no datasheet
            # attached (pricing keeps following the plan-wide target)
            return cls(n_devices=len(devs), device_kind=runs[0][0])
        groups = []
        for kind, n in runs:
            target = resolve_kind_target(kind)
            if target is None:
                raise PlacementError(
                    f"unsupported device mix: no memory datasheet for "
                    f"kind {kind!r} (known: "
                    f"{', '.join(sorted(set(KIND_ALIASES.values())))})"
                )
            groups.append(
                DeviceGroupSpec(kind=target.name, n_devices=n,
                                target=target)
            )
        return cls(n_devices=len(devs), groups=tuple(groups))

    @classmethod
    def homogeneous(cls, n_devices: int,
                    device_kind: str = "generic") -> "DeviceTopology":
        """A flat topology of ``n_devices`` identical devices."""
        return cls(n_devices=n_devices, device_kind=device_kind)

    @classmethod
    def heterogeneous(
        cls, specs: Sequence[Tuple[str, int]]
    ) -> "DeviceTopology":
        """A mixed fleet from ``[(kind, n), ...]`` -- kinds resolve to
        their ``channels.py`` datasheets (aliases accepted)."""
        if not specs:
            raise PlacementError("heterogeneous topology needs >= 1 group")
        groups = []
        for kind, n in specs:
            target = resolve_kind_target(kind)
            groups.append(DeviceGroupSpec(
                kind=target.name if target else canonical_target_name(kind),
                n_devices=int(n), target=target,
            ))
        return cls(
            n_devices=sum(g.n_devices for g in groups),
            groups=tuple(groups),
        )

    @classmethod
    def parse(cls, spec: str) -> "DeviceTopology":
        """Topology from a CLI spec: ``"cpu:2,tpu:4"`` (or ``"4"`` for
        four generic devices).  Kind aliases: cpu/host, tpu, fpga/alveo/
        u280, plus the canonical datasheet names."""
        spec = str(spec).strip()
        if not spec:
            raise PlacementError("empty device spec")
        if spec.isdigit():
            return cls.homogeneous(int(spec))
        parts = []
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            kind, sep, n = tok.partition(":")
            if not sep or not n.strip().isdigit() or not kind.strip():
                raise PlacementError(
                    f"bad device spec token {tok!r} in {spec!r} "
                    "(want 'kind:count', e.g. 'cpu:2,tpu:4')"
                )
            parts.append((kind.strip(), int(n.strip())))
        if not parts:
            raise PlacementError(f"empty device spec {spec!r}")
        return cls.heterogeneous(parts)

    # -- group/device views --------------------------------------------------
    @property
    def heterogeneous_kinds(self) -> bool:
        """True when the topology mixes more than one device kind."""
        return len({g.kind for g in self.groups}) > 1

    def spec_string(self) -> str:
        """Canonical spelling for fingerprints and cache keys: the
        legacy ``"<n>x<kind>"`` for a single group, else the full
        ``"kind:n+kind:n"`` hetero spec."""
        if len(self.groups) == 1:
            return f"{self.n_devices}x{self.device_kind}"
        return "+".join(f"{g.kind}:{g.n_devices}" for g in self.groups)

    def group_base(self, gi: int) -> int:
        """First global device id of group ``gi``."""
        return sum(g.n_devices for g in self.groups[:gi])

    def group_device_ids(self, gi: int) -> Tuple[int, ...]:
        """Global device ids belonging to group ``gi``."""
        base = self.group_base(gi)
        return tuple(range(base, base + self.groups[gi].n_devices))

    def group_of_device(self, d: int) -> int:
        """Index of the group owning global device id ``d``."""
        if not 0 <= d < self.n_devices:
            raise PlacementError(
                f"device {d} outside the {self.n_devices}-device topology"
            )
        base = 0
        for gi, g in enumerate(self.groups):
            if d < base + g.n_devices:
                return gi
            base += g.n_devices
        raise PlacementError(f"device {d} not covered by any group")

    def device_target(
        self, d: int, default: Optional[MemoryTarget] = None
    ) -> Optional[MemoryTarget]:
        """The datasheet pricing device ``d`` (``default`` when its
        group carries none)."""
        t = self.groups[self.group_of_device(d)].target
        return t if t is not None else default

    def total_channels(self, default: MemoryTarget) -> int:
        """Pseudo-channels across the whole fleet (the plan report's
        denominator): each group contributes its own datasheet's count,
        target-less groups contribute the plan-wide target's."""
        if len(self.groups) == 1:
            g = self.groups[0]
            return (g.target or default).n_channels
        return sum((g.target or default).n_channels for g in self.groups)


@dataclasses.dataclass(frozen=True)
class StagePlacement:
    """One stage's resource grant on the topology."""

    cu_count: int               # devices the stage shards elements over
    prefetch_depth: int         # dispatch-ring depth (stage 0: host K)
    devices: Tuple[int, ...]    # topology device ids the stage owns

    def __post_init__(self):
        if self.cu_count < 1:
            raise PlacementError(f"cu_count must be >= 1, got {self.cu_count}")
        if self.prefetch_depth < 0:
            raise PlacementError(
                f"prefetch_depth must be >= 0, got {self.prefetch_depth}"
            )
        if len(self.devices) != self.cu_count:
            raise PlacementError(
                f"stage owns {len(self.devices)} devices but cu_count="
                f"{self.cu_count}"
            )
        if len(set(self.devices)) != len(self.devices):
            raise PlacementError(f"duplicate devices in group {self.devices}")


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """Per-stage ``(cu_count, prefetch_depth)`` vector plus the stage ->
    device-group assignment over one topology."""

    topology: DeviceTopology
    stages: Tuple[StagePlacement, ...]

    def __post_init__(self):
        if not self.stages:
            raise PlacementError("placement needs >= 1 stage")
        for i, sp in enumerate(self.stages):
            bad = [d for d in sp.devices if not 0 <= d < self.topology.n_devices]
            if bad:
                raise PlacementError(
                    f"stage {i} placed on devices {bad} outside the "
                    f"{self.topology.n_devices}-device topology"
                )
            if len(self.topology.groups) > 1:
                gis = {self.topology.group_of_device(d) for d in sp.devices}
                if len(gis) > 1:
                    raise PlacementError(
                        f"stage {i} spans kind groups {sorted(gis)}; a "
                        "stage shards within one device kind only"
                    )

    # -- vector views --------------------------------------------------------
    @property
    def n_stages(self) -> int:
        """Number of placed stages."""
        return len(self.stages)

    @property
    def cu_counts(self) -> Tuple[int, ...]:
        """Per-stage CU replication vector."""
        return tuple(sp.cu_count for sp in self.stages)

    @property
    def prefetch_depths(self) -> Tuple[int, ...]:
        """Per-stage dispatch-ring depth vector."""
        return tuple(sp.prefetch_depth for sp in self.stages)

    @property
    def max_cu_count(self) -> int:
        """Widest stage's CU count (the legacy chain-wide scalar)."""
        return max(self.cu_counts)

    @property
    def device_groups(self) -> Tuple[Tuple[int, ...], ...]:
        """Per-stage device-id groups, as placed."""
        return tuple(sp.devices for sp in self.stages)

    @property
    def devices_used(self) -> Tuple[int, ...]:
        """Sorted distinct device ids any stage occupies."""
        used = sorted({d for sp in self.stages for d in sp.devices})
        return tuple(used)

    # -- per-stage kind/target views (heterogeneous pricing) ----------------
    def stage_group_index(self, i: int) -> int:
        """Topology group owning stage ``i``'s devices."""
        return self.topology.group_of_device(self.stages[i].devices[0])

    @property
    def stage_group_indices(self) -> Tuple[int, ...]:
        """Per-stage topology group index."""
        return tuple(
            self.stage_group_index(i) for i in range(len(self.stages))
        )

    def stage_kind(self, i: int) -> str:
        """Device kind stage ``i`` is placed on."""
        return self.topology.groups[self.stage_group_index(i)].kind

    def stage_target(
        self, i: int, default: Optional[MemoryTarget] = None
    ) -> Optional[MemoryTarget]:
        """The datasheet pricing stage ``i`` (``default`` when its
        group carries none -- the homogeneous legacy)."""
        t = self.topology.groups[self.stage_group_index(i)].target
        return t if t is not None else default

    # -- the quantity the cost model prices ---------------------------------
    @property
    def contention(self) -> Tuple[int, ...]:
        """Per stage: how many stages (itself included) own at least one
        of its devices.  Under stage pipelining every stage is live
        simultaneously, so overlapping groups time-slice their shared
        devices; disjoint groups (contention 1) pipeline freely."""
        sets = [set(sp.devices) for sp in self.stages]
        return tuple(
            sum(1 for other in sets if mine & other) for mine in sets
        )

    def disjoint(self) -> bool:
        """True when no two stages share a device (free pipelining)."""
        return all(c == 1 for c in self.contention)

    # -- report --------------------------------------------------------------
    def describe(
        self,
        stage_names: Optional[Sequence[str]] = None,
        stage_elements: Optional[Sequence[int]] = None,
        stage_channels: Optional[Sequence[Sequence[int]]] = None,
        stage_kinds: Optional[Sequence[str]] = None,
    ) -> List[str]:
        """The golden-checked ``placement:`` report lines.

        With per-stage annotations (names, batch elements, channel ids
        from the chain plan) each stage also gets a
        ``kind / E / channels`` line -- the placement-aware channel map
        the heterogeneous planner decides."""
        groups = " | ".join(
            ",".join(str(d) for d in sp.devices) for sp in self.stages
        )
        lines = [
            f"  placement: {self.topology.n_devices} device(s)   "
            f"per-stage cu [{','.join(str(c) for c in self.cu_counts)}]   "
            f"contention [{','.join(str(c) for c in self.contention)}]",
            f"    stage device groups [{groups}]",
        ]
        if stage_names is not None:
            n = len(self.stages)
            es = list(stage_elements or [0] * n)
            chans = list(stage_channels or [()] * n)
            kinds = list(stage_kinds) if stage_kinds else [
                self.stage_kind(i) for i in range(n)
            ]
            for i, name in enumerate(stage_names):
                ch = format_channel_ids(chans[i])
                lines.append(
                    f"    stage {name}: kind={kinds[i]}  "
                    f"E={es[i]}  channels {len(tuple(chans[i]))} {ch}"
                )
        return lines


def format_channel_ids(ids: Sequence[int]) -> str:
    """Compact run-length spelling of a channel id set: ``[0-6,9]``."""
    ids = sorted(set(int(i) for i in ids))
    if not ids:
        return "[]"
    runs: List[Tuple[int, int]] = []
    for i in ids:
        if runs and i == runs[-1][1] + 1:
            runs[-1] = (runs[-1][0], i)
        else:
            runs.append((i, i))
    return "[" + ",".join(
        f"{a}" if a == b else f"{a}-{b}" for a, b in runs
    ) + "]"


def assign_device_groups(
    topology: DeviceTopology,
    cu_counts: Sequence[int],
    stage_groups: Optional[Sequence[int]] = None,
) -> List[Tuple[int, ...]]:
    """Deterministic stage -> device-group assignment.

    Single-group topologies keep the legacy rule exactly: contiguous
    blocks laid out round-robin over the whole pool.  When the stages'
    combined CU demand fits the device pool the groups come out disjoint
    (contention 1 everywhere); otherwise they wrap and overlap, and the
    resulting contention is exactly what :class:`ChainCost` prices.

    Multi-group (heterogeneous) topologies place each stage *within one
    kind group*: ``stage_groups`` names the group per stage (the DSE's
    placement axis); by default each stage goes to the least-loaded
    group (ties: the one with the higher datasheet peak, then the lower
    index), wrapping round-robin inside it."""
    n = topology.n_devices
    if len(topology.groups) == 1:
        groups: List[Tuple[int, ...]] = []
        offset = 0
        for g in cu_counts:
            g = max(1, min(int(g), n))
            groups.append(tuple((offset + k) % n for k in range(g)))
            offset = (offset + g) % n
        return groups

    specs = topology.groups
    if stage_groups is not None:
        if len(stage_groups) != len(cu_counts):
            raise PlacementError(
                f"{len(cu_counts)} cu counts vs {len(stage_groups)} "
                "stage groups"
            )
        chosen = [int(g) for g in stage_groups]
        for g in chosen:
            if not 0 <= g < len(specs):
                raise PlacementError(
                    f"stage group {g} outside the {len(specs)}-group "
                    "topology"
                )
    else:
        chosen = []
        load = [0] * len(specs)
        for cu in cu_counts:
            gi = min(
                range(len(specs)),
                key=lambda j: (
                    load[j] / specs[j].n_devices,
                    -(specs[j].target.peak_flops if specs[j].target else 0.0),
                    j,
                ),
            )
            chosen.append(gi)
            load[gi] += max(1, min(int(cu), specs[gi].n_devices))

    groups = []
    offsets = [0] * len(specs)
    for cu, gi in zip(cu_counts, chosen):
        size = specs[gi].n_devices
        base = topology.group_base(gi)
        g = max(1, min(int(cu), size))
        off = offsets[gi]
        groups.append(tuple(base + (off + k) % size for k in range(g)))
        offsets[gi] = (off + g) % size
    return groups


def place_chain(
    topology: DeviceTopology,
    cu_counts: Union[int, Sequence[int]],
    prefetch_depths: Union[int, Sequence[int]],
    *,
    n_stages: Optional[int] = None,
    stage_groups: Optional[Sequence[int]] = None,
) -> PlacementPlan:
    """Build the PlacementPlan for per-stage CU counts and ring depths.

    Scalars broadcast chain-wide (``n_stages`` then sizes the vector);
    CU counts are clamped to the topology -- the topology *bounds*
    replication, which is the point of making it explicit.  On a
    heterogeneous topology ``stage_groups`` pins each stage to a kind
    group (clamping then bounds CU at that group's size)."""
    if isinstance(cu_counts, int):
        if n_stages is None:
            raise PlacementError("scalar cu_counts needs n_stages")
        cu_counts = [cu_counts] * n_stages
    else:
        cu_counts = list(cu_counts)
    if isinstance(prefetch_depths, int):
        prefetch_depths = [prefetch_depths] * len(cu_counts)
    else:
        prefetch_depths = list(prefetch_depths)
    if len(prefetch_depths) != len(cu_counts):
        raise PlacementError(
            f"{len(cu_counts)} cu counts vs {len(prefetch_depths)} depths"
        )
    groups = assign_device_groups(topology, cu_counts, stage_groups)
    return PlacementPlan(
        topology=topology,
        stages=tuple(
            StagePlacement(
                cu_count=len(g), prefetch_depth=max(0, int(d)), devices=g
            )
            for g, d in zip(groups, prefetch_depths)
        ),
    )
