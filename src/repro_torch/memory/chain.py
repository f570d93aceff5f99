"""Multi-operator program planning: one memory architecture for a whole
CFD pipeline (paper Sec. 5 -- the headline numbers come from composed
applications, not single operators).

A :class:`ProgramChain` is an ordered sequence of compiled programs
(e.g. interpolation -> gradient -> inverse Helmholtz) with *bindings*
that wire a producer stage's output to a consumer stage's input.  The
chain planner then makes the three decisions the single-program planner
cannot:

  * **inter-stage residency** -- a bound producer->consumer stream never
    crosses the host link: it is written to HBM once by the producer and
    read once by the consumer (buffer role ``resident``).  Only the
    chain's fringe (unbound inputs, unconsumed outputs) is host-streamed.
  * **co-sized E** -- one batch size is chosen so that *every* stage's
    per-batch stream I/O fits one pseudo-channel (the paper's rule,
    applied to the worst stage), so a batch flows through the whole
    pipeline without re-blocking.
  * **conflict-free placement** -- all stages' buffers share one
    round-robin :class:`~repro.memory.layout.ChannelAllocator`; shared
    (batch-invariant) operands with the same name are placed once.

The result is a :class:`ChainPlan`: per-stage buffers/costs plus chain
aggregates, rendered by ``report()`` like the single-program plan.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..core import ir
from ..core.emit import CompiledProgram
from ..core.precision import get_policy
from ..core.schedule import Schedule, schedule as make_schedule
from . import layout
from .channels import MemoryTarget, detect_target
from .placement import DeviceTopology, PlacementPlan, place_chain
from .plan import (BufferSpec, CostBreakdown, channels_used,
                   hbm_stream_bytes, host_stream_bytes)


@dataclasses.dataclass
class ChainStage:
    """One pipeline stage: a compiled program plus input bindings.

    ``bindings`` maps this stage's input names to a *qualified* earlier
    output, ``"<stage>.<output>"``.  Inputs left unbound are either
    host-streamed (element vars) or shared operands (matched chain-wide
    by bare name).
    """

    name: str
    compiled: CompiledProgram
    bindings: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def program(self) -> ir.Program:
        """The stage's standalone IR program."""
        return self.compiled.program

    @property
    def backend(self) -> str:
        """The backend the stage compiled to (xla/staged/pallas)."""
        return self.compiled.backend


StageLike = Union[ChainStage, Tuple[str, CompiledProgram],
                  Tuple[str, CompiledProgram, Dict[str, str]]]


class ChainError(ValueError):
    """Raised on malformed chains (bad bindings, shape mismatches)."""


class ProgramChain:
    """An ordered multi-operator program with producer->consumer wiring.

    Stages may be :class:`ChainStage` objects or ``(name, compiled)`` /
    ``(name, compiled, bindings)`` tuples.  Unqualified input names that
    match an earlier stage's output name are auto-bound to the most
    recent such producer.
    """

    def __init__(self, stages: Sequence[StageLike]):
        self.stages: List[ChainStage] = []
        for s in stages:
            if isinstance(s, ChainStage):
                self.stages.append(s)
            else:
                name, compiled = s[0], s[1]
                bindings = dict(s[2]) if len(s) > 2 else {}
                self.stages.append(ChainStage(name, compiled, bindings))
        if not self.stages:
            raise ChainError("empty chain")
        self._validate_names()
        #: per stage: input name -> (producer stage index, output name)
        self.resolved: List[Dict[str, Tuple[int, str]]] = (
            self._resolve_bindings()
        )
        #: (stage index, output name) consumed by a later stage
        self.consumed: set = {
            src for binds in self.resolved for src in binds.values()
        }
        self._validate_shared()

    # -- construction helpers ------------------------------------------------
    def _validate_names(self) -> None:
        seen = set()
        for s in self.stages:
            if not s.name or "." in s.name:
                raise ChainError(f"bad stage name {s.name!r}")
            if s.name in seen:
                raise ChainError(f"duplicate stage name {s.name!r}")
            seen.add(s.name)

    def _resolve_bindings(self) -> List[Dict[str, Tuple[int, str]]]:
        idx_of = {s.name: i for i, s in enumerate(self.stages)}
        resolved: List[Dict[str, Tuple[int, str]]] = []
        for i, s in enumerate(self.stages):
            elem = set(s.program.element_vars)
            binds: Dict[str, Tuple[int, str]] = {}
            for in_name, src in s.bindings.items():
                if in_name not in s.program.inputs:
                    raise ChainError(
                        f"{s.name}: binding for unknown input {in_name!r}"
                    )
                if "." not in src:
                    raise ChainError(
                        f"{s.name}.{in_name}: binding {src!r} must be "
                        "qualified '<stage>.<output>'"
                    )
                p_name, out_name = src.split(".", 1)
                if p_name not in idx_of or idx_of[p_name] >= i:
                    raise ChainError(
                        f"{s.name}.{in_name}: producer {p_name!r} is not "
                        "an earlier stage"
                    )
                p = idx_of[p_name]
                if out_name not in self.stages[p].program.outputs:
                    raise ChainError(
                        f"{s.name}.{in_name}: {p_name!r} has no output "
                        f"{out_name!r}"
                    )
                binds[in_name] = (p, out_name)
            # auto-bind: unbound element inputs matching an earlier
            # stage's output name (most recent producer wins)
            for in_name in s.program.inputs:
                if in_name in binds or in_name not in elem:
                    continue
                for p in range(i - 1, -1, -1):
                    if in_name in self.stages[p].program.outputs:
                        binds[in_name] = (p, in_name)
                        break
            # validate shapes + element-var discipline
            for in_name, (p, out_name) in binds.items():
                src_node = self.stages[p].program.outputs[out_name]
                dst_node = s.program.inputs[in_name]
                if src_node.shape != dst_node.shape:
                    raise ChainError(
                        f"{s.name}.{in_name}: shape {dst_node.shape} != "
                        f"{self.stages[p].name}.{out_name} "
                        f"{src_node.shape}"
                    )
                if (in_name not in elem
                        or out_name not in
                        self.stages[p].program.element_vars):
                    raise ChainError(
                        f"{s.name}.{in_name}: chain streams must be "
                        "element vars on both sides"
                    )
            resolved.append(binds)
        return resolved

    def _validate_shared(self) -> None:
        shapes: Dict[str, Tuple[int, ...]] = {}
        for name, node in self.shared_operands().items():
            shapes[name] = node.shape
        for i, s in enumerate(self.stages):
            elem = set(s.program.element_vars)
            for name, node in s.program.inputs.items():
                if name in elem or name in self.resolved[i]:
                    continue
                if node.shape != shapes[name]:
                    raise ChainError(
                        f"shared operand {name!r}: conflicting shapes "
                        f"{shapes[name]} vs {node.shape}"
                    )

    # -- structure queries ---------------------------------------------------
    @property
    def name(self) -> str:
        """Chain id: stage names joined in execution order."""
        return "->".join(s.name for s in self.stages)

    def host_element_inputs(self, i: int) -> List[Tuple[str, ir.Node]]:
        """Stage i's element inputs streamed from the host (unbound)."""
        s = self.stages[i]
        elem = set(s.program.element_vars)
        return [
            (n, v) for n, v in s.program.inputs.items()
            if n in elem and n not in self.resolved[i]
        ]

    def resident_outputs(self, i: int) -> List[Tuple[str, ir.Node]]:
        """Stage i's outputs consumed by a later stage (HBM-resident)."""
        return [
            (n, v) for n, v in self.stages[i].program.outputs.items()
            if (i, n) in self.consumed
        ]

    def chain_outputs(self, i: int) -> List[Tuple[str, ir.Node]]:
        """Stage i's outputs streamed back to the host (unconsumed)."""
        return [
            (n, v) for n, v in self.stages[i].program.outputs.items()
            if (i, n) not in self.consumed
        ]

    def shared_operands(self) -> Dict[str, ir.Node]:
        """Batch-invariant operands, deduplicated chain-wide by name
        (same name => one resident buffer, one host array)."""
        shared: Dict[str, ir.Node] = {}
        for i, s in enumerate(self.stages):
            elem = set(s.program.element_vars)
            for name, node in s.program.inputs.items():
                if name in elem or name in self.resolved[i]:
                    continue
                shared.setdefault(name, node)
        return shared

    def stage_stream_bytes_per_element(
        self, i: int, bytes_per_scalar: int
    ) -> int:
        """Per-element bytes stage i moves through HBM per batch (host
        streams + resident reads/writes) -- the quantity the paper's
        channel rule divides a pseudo-channel by."""
        total = sum(
            v.size for _, v in self.host_element_inputs(i)
        ) + sum(v.size for _, v in self.chain_outputs(i))
        total += sum(v.size for _, v in self.resident_outputs(i))
        for in_name, (p, out_name) in self.resolved[i].items():
            total += self.stages[p].program.outputs[out_name].size
        return total * bytes_per_scalar

    def auto_batch_elements(
        self,
        target: MemoryTarget,
        *,
        bytes_per_scalar: int,
        channel_bytes: Optional[int] = None,
        n_eq: Optional[int] = None,
    ) -> int:
        """Co-sized E: the largest batch whose stream I/O fits one
        pseudo-channel for *every* stage (min over stages)."""
        cb = channel_bytes if channel_bytes is not None else target.channel_bytes
        e = None
        for i in range(len(self.stages)):
            per = self.stage_stream_bytes_per_element(i, bytes_per_scalar)
            ei = max(1, cb // per) if per else cb
            e = ei if e is None else min(e, ei)
        if n_eq is not None:
            e = min(e, max(1, n_eq))
        return int(max(1, e))


# ---------------------------------------------------------------------------
# the chain plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """One stage's slice of the chain plan (buffers it introduces)."""

    name: str
    backend: str
    prefetch_depth: int
    flops_per_element: int
    buffers: Tuple[BufferSpec, ...]
    cost: CostBreakdown
    block_elements: int = 0
    block_working_set_bytes: int = 0
    #: CUs (mesh devices) the stage shards its element batch over, and
    #: the topology device ids it owns (from the plan's placement).
    cu_count: int = 1
    devices: Tuple[int, ...] = (0,)
    #: the stage's own batch size E_s (0 = the chain-wide E).  On a
    #: heterogeneous topology each stage runs at the E natural to *its*
    #: memory system; E_s always divides the chain E, and the executor
    #: re-blocks (slice/concat) at handoffs where it changes.
    batch_elements: int = 0
    #: device kind the stage is placed on ("" = the plan target's).
    kind: str = ""


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """How the chain executor overlaps stages *across batches*.

    ``mode == "pipelined"`` runs one dispatch ring per stage: stage i of
    batch k is dispatched in the same tick as stage i+1 of batch k-1
    (``memory.pipeline.run_stage_pipelined``), with the HBM-resident
    inter-stage streams handed off on device.  ``mode == "serial"`` is
    the paper's baseline: stages back-to-back per batch (host prefetch
    only), kept for bitwise-equality tests and as the ladder's rung.
    """

    mode: str                       # "pipelined" | "serial"
    stage_depths: Tuple[int, ...]   # dispatch-ring depth per stage
    stage_skews: Tuple[int, ...]    # batches stage i lags behind stage 0
    fill_batches: int               # pipeline fill (= drain) in batches

    @property
    def pipelined(self) -> bool:
        """True when any stage runs batches ahead (cross-batch mode)."""
        return self.mode == "pipelined"


def derive_pipeline(depths: Sequence[int]) -> PipelineSpec:
    """The execution mode a per-stage depth vector implies: any positive
    inter-stage ring depth turns cross-batch stage pipelining on."""
    from . import pipeline as pipe_mod

    skews = pipe_mod.stage_skews(depths)
    pipelined = len(depths) > 1 and any(d > 0 for d in depths[1:])
    return PipelineSpec(
        mode="pipelined" if pipelined else "serial",
        stage_depths=tuple(depths),
        stage_skews=tuple(skews),
        fill_batches=skews[-1],
    )


@dataclasses.dataclass(frozen=True)
class ChainCost:
    """Per-batch chain timing.

    ``pipelined_stages=False`` prices the back-to-back schedule (stages
    sequential per batch, each with its own transfer overlap);
    ``pipelined_stages=True`` prices cross-batch stage pipelining: the
    steady-state batch rate is set by the *slowest* stage alone, and the
    first batch's full chain latency (fill + drain) is amortized over
    ``n_batches``.  ``contention`` (from the plan's
    :class:`~repro.memory.placement.PlacementPlan`) is the number of
    stages sharing each stage's device group: under stage pipelining all
    stages are live on different batches simultaneously, so a stage's
    device-side terms (compute, HBM) are time-sliced ``contention``-fold
    -- this is how replication and overlap competing for the same
    devices is priced *before* execution.  When measured per-stage
    samples exist in a profile store, :func:`fit_contention` replaces
    the structural count with the multiplier the measurements imply
    (``contention_fit``) -- the same slot, learned instead of assumed.
    """

    stages: Tuple[CostBreakdown, ...]
    #: cross-batch mode: per-stage dispatch rings overlap stage i of
    #: batch k with stage i+1 of batch k-1
    pipelined_stages: bool = False
    #: pipeline fill in batches (the last stage's skew); reporting only
    fill_batches: int = 0
    n_batches: Optional[int] = None
    #: per-stage device-sharing multiplier (empty = disjoint groups)
    contention: Tuple[int, ...] = ()
    #: per-stage contention *measured* on this machine, fitted from
    #: profile-store stage samples by :func:`fit_contention` (0.0 =
    #: no device-bound evidence for that stage; fall back to the
    #: structural ``contention`` count).  Empty = no profile consulted.
    contention_fit: Tuple[float, ...] = ()
    #: per-stage re-block handoff cost (seconds per chain batch) billed
    #: to the *consumer*: when adjacent stages run at different E_s --
    #: or on different device kinds -- the handoff's bytes move through
    #: the slower side's link before the consumer can start.  Empty =
    #: no handoff re-blocks (the homogeneous shared-E legacy).
    t_reblock: Tuple[float, ...] = ()

    def _contention(self, i: int) -> float:
        if self.contention_fit and self.contention_fit[i] > 0.0:
            return self.contention_fit[i]
        return float(self.contention[i]) if self.contention else 1.0

    def _reblock(self, i: int) -> float:
        return self.t_reblock[i] if self.t_reblock else 0.0

    @property
    def t_reblock_total(self) -> float:
        """Chain-wide re-block seconds per batch (0 when E is shared)."""
        return sum(self.t_reblock) if self.t_reblock else 0.0

    @property
    def t_serial(self) -> float:
        """Fully serial chain time per batch (no overlap anywhere)."""
        return sum(c.t_serial for c in self.stages) + self.t_reblock_total

    @property
    def t_back_to_back(self) -> float:
        """Stages sequential per batch, per-stage transfer overlap."""
        return (
            sum(c.t_pipelined for c in self.stages) + self.t_reblock_total
        )

    @property
    def stage_steady_times(self) -> Tuple[float, ...]:
        """Per-stage steady-state time under stage pipelining: the
        stage's roofline with its device terms scaled by how many
        pipeline stages time-slice its devices, plus the re-block cost
        of its incoming handoffs (paid every batch before the stage can
        run).  The host link is billed uncontended -- it is shared
        chain-wide in every schedule."""
        out = []
        for i, c in enumerate(self.stages):
            k = self._contention(i) if self.pipelined_stages else 1
            out.append(
                max(c.t_host, k * max(c.t_compute, c.t_hbm))
                + c.t_overhead + self._reblock(i)
            )
        return tuple(out)

    @property
    def t_steady(self) -> float:
        """Steady-state batch rate under stage pipelining: the slowest
        *contended* stage -- every other stage hides behind it."""
        return max(self.stage_steady_times)

    @property
    def t_fill(self) -> float:
        """Amortized fill+drain cost per batch: the first batch pays the
        full back-to-back chain latency before steady state, spread over
        the run (0 when the batch count is unknown -- steady state)."""
        if not self.n_batches:
            return 0.0
        return (self.t_back_to_back - self.t_steady) / self.n_batches

    @property
    def t_overlapped(self) -> float:
        """Cross-batch pipelined time per batch: never worse than
        back-to-back (n_batches=1 degenerates to it exactly)."""
        return min(self.t_back_to_back, self.t_steady + self.t_fill)

    @property
    def t_pipelined(self) -> float:
        """Effective predicted time per batch under the plan's mode."""
        return (
            self.t_overlapped if self.pipelined_stages
            else self.t_back_to_back
        )

    @property
    def bottleneck_stage(self) -> int:
        """Index of the stage dominating the pipelined chain time."""
        times = (
            self.stage_steady_times if self.pipelined_stages
            else [c.t_pipelined for c in self.stages]
        )
        return list(times).index(max(times))

    @property
    def bottleneck(self) -> str:
        """The dominating stage's dominating cost term (the label the
        measured-feedback CostCorrection attributes ratios to)."""
        return self.stages[self.bottleneck_stage].bottleneck

    @property
    def overlap_speedup(self) -> float:
        """Predicted speedup of the plan's mode over fully serial."""
        return self.t_serial / self.t_pipelined if self.t_pipelined else 1.0

    @property
    def stage_overlap_speedup(self) -> float:
        """What cross-batch stage pipelining alone buys over the
        back-to-back schedule."""
        return (
            self.t_back_to_back / self.t_overlapped
            if self.t_overlapped else 1.0
        )


def fit_contention(
    cost: ChainCost,
    stage_names: Sequence[str],
    samples: Sequence[Dict[str, float]],
) -> Tuple[float, ...]:
    """Per-stage contention multipliers fitted from measured samples.

    The steady-state model prices stage i as
    ``max(t_host, k * max(t_compute, t_hbm)) + t_overhead`` with ``k``
    the *structural* device-sharing count from the placement.  Each
    profile-store sample with ``scope == "stage:<name>"`` carries that
    stage's measured per-batch time, so the model inverts directly:
    ``k_est = (measured - t_overhead) / max(t_compute, t_hbm)``.  Only
    samples with device-bound evidence count -- when
    ``measured - t_overhead <= t_host`` the host link hides the device
    terms and the measurement says nothing about ``k``.  A sample with
    ``clock == "device"`` was timed by the card's own events around the
    stage's work (the pipeline driver on a CUDA device): it holds
    neither the host link, which runs on another stream, nor the host's
    dispatch overhead, so it is device evidence as it stands,
    ``k_est = measured / max(t_compute, t_hbm)``.  Per stage the
    estimates combine by geometric mean (ratios), clamped to >= 1.0
    (devices cannot be less than uncontended).  Stages without usable
    samples get 0.0, meaning "keep the structural count".  Returns ()
    when no stage could be fitted, so callers can skip the replace.
    """
    n = len(cost.stages)
    if len(stage_names) != n:
        raise ValueError(
            f"cost has {n} stages, got {len(stage_names)} names"
        )
    by_stage: Dict[str, List[float]] = {}
    for s in samples:
        scope = s.get("scope", "")
        m = s.get("measured_s")
        if not isinstance(scope, str) or not scope.startswith("stage:"):
            continue
        if not isinstance(m, (int, float)) or m <= 0:
            continue
        by_stage.setdefault(scope[len("stage:"):], []).append(
            (float(m), s.get("clock") == "device"))

    fit: List[float] = []
    for i, nm in enumerate(stage_names):
        c = cost.stages[i]
        dev = max(c.t_compute, c.t_hbm)
        ks: List[float] = []
        if dev > 0:
            for m, device_clock in by_stage.get(nm, ()):
                if device_clock:
                    ks.append(m / dev)
                    continue
                dev_part = m - c.t_overhead
                if dev_part <= c.t_host:
                    continue        # host-bound sample: no evidence on k
                ks.append(dev_part / dev)
        if ks:
            k = math.exp(sum(math.log(x) for x in ks) / len(ks))
            fit.append(max(1.0, k))
        else:
            fit.append(0.0)
    return tuple(fit) if any(k > 0.0 for k in fit) else ()


def apply_profile_contention(plan: "ChainPlan", profile) -> "ChainPlan":
    """Re-price a plan's steady-state times from measured contention.

    ``profile`` is anything :meth:`repro_torch.trace.ProfileStore.open`
    accepts (a store, a path, ``True`` for the default location).  Pulls
    the store's current-epoch stage samples for the plan's signature
    (target-wide fallback) and swaps the fitted multipliers into the
    plan's :class:`ChainCost`.  A cold store -- or one with only
    host-bound / chain-level samples -- returns the plan unchanged.
    """
    from ..trace.profile import ProfileStore  # lazy: no import cycle

    store = ProfileStore.open(profile)
    if store is None:
        return plan
    samples = store.samples(plan.target.name, plan.signature)
    fit = fit_contention(
        plan.cost, [sp.name for sp in plan.stages], samples
    )
    if not fit:
        return plan
    return dataclasses.replace(
        plan, cost=dataclasses.replace(plan.cost, contention_fit=fit)
    )


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """The complete memory architecture for a multi-operator program."""

    chain: str                  # e.g. "interp->grad->helmholtz"
    target: MemoryTarget
    policy: str
    batch_elements: int         # shared E, co-sized over all stages
    #: per-stage (cu_count, prefetch_depth) + stage -> device-group
    #: assignment over the explicit topology the plan was made for
    placement: PlacementPlan
    stages: Tuple[StagePlan, ...]
    cost: ChainCost
    feasible: bool = True
    infeasible_reason: str = ""
    #: elements added to (negative: trimmed from) the auto-sized E so it
    #: is a multiple of every stage's VMEM block (0 for explicit E).
    batch_pad_elements: int = 0
    #: cross-batch stage pipelining spec the executor runs off (derived
    #: from the per-stage prefetch depths; None only on legacy plans).
    pipeline: Optional[PipelineSpec] = None
    #: what the cost-driven fusion pass decided (None when planning ran
    #: with fusion off); ``fusion.chain`` holds the fused chain.
    fusion: Optional["FusionSpec"] = None
    #: per-stage batch size E_s (empty = every stage runs the chain E).
    #: Each E_s divides the chain E and shards evenly on its stage's CU
    #: group; the executor re-blocks at handoffs where E_s changes.
    stage_batch_elements: Tuple[int, ...] = ()

    def stage_e(self, i: int) -> int:
        """Stage ``i``'s effective batch size (the chain E unless a
        per-stage vector was planned)."""
        if self.stage_batch_elements:
            return self.stage_batch_elements[i]
        return self.batch_elements

    @property
    def uniform_batch(self) -> bool:
        """True when every stage runs the chain-wide E (no re-blocking
        handoffs; the executor may use the single-mesh fast path)."""
        return all(
            es == self.batch_elements for es in self.stage_batch_elements
        )

    @property
    def cu_count(self) -> int:
        """Devices the plan needs locally: the widest stage group (the
        historical chain-wide scalar, now derived from the placement)."""
        return self.placement.max_cu_count

    @property
    def cu_counts(self) -> Tuple[int, ...]:
        """Per-stage CU replication, from the placement."""
        return self.placement.cu_counts

    @property
    def buffers(self) -> Tuple[BufferSpec, ...]:
        """Every stage's buffers, flattened in chain order."""
        return tuple(b for s in self.stages for b in s.buffers)

    @property
    def resident_bytes(self) -> int:
        """Total HBM bytes held resident across the chain."""
        return sum(b.resident_bytes for b in self.buffers)

    @property
    def host_stream_bytes(self) -> int:
        """Host-link bytes per batch across the whole chain -- the number
        the paper's residency optimization shrinks."""
        return host_stream_bytes(self.buffers)

    @property
    def hbm_stream_bytes(self) -> int:
        """Device-memory bytes streamed per batch, chain-wide."""
        return hbm_stream_bytes(self.buffers)

    @property
    def channels_used(self) -> int:
        """Distinct pseudo-channels the chain's buffers map to."""
        return channels_used(self.buffers)

    @property
    def resident_stream_bytes(self) -> int:
        """Per-batch bytes kept on-device between stages (the traffic a
        stage-by-stage host round-trip would have added to the link)."""
        return sum(
            b.batch_bytes for b in self.buffers if b.role == "resident"
        )

    def batches_for(self, n_eq: int) -> int:
        """Batches needed to cover an ``n_eq``-element problem."""
        return max(1, n_eq // self.batch_elements)

    @property
    def signature(self) -> str:
        """Stable short id of *what would execute*: stage names/backends/
        flops, per-stage (K, CU), policy and E -- the profile-store key
        that groups measured runs of equivalent plans across processes."""
        import hashlib

        parts = [self.chain, self.policy, str(self.batch_elements)]
        parts += [
            f"{sp.name}:{sp.backend}:{sp.flops_per_element}:"
            f"{sp.prefetch_depth}:{sp.cu_count}"
            for sp in self.stages
        ]
        # heterogeneous extensions only when they change what executes,
        # so every homogeneous shared-E plan keeps its historical
        # signature (and its accumulated profile-store samples)
        if not self.uniform_batch:
            parts.append(
                "E:" + ",".join(
                    str(es) for es in self.stage_batch_elements
                )
            )
        if len(self.placement.topology.groups) > 1:
            parts.append(self.placement.topology.spec_string())
            parts.append(
                "G:" + ",".join(
                    str(g) for g in self.placement.stage_group_indices
                )
            )
        return hashlib.sha1("|".join(parts).encode()).hexdigest()[:12]

    def report(self) -> str:
        """Human-readable plan description: stages, buffers per
        channel, the cost prediction, and the fusion decision."""
        t = self.target
        mib = 2 ** 20
        lines = [
            f"ChainPlan {self.chain}  target={t.name}  policy={self.policy}",
            f"  E={self.batch_elements} elements/batch (co-sized)   "
            f"CUs=[{','.join(str(c) for c in self.cu_counts)}]   "
            f"feasible={'yes' if self.feasible else 'NO: ' + self.infeasible_reason}",
            f"  channels: {self.channels_used}/"
            f"{self.placement.topology.total_channels(t)} used   "
            f"resident {self.resident_bytes / mib:.1f} MiB "
            f"of {t.usable_hbm_bytes / mib:.0f} MiB usable",
            f"  host stream {self.host_stream_bytes / mib:.1f} MiB/batch   "
            f"inter-stage resident {self.resident_stream_bytes / mib:.1f} "
            f"MiB/batch   hbm traffic "
            f"{self.hbm_stream_bytes / mib:.1f} MiB/batch",
        ]
        if self.batch_pad_elements:
            lines.append(
                f"  E auto-padded {self.batch_pad_elements:+d} elements "
                f"(from {self.batch_elements - self.batch_pad_elements}) "
                "to keep every stage's VMEM block divisor composite"
            )
        for sp in self.stages:
            c = sp.cost
            lines += [
                "",
                f"  stage {sp.name}  backend={sp.backend}  "
                f"K={sp.prefetch_depth}  CU={sp.cu_count}  "
                f"BE={sp.block_elements} "
                f"(vmem ws {sp.block_working_set_bytes / mib:.2f} MiB)",
                f"    {'buffer':<20} {'role':<9} {'elem B':>7} "
                f"{'padded':>7} {'batch MiB':>10} {'repl':>5}  channels",
            ]
            for b in sp.buffers:
                ch = ",".join(str(i) for i in b.channels[:6])
                if len(b.channels) > 6:
                    ch += f",..x{len(b.channels)}"
                lines.append(
                    f"    {b.name:<20} {b.role:<9} {b.element_bytes:>7} "
                    f"{b.padded_bytes:>7} {b.batch_bytes / mib:>10.2f} "
                    f"{b.replicas:>5}  [{ch}]"
                )
            lines.append(
                f"    predicted/batch: compute {c.t_compute * 1e3:.3f} ms  "
                f"hbm {c.t_hbm * 1e3:.3f} ms  host {c.t_host * 1e3:.3f} ms"
                f"  -> {c.bottleneck}-bound"
            )
        cc = self.cost
        lines.append("")
        lines += self.placement.describe(
            stage_names=[sp.name for sp in self.stages],
            stage_elements=[
                self.stage_e(i) for i in range(len(self.stages))
            ],
            stage_channels=[
                sorted({c for b in sp.buffers for c in b.channels})
                for sp in self.stages
            ],
            stage_kinds=[sp.kind or t.name for sp in self.stages],
        )
        if cc.t_reblock and any(r > 0 for r in cc.t_reblock):
            vec = ",".join(f"{r * 1e3:.3f}" for r in cc.t_reblock)
            lines.append(
                f"  re-block handoffs: [{vec}] ms/batch per consumer "
                "stage (E or kind changes across the boundary)"
            )
        if cc.contention_fit:
            vec = ",".join(
                f"{k:.2f}" if k > 0.0 else "-" for k in cc.contention_fit
            )
            lines.append(
                f"  contention fitted from profile: [{vec}]   "
                "(- = no device-bound samples; structural count kept)"
            )
        if self.pipeline is not None:
            pp = self.pipeline
            lines.append(
                f"  pipeline: mode={pp.mode}   stage depths "
                f"[{','.join(str(d) for d in pp.stage_depths)}]   skews "
                f"[{','.join(str(s) for s in pp.stage_skews)}]   "
                f"fill/drain {pp.fill_batches} batches"
            )
            if pp.pipelined:
                lines.append(
                    f"    steady {cc.t_steady * 1e3:.3f} ms/batch + fill "
                    f"{cc.t_fill * 1e3:.3f} ms/batch amortized   "
                    f"(predicted stage-overlap speedup "
                    f"{cc.stage_overlap_speedup:.2f}x over back-to-back "
                    f"{cc.t_back_to_back * 1e3:.3f} ms/batch)"
                )
        if self.fusion is not None:
            lines.append("  " + self.fusion.describe())
        lines.append(
            f"  chain serial {cc.t_serial * 1e3:.3f} ms/batch   "
            f"pipelined {cc.t_pipelined * 1e3:.3f} ms/batch   "
            f"(overlap speedup {cc.overlap_speedup:.2f}x, bottleneck "
            f"stage {self.stages[cc.bottleneck_stage].name})"
        )
        return "\n".join(lines)


def snap_stage_elements(e: int, requested: int, cu: int) -> int:
    """Snap a stage's requested E_s to the largest value that divides
    the chain batch ``e``, shards evenly over ``cu`` devices, and does
    not exceed the request.  Falls back to ``cu`` (the smallest legal
    sub-batch) and finally to ``e`` itself -- so when ``cu`` divides
    ``e`` a legal E_s always exists."""
    e, cu = max(1, int(e)), max(1, int(cu))
    req = max(1, min(int(requested), e))
    best = 0
    d = 1
    while d * d <= e:
        if e % d == 0:
            for cand in (d, e // d):
                if cand <= req and cand % cu == 0:
                    best = max(best, cand)
        d += 1
    if best:
        return best
    return cu if e % cu == 0 else e


def _scale_cost(cost: CostBreakdown, m: int) -> CostBreakdown:
    """A stage running ``m`` sub-batches per chain batch pays every cost
    term ``m`` times (including dispatch overhead -- sub-batching is not
    free, which is exactly the tension the per-stage-E search prices)."""
    if m <= 1:
        return cost
    return dataclasses.replace(
        cost,
        t_compute=cost.t_compute * m, t_hbm=cost.t_hbm * m,
        t_host=cost.t_host * m, t_overhead=cost.t_overhead * m,
        t_serial=cost.t_serial * m, t_pipelined=cost.t_pipelined * m,
    )


def plan_chain(
    chain: ProgramChain,
    *,
    target: Optional[MemoryTarget] = None,
    policy: str = "float32",
    backends: Optional[Sequence[str]] = None,
    batch_elements: Optional[int] = None,
    prefetch_depth: Union[int, Sequence[int]] = 1,
    cu_count: Union[int, Sequence[int]] = 1,
    topology: Optional[DeviceTopology] = None,
    placement: Optional[PlacementPlan] = None,
    stage_groups: Optional[Sequence[int]] = None,
    stage_batch_elements: Optional[Sequence[int]] = None,
    n_eq: Optional[int] = None,
    channel_bytes: Optional[int] = None,
    profile=None,
    fuse: Optional[str] = None,
    max_stages: Optional[int] = None,
    fuse_barriers: Sequence[str] = (),
    _sched_cache: Optional[Dict[Tuple[int, int], Schedule]] = None,
) -> ChainPlan:
    """Plan one memory architecture for a whole ProgramChain.

    ``fuse='auto'`` makes the stage count itself a design axis: the
    cost-driven fusion pass (:mod:`repro_torch.memory.fusion`) greedily
    merges adjacent stages whenever the device-resident handoff between
    them costs more than the fused stage's combined roofline, then plans
    the fused chain (the returned plan carries the decision as
    ``plan.fusion``).  ``max_stages`` forces least-harm merges down to a
    stage budget (``max_stages=1`` fully fuses) and implies fusion unless
    ``fuse='off'``; ``fuse_barriers`` names stages whose downstream
    boundary must survive (the flow's explicit named cuts).
    ``profile`` (a :class:`~repro_torch.trace.ProfileStore`, a path, or
    ``True`` for the default store) re-prices the plan's per-stage
    contention from this machine's measured stage samples
    (:func:`apply_profile_contention`).

    ``backends`` overrides each stage's backend for planning (the DSE
    sweeps hypothetical per-stage backends this way); ``prefetch_depth``
    and ``cu_count`` may be one value for the whole chain or one per
    stage -- stage 0's K stages host batches ahead, stage i>0's K is its
    dispatch-ring depth behind stage i-1, and any positive inter-stage
    depth turns on cross-batch stage pipelining (the plan's ``pipeline``
    spec, priced by ``ChainCost.t_overlapped``: makespan set by the
    slowest *contended* stage plus amortized fill/drain instead of the
    per-batch stage sum).  The per-stage CU counts and ring depths are
    co-scheduled over an explicit :class:`DeviceTopology` (default: just
    enough devices for the widest stage, so element sharding and the
    pipeline's dispatch rings visibly compete for them); pass a larger
    ``topology`` -- or a full ``placement`` -- to plan disjoint device
    groups.  Deterministic: same arguments, same plan.
    ``_sched_cache`` (keyed by stage index and scalar width) lets sweeps
    reuse staged-backend schedules across design points instead of
    re-partitioning per candidate.

    On a heterogeneous topology (``DeviceTopology.parse("cpu:2,tpu:4")``
    or ``from_torch`` over a mixed pool) every stage is priced against the
    datasheet of the kind group it lands on: ``stage_groups`` pins
    stages to groups (default: least-loaded), buffers draw channel ids
    from the owning group's pseudo-channels, and ``stage_batch_elements``
    gives each stage its own E_s (snapped to divide the chain E and
    shard on its group).  Handoffs whose E_s -- or device kind --
    changes are priced as an explicit re-block term billed to the
    consumer (bytes through the slower side's link).
    """
    # local import: dse depends on this module for chain exploration
    from .dse import predict_cost

    if fuse not in (None, "off", "auto"):
        raise ValueError(f"unknown fuse mode {fuse!r}; use 'auto' or 'off'")
    if fuse != "off" and (
        fuse == "auto"
        or (max_stages is not None and max_stages < len(chain.stages))
    ):
        from .fusion import fuse_chain_auto  # lazy: fusion imports chain

        if placement is not None:
            raise ValueError(
                "an explicit placement is per-stage and cannot survive "
                "fusion; pass a topology instead"
            )
        if stage_groups is not None or stage_batch_elements is not None:
            raise ValueError(
                "per-stage groups/batch sizes cannot survive fusion; "
                "plan the fused chain first, then pin stages"
            )
        return fuse_chain_auto(
            chain,
            mode="auto",
            max_stages=max_stages,
            barriers=tuple(fuse_barriers),
            target=target,
            policy=policy,
            backends=backends,
            batch_elements=batch_elements,
            prefetch_depth=prefetch_depth,
            cu_count=cu_count,
            topology=topology,
            n_eq=n_eq,
            channel_bytes=channel_bytes,
            profile=profile,
        )

    target = target if target is not None else detect_target()
    pol = get_policy(policy)
    bps = pol.bits // 8
    n_stages = len(chain.stages)

    if backends is None:
        backends = [s.backend for s in chain.stages]
    if len(backends) != n_stages:
        raise ValueError(f"need {n_stages} backends, got {len(backends)}")
    if placement is not None:
        if placement.n_stages != n_stages:
            raise ValueError(
                f"placement has {placement.n_stages} stages, chain has "
                f"{n_stages}"
            )
        place = placement
    else:
        if isinstance(cu_count, int):
            cus = [cu_count] * n_stages
        else:
            cus = list(cu_count)
            if len(cus) != n_stages:
                raise ValueError(f"need {n_stages} cu counts, got {len(cus)}")
        if isinstance(prefetch_depth, int):
            depth_vec = [prefetch_depth] * n_stages
        else:
            depth_vec = list(prefetch_depth)
            if len(depth_vec) != n_stages:
                raise ValueError(f"need {n_stages} prefetch depths")
        if topology is None:
            topology = DeviceTopology.homogeneous(max(1, max(cus)))
        place = place_chain(
            topology, cus, depth_vec, stage_groups=stage_groups
        )
    depths = list(place.prefetch_depths)
    any_prefetch = any(d > 0 for d in depths)
    # per-stage pricing targets: each stage is costed (and its buffers
    # burst-padded, channel-mapped, VMEM-bounded) against the datasheet
    # of the kind group that owns it; target-less groups (the
    # homogeneous legacy) fall back to the plan-wide target
    stage_ts = [place.stage_target(i, target) for i in range(n_stages)]

    pad = 0
    blk_align = 1
    if batch_elements is not None:
        e = batch_elements
    else:
        e = chain.auto_batch_elements(
            target, bytes_per_scalar=bps,
            channel_bytes=channel_bytes, n_eq=n_eq,
        )
        # co-sized E is padded to a multiple of the largest stage block
        # cap (caps are powers of two, so every stage's divides too);
        # all caps are passed so a small-cap stage cannot stay starved
        caps = [
            layout.batch_block_cap(
                s.program, stage_ts[i], bytes_per_scalar=bps
            )
            for i, s in enumerate(chain.stages)
        ]
        blk_align = max(caps)
        e, pad = layout.pad_batch_for_block(
            e, blk_align, limit=n_eq, caps=caps
        )
    e = max(1, int(e))
    if n_eq is not None:
        e = min(e, max(1, n_eq))
    # element sharding: every stage splits the batch evenly over its CU
    # group, so E must be a multiple of every group size.  Auto-sized E
    # is snapped down (the trim is reported via batch_pad_elements),
    # preserving the VMEM block alignment just established where it can
    # -- snapping to a bare multiple of the shard would collapse every
    # stage's Pallas block divisor (the pad_batch_for_block regression).
    # An explicit indivisible E is reported infeasible below.
    shard = 1
    for g in place.cu_counts:
        shard = shard * g // math.gcd(shard, g)
    if e % shard and batch_elements is None and e > shard:
        align = shard * blk_align // math.gcd(shard, blk_align)
        snap = align if e >= align else shard
        trim = e % snap
        e -= trim
        pad -= trim
    n_batches = max(1, n_eq // e) if n_eq else None

    # per-stage E_s: every stage runs the chain E unless a vector was
    # requested; requests snap to divide E and shard on the stage's CU
    # group (the executor re-blocks at handoffs where E_s changes)
    if stage_batch_elements is not None:
        if len(stage_batch_elements) != n_stages:
            raise ValueError(
                f"need {n_stages} stage batch sizes, got "
                f"{len(stage_batch_elements)}"
            )
        stage_es = [
            snap_stage_elements(e, req, place.stages[i].cu_count)
            for i, req in enumerate(stage_batch_elements)
        ]
    else:
        stage_es = [e] * n_stages

    # placement-aware channel assignment: one round-robin allocator per
    # kind group, offset into a global id space, so every stream draws
    # from the pseudo-channels of the group owning its producing stage
    # (a single-group topology degenerates to the legacy shared
    # allocator exactly)
    allocs: Dict[int, layout.ChannelAllocator] = {}
    ch_base = 0
    for gi, gspec in enumerate(place.topology.groups):
        g_t = gspec.target if gspec.target is not None else target
        allocs[gi] = layout.ChannelAllocator(g_t.n_channels, base=ch_base)
        ch_base += g_t.n_channels
    shared_ops = chain.shared_operands()
    placed_shared: Dict[str, BufferSpec] = {}
    resident_spec: Dict[Tuple[int, str], BufferSpec] = {}
    stage_plans: List[StagePlan] = []
    max_stage_ws = 0
    max_stage_ws_vmem = target.vmem_bytes

    reblock: List[float] = [0.0] * n_stages
    for i, stage in enumerate(chain.stages):
        prog = stage.program
        backend = backends[i]
        depth = depths[i]
        stage_t = stage_ts[i]
        e_s = stage_es[i]
        m = max(1, e // e_s)          # sub-batches per chain batch
        in_repl = depth + 2 if depth > 0 else 1
        io_repl = 2 if any_prefetch else 1
        alloc = allocs[place.stage_group_index(i)]
        bufs: List[BufferSpec] = []

        def add(name, node, role, replicas, group=""):
            b = layout.make_buffer(
                name, node, role, replicas, target=stage_t,
                bytes_per_scalar=bps, batch_elements=e_s,
                alloc=alloc, group=group,
            )
            bufs.append(b)
            return b

        for name, node in chain.host_element_inputs(i):
            add(f"{stage.name}.{name}", node, "in", in_repl)
        for name, node in chain.resident_outputs(i):
            resident_spec[(i, name)] = add(
                f"{stage.name}.{name}", node, "resident", io_repl
            )
        for name, node in chain.chain_outputs(i):
            add(f"{stage.name}.{name}", node, "out", io_repl)
        for name, node in prog.inputs.items():
            if (name in prog.element_vars or name in chain.resolved[i]
                    or name in placed_shared):
                continue
            if name in shared_ops:
                placed_shared[name] = add(name, node, "shared", 1)

        sched: Optional[Schedule] = None
        if backend == "staged":
            key = (i, bps)
            if _sched_cache is not None and key in _sched_cache:
                sched = _sched_cache[key]
            else:
                sched = make_schedule(prog, bytes_per_scalar=bps)
                if _sched_cache is not None:
                    _sched_cache[key] = sched
            out_uids = {v.uid for v in prog.outputs.values()}
            input_uids = {v.uid for v in prog.inputs.values()}
            for g in sched.groups:
                streamed = [
                    n for n in g.out_streams
                    if n.uid not in out_uids and n.uid not in input_uids
                ]
                for k, node in enumerate(streamed):
                    add(f"{stage.name}.{g.name}.s{k}", node, "inter", 1,
                        group=g.name)
            ws = max(g.working_set(bps) for g in sched.groups)
            if ws > max_stage_ws:
                max_stage_ws = ws
                max_stage_ws_vmem = stage_t.vmem_bytes

        # stage cost: host link carries only this stage's in/out streams;
        # HBM carries those plus resident reads/writes and 2x inter
        stage_hbm = hbm_stream_bytes(bufs)
        for in_name, (p, out_name) in chain.resolved[i].items():
            # consumer-side read of a resident buffer placed by stage p
            # (the write half is already billed to the producer's hbm
            # count above, via the 2x resident rule on its own buffer);
            # read at *this* stage's E_s -- one sub-batch per dispatch
            spec = resident_spec[(p, out_name)]
            stage_hbm += spec.padded_bytes * e_s
            # re-block handoff: when the boundary changes E_s or device
            # kind, the chain batch's bytes cross the slower side's
            # link before this stage can consume them
            if stage_es[p] != e_s or place.stage_kind(p) != place.stage_kind(i):
                hand_bytes = spec.padded_bytes * e
                p_t, i_t = stage_ts[p], stage_t
                if place.stage_kind(p) != place.stage_kind(i):
                    bw = min(p_t.host_link_bw, i_t.host_link_bw)
                else:
                    bw = min(p_t.hbm_bw, i_t.hbm_bw)
                reblock[i] += hand_bytes / bw if bw > 0 else 0.0
        # a producer's resident buffer counts write-only for itself
        stage_hbm -= sum(
            b.batch_bytes for b in bufs if b.role == "resident"
        )
        # channels this stage touches: its own buffers, the resident
        # streams it reads, and the shared operands it consumes
        touched = list(bufs)
        touched += [
            resident_spec[src] for src in chain.resolved[i].values()
        ]
        touched += [
            placed_shared[n] for n in prog.inputs
            if n in placed_shared
        ]
        cost = _scale_cost(
            predict_cost(
                stage_t, policy=pol.name, batch_elements=e_s,
                flops_per_element=prog.total_flops(),
                host_bytes=host_stream_bytes(bufs),
                hbm_bytes=stage_hbm,
                channels_used=channels_used(touched),
                prefetch_depth=depth, cu_count=place.stages[i].cu_count,
                n_batches=n_batches,
            ),
            m,
        )
        blk, blk_ws = layout.stage_block(
            prog, stage_t, e_s, bytes_per_scalar=bps,
            kernel=backend == "pallas" and not pol.is_fixed_point,
        )
        stage_plans.append(
            StagePlan(
                name=stage.name, backend=backend, prefetch_depth=depth,
                flops_per_element=prog.total_flops(),
                buffers=tuple(bufs), cost=cost,
                block_elements=blk,
                block_working_set_bytes=blk_ws,
                cu_count=place.stages[i].cu_count,
                devices=place.stages[i].devices,
                batch_elements=e_s,
                kind=stage_t.name,
            )
        )

    pipeline = derive_pipeline(depths)
    plan = ChainPlan(
        chain=chain.name, target=target, policy=pol.name,
        batch_elements=e, placement=place,
        stages=tuple(stage_plans),
        cost=ChainCost(
            stages=tuple(sp.cost for sp in stage_plans),
            pipelined_stages=pipeline.pipelined,
            fill_batches=pipeline.fill_batches,
            n_batches=n_batches,
            contention=place.contention,
            t_reblock=(
                tuple(reblock) if any(r > 0 for r in reblock) else ()
            ),
        ),
        batch_pad_elements=pad,
        pipeline=pipeline,
        stage_batch_elements=(
            tuple(stage_es) if any(es != e for es in stage_es) else ()
        ),
    )
    # VMEM bounds are per stage against the stage's own datasheet
    # (identical to the plan-wide target on a homogeneous topology)
    worst_blk, worst_blk_vmem = 0, target.vmem_bytes
    for i, sp in enumerate(stage_plans):
        if sp.block_working_set_bytes > worst_blk:
            worst_blk = sp.block_working_set_bytes
            worst_blk_vmem = stage_ts[i].vmem_bytes
    # resident HBM is a per-group budget: each kind group holds only
    # the buffers of the stages placed on it
    group_resident: Dict[int, int] = {}
    for i, sp in enumerate(stage_plans):
        gi = place.stage_group_index(i)
        group_resident[gi] = group_resident.get(gi, 0) + sum(
            b.resident_bytes for b in sp.buffers
        )
    resident_excess = ""
    for gi, rb in sorted(group_resident.items()):
        g_t = place.topology.groups[gi].target or target
        if rb > g_t.usable_hbm_bytes:
            resident_excess = (
                f"resident {rb / 2**20:.0f} MiB exceeds "
                f"usable HBM {g_t.usable_hbm_bytes / 2**20:.0f} MiB"
            )
            if len(place.topology.groups) > 1:
                resident_excess += (
                    f" on group {gi} ({place.topology.groups[gi].kind})"
                )
            break
    feasible, reason = True, ""
    if e % shard:
        feasible = False
        reason = (
            f"batch E={e} does not shard evenly over the stage CU "
            f"groups (needs a multiple of {shard})"
        )
    elif resident_excess:
        feasible = False
        reason = resident_excess
    elif worst_blk > worst_blk_vmem:
        feasible = False
        reason = (
            f"stage block working set {worst_blk} B exceeds on-chip "
            f"{worst_blk_vmem} B"
        )
    elif max_stage_ws > max_stage_ws_vmem:
        feasible = False
        reason = (
            f"stage working set {max_stage_ws} B exceeds on-chip "
            f"{max_stage_ws_vmem} B"
        )
    if not feasible:
        plan = dataclasses.replace(
            plan, feasible=False, infeasible_reason=reason
        )
    if profile is not None:
        plan = apply_profile_contention(plan, profile)
    return plan
