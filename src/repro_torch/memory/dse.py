"""Design-space exploration over memory architectures (CHARM-style CDSE)
for one operator or a whole chain.

Sweeps the planner's knobs -- backend, precision policy, batch size E,
prefetch depth K, CU replication -- and scores every candidate plan with
a three-term analytic cost model (compute / device-memory / host-link,
priced from ``memory.channels`` datasheets).  Returns a ranked candidate
list plus the Pareto front over (predicted time, resident device
memory); the top candidates can be *verified by measurement* through
the real simulation driver on the card (:func:`measure_plan`), and the
measured/predicted ratios fit a per-term :class:`CostCorrection` --
the paper's predict-then-build loop.  :func:`explore_chain` sweeps a
whole ProgramChain the same way (per-stage backends, E, joint per-stage
placements found by branch and bound, optional stage fusion first) and
verifies its leaders through the chain driver (:func:`measure_chain_plan`).

The model is deliberately monotone: more bandwidth or more FLOP/s never
predicts a slower plan, so sweeps over hypothetical machines
(``MemoryTarget.with_``) are safe to reason about directionally.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..core import dsl, ir, rewrite
from ..core.precision import get_policy
from ..core.schedule import Schedule, schedule as make_schedule
from . import layout
from .channels import MemoryTarget, detect_target, resolve_devices
from .plan import (CostBreakdown, MemoryPlan, channels_used,
                   hbm_stream_bytes, host_stream_bytes)

#: Cost-model epoch.  Bump this whenever the analytic model's terms
#: change meaning (new term, re-derived constant, different bottleneck
#: attribution): ``trace.ProfileStore`` stamps every recorded sample
#: with the epoch and a ``correction()`` refit ignores samples recorded
#: under any other epoch, so measured/predicted ratios from an obsolete
#: model can never steer the current one.
COST_MODEL_VERSION = 1

#: Throughput of each scalar policy relative to the target's native
#: matmul peak (TPU: bf16 MXU; f32 runs at half rate, f64 and the
#: integer-emulated fixed-point formats far below).
POLICY_EFFICIENCY = {
    "bfloat16": 1.0,
    "float32": 0.5,
    "float64": 0.125,
    "fixed32_q8.24": 0.25,
    "fixed64_q24.40": 0.0625,
}


def _resolve_program(
    p_or_prog: Union[int, ir.Program], operator_name: Optional[str]
) -> Tuple[ir.Program, str]:
    """An int selects the paper's Inverse-Helmholtz operator at degree p."""
    if isinstance(p_or_prog, ir.Program):
        return p_or_prog, operator_name or "program"
    p = int(p_or_prog)
    prog = rewrite.optimize(
        dsl.parse(
            dsl.INVERSE_HELMHOLTZ_SRC.format(p=p),
            element_vars=("u", "D", "v"),
        )
    )
    return prog, operator_name or f"inverse_helmholtz_p{p}"


def predict_cost(
    target: MemoryTarget,
    *,
    policy: str,
    batch_elements: int,
    flops_per_element: int,
    host_bytes: int,
    hbm_bytes: int,
    channels_used: int,
    prefetch_depth: int,
    cu_count: int,
    n_batches: Optional[int] = None,
) -> CostBreakdown:
    """Per-batch time under the three-term overlap model.

    Device bandwidth is what the *assigned channels* deliver (the paper's
    point: unmapped pseudo-channels are wasted bandwidth); the host link
    is shared across replicated CUs.
    """
    eff = POLICY_EFFICIENCY.get(policy, 0.25)
    t_compute = (
        batch_elements * flops_per_element / (target.peak_flops * eff * cu_count)
    )
    bw = target.channel_bw * min(max(1, channels_used), target.n_channels)
    t_hbm = hbm_bytes / (bw * cu_count)
    t_host = host_bytes / target.host_link_bw
    t_over = target.dispatch_overhead_s
    t_serial = t_host + max(t_compute, t_hbm) + t_over
    if prefetch_depth == 0:
        t_pipelined = t_serial
    else:
        t_pipelined = max(t_host, t_compute, t_hbm) + t_over
        if n_batches:
            # pipeline fill: K transfers before the first compute (never
            # more than the batches that exist beyond the first)
            fill = min(prefetch_depth, n_batches - 1)
            t_pipelined += fill * t_host / n_batches
    return CostBreakdown(
        t_compute=t_compute, t_hbm=t_hbm, t_host=t_host, t_overhead=t_over,
        t_serial=t_serial, t_pipelined=t_pipelined,
    )


def make_plan(
    p_or_prog: Union[int, ir.Program],
    *,
    target: Optional[MemoryTarget] = None,
    policy: str = "float32",
    backend: str = "xla",
    batch_elements: Optional[int] = None,
    prefetch_depth: int = 1,
    cu_count: int = 1,
    n_eq: Optional[int] = None,
    channel_bytes: Optional[int] = None,
    operator_name: Optional[str] = None,
    _schedule: Optional[Schedule] = None,
) -> MemoryPlan:
    """Plan the memory architecture for one design point.

    ``batch_elements=None`` auto-sizes E from the channel capacity (the
    paper's rule); ``channel_bytes`` overrides the target's channel size
    (e.g. the paper's 256 MB).  Deterministic: same arguments, same plan.
    """
    target = target if target is not None else detect_target()
    pol = get_policy(policy) if isinstance(policy, str) else policy
    bps = pol.bits // 8
    prog, name = _resolve_program(p_or_prog, operator_name)

    sched = _schedule
    if sched is None and backend == "staged":
        sched = make_schedule(prog, bytes_per_scalar=bps)

    pad = 0
    if batch_elements is not None:
        e = batch_elements
    else:
        e = layout.auto_batch_elements(
            prog, target, bytes_per_scalar=bps,
            channel_bytes=channel_bytes, n_eq=n_eq,
        )
        # auto-sized E is padded to a block multiple so a prime-ish
        # channel quotient never forces the Pallas block divisor tiny
        e, pad = layout.pad_batch_for_block(
            e, layout.batch_block_cap(prog, target, bytes_per_scalar=bps),
            limit=n_eq,
        )
    e = max(1, int(e))
    if n_eq is not None:
        e = min(e, max(1, n_eq))  # a batch never exceeds the problem
    bufs = layout.build_buffers(
        prog, target, bytes_per_scalar=bps, batch_elements=e,
        prefetch_depth=prefetch_depth, schedule=sched,
    )

    flops_pe = prog.total_flops()
    n_batches = max(1, n_eq // e) if n_eq else None
    cost = predict_cost(
        target, policy=pol.name, batch_elements=e,
        flops_per_element=flops_pe, host_bytes=host_stream_bytes(bufs),
        hbm_bytes=hbm_stream_bytes(bufs), channels_used=channels_used(bufs),
        prefetch_depth=prefetch_depth, cu_count=cu_count,
        n_batches=n_batches,
    )

    # on-chip block: largest divisor of E whose fused-kernel working set
    # fits the VMEM budget (drives the Pallas kernel's block_elements);
    # on the H100 a kernel plan's block is the CUDA kernel's tile
    blk, blk_ws = layout.stage_block(
        prog, target, e, bytes_per_scalar=bps,
        kernel=backend == "pallas" and not pol.is_fixed_point,
    )

    feasible, reason = True, ""
    resident = sum(b.resident_bytes for b in bufs)
    if resident > target.usable_hbm_bytes:
        feasible = False
        reason = (
            f"resident {resident / 2**20:.0f} MiB exceeds usable HBM "
            f"{target.usable_hbm_bytes / 2**20:.0f} MiB"
        )
    elif blk_ws > target.vmem_bytes:
        # even the BE=1 floor cannot fit on-chip: no fused kernel can run
        feasible = False
        reason = (
            f"block working set {blk_ws} B (BE={blk}) exceeds on-chip "
            f"{target.vmem_bytes} B"
        )
    elif sched is not None:
        ws = max(g.working_set(bps) for g in sched.groups)
        if ws > target.vmem_bytes:
            feasible = False
            reason = (
                f"stage working set {ws} B exceeds on-chip "
                f"{target.vmem_bytes} B"
            )

    return MemoryPlan(
        operator=name, target=target, policy=pol.name, backend=backend,
        batch_elements=e, prefetch_depth=prefetch_depth, cu_count=cu_count,
        buffers=bufs, cost=cost, feasible=feasible,
        infeasible_reason=reason, flops_per_element=flops_pe,
        block_elements=blk, block_working_set_bytes=blk_ws,
        batch_pad_elements=pad,
    )


# ---------------------------------------------------------------------------
# exploration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """The sweep axes (defaults mirror the paper's evaluation grid)."""

    backends: Tuple[str, ...] = ("xla", "staged")
    policies: Tuple[str, ...] = ("float32", "bfloat16")
    #: divisors of the auto-sized E to try (1 = the paper's full channel)
    batch_divisors: Tuple[int, ...] = (1, 2, 4)
    prefetch_depths: Tuple[int, ...] = (0, 1, 2, 4)
    cu_counts: Tuple[int, ...] = (1, 2, 4)


@dataclasses.dataclass
class Candidate:
    """One explored design point, ranked by predicted time/element."""

    plan: MemoryPlan
    predicted_s_per_element: float
    measured_s_per_element: Optional[float] = None
    #: prediction after the measured-feedback correction (calibrate=True)
    corrected_s_per_element: Optional[float] = None

    @property
    def verified(self) -> bool:
        """True once this design point has a measured run behind it."""
        return self.measured_s_per_element is not None


@dataclasses.dataclass(frozen=True)
class CostCorrection:
    """Measured-feedback correction for the analytic model, learned *per
    cost term*: candidates whose measured runs were bottlenecked on the
    host link calibrate ``host_factor``, HBM-bound runs ``hbm_factor``,
    compute-bound runs ``compute_factor`` -- each the geometric mean of
    measured/predicted ratios over that class.  ``factor`` is the overall
    geometric mean and the fallback for terms the ladder never exercised.
    All factors are positive multipliers, so the model's monotonicity
    guarantees survive correction."""

    factor: float = 1.0
    n_samples: int = 0
    host_factor: Optional[float] = None
    hbm_factor: Optional[float] = None
    compute_factor: Optional[float] = None

    def factor_for(self, bottleneck: Optional[str] = None) -> float:
        """The multiplier for a prediction dominated by ``bottleneck``
        (a ``CostBreakdown.bottleneck`` label); overall factor when the
        term was never measured (or no term is given)."""
        per_term = {
            "host-link": self.host_factor,
            "hbm": self.hbm_factor,
            "compute": self.compute_factor,
        }.get(bottleneck)
        return per_term if per_term is not None else self.factor

    def corrected(
        self, predicted_s: float, bottleneck: Optional[str] = None
    ) -> float:
        """The prediction rescaled by its bottleneck's fitted factor."""
        return predicted_s * self.factor_for(bottleneck)


def _geomean(ratios: Sequence[float]) -> float:
    return math.exp(sum(math.log(r) for r in ratios) / len(ratios))


def fit_correction(cands: Sequence[Candidate]) -> CostCorrection:
    """Fit the per-term correction from every measured candidate
    (identity when nothing was measured).  Each measured run's
    measured/predicted ratio is attributed to the cost term its plan
    predicts as the bottleneck."""
    ratios: List[float] = []
    by_term: Dict[str, List[float]] = {}
    for c in cands:
        if not c.verified or c.predicted_s_per_element <= 0:
            continue
        r = c.measured_s_per_element / c.predicted_s_per_element
        ratios.append(r)
        by_term.setdefault(c.plan.cost.bottleneck, []).append(r)
    if not ratios:
        return CostCorrection()
    term = {
        k: _geomean(v) if v else None
        for k, v in (
            ("host-link", by_term.get("host-link")),
            ("hbm", by_term.get("hbm")),
            ("compute", by_term.get("compute")),
        )
    }
    return CostCorrection(
        factor=_geomean(ratios), n_samples=len(ratios),
        host_factor=term["host-link"], hbm_factor=term["hbm"],
        compute_factor=term["compute"],
    )


def apply_correction(
    cands: List[Candidate], correction: CostCorrection
) -> List[Candidate]:
    """Annotate every candidate with its corrected prediction (scaled by
    the factor of the term its own cost model says dominates) and
    re-rank (measured values, where present, outrank corrected
    predictions)."""
    for c in cands:
        c.corrected_s_per_element = correction.corrected(
            c.predicted_s_per_element, c.plan.cost.bottleneck
        )
    cands.sort(
        key=lambda c: (
            not c.plan.feasible,
            (c.measured_s_per_element
             if c.measured_s_per_element is not None
             else c.corrected_s_per_element),
            c.plan.resident_bytes,
        )
    )
    return cands


def explore(
    p_or_prog: Union[int, ir.Program] = 11,
    *,
    target: Optional[MemoryTarget] = None,
    n_eq: int = 1 << 16,
    space: Optional[DesignSpace] = None,
    measure_top: int = 0,
    measure_batches: int = 4,
    operator_name: Optional[str] = None,
    calibrate: bool = False,
    devices=None,
    device=None,
) -> List[Candidate]:
    """Sweep the design space; return candidates ranked best-first.

    Infeasible plans rank after all feasible ones (kept for the report).
    ``measure_top`` verifies the k best measurable candidates against the
    real simulation driver over the device pool ``devices`` (every
    visible card by default; ``device`` is the one-slot shorthand,
    ``"cpu"`` for the host; without a ``target``, the first slot's
    datasheet is planned for) and stores seconds/element alongside the
    prediction (:func:`measure_plan`).  ``calibrate``
    additionally fits the measured-feedback :class:`CostCorrection` from
    those runs and re-ranks every candidate by its corrected prediction.
    """
    if calibrate and not measure_top:
        raise ValueError(
            "calibrate=True fits the correction from measured runs; "
            "set measure_top > 0"
        )
    target = (target if target is not None
              else detect_target(resolve_devices(devices, device)[0]))
    space = space or DesignSpace()
    prog, name = _resolve_program(p_or_prog, operator_name)

    sched_cache: Dict[int, Schedule] = {}
    cands: List[Candidate] = []
    for policy in space.policies:
        bps = get_policy(policy).bits // 8
        auto_e = layout.auto_batch_elements(
            prog, target, bytes_per_scalar=bps, n_eq=n_eq
        )
        # the sweep explores divisors of the *padded* auto-E, so every
        # candidate batch stays block-composite
        auto_e, _ = layout.pad_batch_for_block(
            auto_e,
            layout.batch_block_cap(prog, target, bytes_per_scalar=bps),
            limit=n_eq,
        )
        e_cands = sorted({max(1, auto_e // d) for d in space.batch_divisors})
        for backend in space.backends:
            sched = None
            if backend == "staged":
                if bps not in sched_cache:
                    sched_cache[bps] = make_schedule(
                        prog, bytes_per_scalar=bps
                    )
                sched = sched_cache[bps]
            for e in e_cands:
                for depth in space.prefetch_depths:
                    for cu in space.cu_counts:
                        plan = make_plan(
                            prog, target=target, policy=policy,
                            backend=backend, batch_elements=e,
                            prefetch_depth=depth, cu_count=cu, n_eq=n_eq,
                            operator_name=name, _schedule=sched,
                        )
                        cands.append(
                            Candidate(
                                plan=plan,
                                predicted_s_per_element=(
                                    plan.cost.t_pipelined / plan.batch_elements
                                ),
                            )
                        )

    cands.sort(
        key=lambda c: (
            not c.plan.feasible,
            c.predicted_s_per_element,
            c.plan.resident_bytes,
        )
    )
    if measure_top:
        _measure_candidates(
            cands, p_or_prog, measure_top, n_eq=n_eq,
            max_batches=measure_batches, devices=devices, device=device,
        )
        if calibrate:
            apply_correction(cands, fit_correction(cands))
    return cands


# ---------------------------------------------------------------------------
# chain exploration (multi-operator programs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChainDesignSpace:
    """Sweep axes for a ProgramChain: per-stage backends are crossed
    (every combination up to ``max_backend_combos``), E divisors divide
    the co-sized chain E, and ``prefetch_depths`` x ``cu_counts`` form
    the *per-stage* placement menu: besides the chain-wide uniform
    sweep, :func:`explore_chain` searches joint per-stage
    ``(cu_count, prefetch_depth)`` vectors over the topology, keeping
    the ``max_placements`` best under a monotone-pruned frontier."""

    backends: Tuple[str, ...] = ("xla", "staged")
    policies: Tuple[str, ...] = ("float32",)
    batch_divisors: Tuple[int, ...] = (1, 2, 4)
    prefetch_depths: Tuple[int, ...] = (0, 1, 2)
    cu_counts: Tuple[int, ...] = (1,)
    max_backend_combos: int = 16
    #: joint per-stage placements kept per (policy, backends, E) point
    max_placements: int = 16
    #: branch-and-bound expansion cap (safety valve for deep chains)
    max_search_nodes: int = 20000


@dataclasses.dataclass
class ChainCandidate:
    """One explored chain design point (ranked like Candidate; the
    ``plan`` attribute makes :func:`pareto_front` and the measured-
    feedback :func:`apply_correction` work unchanged -- ``ChainCost``
    exposes the bottleneck stage's dominating term as its
    ``bottleneck``)."""

    plan: "chain_mod.ChainPlan"
    predicted_s_per_element: float
    measured_s_per_element: Optional[float] = None
    #: prediction after the measured-feedback correction (calibrate=True)
    corrected_s_per_element: Optional[float] = None

    @property
    def verified(self) -> bool:
        """True once this design point has a measured run behind it."""
        return self.measured_s_per_element is not None


def _pool_size(devices, device) -> int:
    """The slots of the caller's pool, counted without touching a device
    where the caller names them (one for ``device=``, the list's length
    for ``devices=``): a plan too big for them is refused before any
    device is asked for."""
    if device is not None:
        return 1
    if devices is not None:
        return len(list(devices))
    return len(resolve_devices())


def measure_chain_plan(
    chain: "chain_mod.ProgramChain",
    plan: "chain_mod.ChainPlan",
    *,
    max_batches: int = 4,
    devices=None,
    device=None,
) -> Optional[float]:
    """Verify a chain plan by running the real pipeline driver over the
    device pool ``devices`` (every visible card by default; ``device`` is
    the one-slot shorthand, ``"cpu"`` for the host); seconds per element.

    Returns None only where ``run_chain`` cannot run the plan as
    planned, so that a measurement never belongs to another
    configuration: the placement needs more slots than the pool has
    (``run_chain`` would fall back to one group), a stage group's batch
    does not shard evenly over it (the reference's run raises there, and
    it returns None), or the plan's backends or policy differ from the
    compiled chain's.  A placed plan runs each stage on its own group of
    slots, re-sharding the handoffs between groups; one with per-stage
    batch sizes re-blocks inside each shard.  Kernel stages run at the
    tiles the chain was compiled with (on the H100, the blocks the plan
    carries).  Every other failure -- a kernel that does not build or
    launch -- propagates.
    """
    from ..cfd.simulation import chain_stage_slots, run_chain  # lazy: no cycle

    if plan.placement.devices_used[-1] >= _pool_size(devices, device):
        return None
    compiled_backends = tuple(s.backend for s in chain.stages)
    if tuple(sp.backend for sp in plan.stages) != compiled_backends:
        return None  # would measure a different program than planned
    if any(s.compiled.policy.name != plan.policy for s in chain.stages):
        return None  # run_chain runs the compiled policy, not the plan's
    pool = resolve_devices(devices, device)
    groups = (chain_stage_slots(chain, plan, len(pool))
              or [range(len(pool))])
    if any(plan.batch_elements % len(g) for g in groups):
        return None
    run_chain(chain, plan, max_batches=1, devices=pool)  # warm-up
    res = run_chain(chain, plan, max_batches=max_batches, devices=pool)
    return res.wall_s / res.elements


def _search_stage_placements(
    stage_costs: Sequence[CostBreakdown],
    space: ChainDesignSpace,
    topology,
    batch_elements: int,
) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """Branch-and-bound over joint per-stage ``(cu, depth)`` vectors.

    ``stage_costs`` are the per-stage cost terms at ``cu=1`` (from one
    reference plan); a stage's device terms scale as ``1/cu`` and its
    contention comes from the topology assignment, so candidate vectors
    are scored without re-planning.  The frontier prune is *monotone*:
    extending a partial vector can only raise its max per-stage time,
    and every final score (back-to-back sum, or contended steady state)
    is bounded below by that max -- so a partial vector whose optimistic
    max already matches the k-th best completed score cannot improve the
    kept set and its whole subtree is cut.  Returns the up-to-
    ``max_placements`` best ``(cu_counts, prefetch_depths)`` vectors.
    """
    from .placement import place_chain

    n = len(stage_costs)
    # branch on cu only: the proxy score depends on depths solely
    # through "is any inter-stage ring open", so enumerating per-stage
    # depth permutations would burn the node budget |depths|-fold on
    # score-identical siblings.  Depth shapes are attached at the
    # leaves instead (serial / staging-only / uniform pipelined) and
    # priced exactly by plan_chain afterwards.
    opts: List[List[Tuple[float, int]]] = []
    for c in stage_costs:
        o: List[Tuple[float, int]] = []
        for cu in sorted(set(space.cu_counts)):
            if cu < 1 or cu > topology.n_devices or batch_elements % cu:
                continue
            t = max(c.t_host, max(c.t_compute, c.t_hbm) / cu) + c.t_overhead
            o.append((t, cu))
        if not o:
            o = [(
                max(c.t_host, max(c.t_compute, c.t_hbm)) + c.t_overhead, 1,
            )]
        o.sort()
        opts.append(o)

    def score(cus: Tuple[int, ...], pipelined: bool) -> float:
        place = place_chain(topology, cus, 1, n_stages=n)
        cont = place.contention
        b2b, steady = 0.0, 0.0
        for i, c in enumerate(stage_costs):
            dev = max(c.t_compute, c.t_hbm) / place.cu_counts[i]
            b2b += max(c.t_host, dev) + c.t_overhead
            steady = max(
                steady, max(c.t_host, cont[i] * dev) + c.t_overhead
            )
        return min(b2b, steady) if pipelined and n > 1 else b2b

    K = max(1, space.max_placements)
    best: List[Tuple[float, Tuple[int, ...]]] = []
    visited = 0

    def dfs(i: int, cus: List[int], partial_max: float) -> None:
        nonlocal visited
        visited += 1
        if visited > space.max_search_nodes:
            return
        if len(best) >= K and partial_max >= best[-1][0]:
            return  # monotone prune: no completion can beat the kept set
        if i == n:
            vec = tuple(cus)
            best.append((score(vec, pipelined=True), vec))
            best.sort(key=lambda x: x[0])
            del best[K:]
            return
        for t, cu in opts[i]:
            cus.append(cu)
            dfs(i + 1, cus, max(partial_max, t))
            cus.pop()

    dfs(0, [], 0.0)

    # canonical depth shapes per kept cu vector: pure serial, staging-
    # only (host rings deep, stages back-to-back -- a non-uniform
    # vector), and uniform pipelined at each positive swept depth
    positive = sorted({d for d in space.prefetch_depths if d > 0})
    shapes: List[Tuple[Tuple[int, ...], bool]] = []
    if 0 in space.prefetch_depths:
        shapes.append(((0,) * n, False))
    if positive:
        shapes.append(((max(positive),) + (0,) * (n - 1), False))
        shapes += [((d,) * n, True) for d in positive]
    if not shapes:
        shapes = [((0,) * n, False)]
    scored = [
        (score(cus, pipelined), cus, depths)
        for _, cus in best
        for depths, pipelined in shapes
    ]
    scored.sort(key=lambda x: x[0])
    # fair truncation across depth shapes: keep the best vectors of
    # every schedule shape, not K copies of the uniform-pipelined one
    # -- the proxy cannot price fill/residency, so the exact planner
    # must see serial and staging-only candidates too
    buckets = [
        [s for s in scored if s[2] == depths] for depths, _ in shapes
    ]
    kept: List[Tuple[float, Tuple[int, ...], Tuple[int, ...]]] = []
    while len(kept) < K and any(buckets):
        for b in buckets:
            if b and len(kept) < K:
                kept.append(b.pop(0))
    kept.sort(key=lambda x: x[0])
    return [(cus, depths) for _, cus, depths in kept]


def _search_hetero_placements(
    group_costs: Dict[int, Sequence[CostBreakdown]],
    space: ChainDesignSpace,
    topology,
    batch_elements: int,
) -> List[Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...],
                Tuple[int, ...]]]:
    """Branch-and-bound over joint per-stage ``(group, cu, E_s)``
    assignments on a heterogeneous topology.

    ``group_costs[gi]`` holds the per-stage cost terms of a reference
    plan with every stage pinned to kind group ``gi`` at ``cu=1`` and
    the chain E -- so each stage's candidate options are priced against
    the datasheet it would actually land on.  An option's proxy time is
    ``max(t_host, dev/cu) + m * t_overhead`` with ``m = E / E_s`` (a
    smaller E_s buys nothing in the proxy but lets small-memory groups
    pass the exact planner's residency/VMEM checks, which is why it is
    an axis at all).  The prune is the same monotone argument as the
    homogeneous search: every completed score is bounded below by the
    partial per-stage max.  Depth shapes are attached at the leaves and
    re-block costs are left to the exact planner -- the frontier is a
    menu, ``plan_chain`` is the judge.  Returns up to ``max_placements``
    ``(cu_counts, prefetch_depths, stage_groups, stage_elements)``.
    """
    from . import chain as chain_mod  # lazy: chain imports predict_cost
    from .placement import place_chain

    if not group_costs:
        return []
    n = len(next(iter(group_costs.values())))
    e = batch_elements
    divisors = sorted({max(1, int(d)) for d in space.batch_divisors})

    # per-stage option menu: (proxy time, group, cu, E_s), best first,
    # truncated so deep chains cannot blow up the search tree
    opts: List[List[Tuple[float, int, int, int]]] = []
    for i in range(n):
        o: Dict[Tuple[int, int, int], float] = {}
        for gi, costs in sorted(group_costs.items()):
            c = costs[i]
            size = topology.groups[gi].n_devices
            dev = max(c.t_compute, c.t_hbm)
            for cu in sorted(set(space.cu_counts)):
                if cu < 1 or cu > size or e % cu:
                    continue
                for d in divisors:
                    e_s = chain_mod.snap_stage_elements(
                        e, max(1, e // d), cu
                    )
                    m = max(1, e // e_s)
                    t = max(c.t_host, dev / cu) + m * c.t_overhead
                    key = (gi, cu, e_s)
                    if key not in o or t < o[key]:
                        o[key] = t
        lst = sorted((t, gi, cu, es) for (gi, cu, es), t in o.items())
        if not lst:
            gi = min(group_costs)
            c = group_costs[gi][i]
            lst = [(
                max(c.t_host, max(c.t_compute, c.t_hbm)) + c.t_overhead,
                gi, 1, e,
            )]
        opts.append(lst[:12])

    def score(
        gis: Tuple[int, ...], cus: Tuple[int, ...],
        es: Tuple[int, ...], pipelined: bool,
    ) -> float:
        place = place_chain(
            topology, cus, 1, n_stages=n, stage_groups=gis
        )
        cont = place.contention
        b2b, steady = 0.0, 0.0
        for i in range(n):
            c = group_costs[gis[i]][i]
            m = max(1, e // es[i])
            dev = max(c.t_compute, c.t_hbm) / place.cu_counts[i]
            b2b += max(c.t_host, dev) + m * c.t_overhead
            steady = max(
                steady, max(c.t_host, cont[i] * dev) + m * c.t_overhead
            )
        return min(b2b, steady) if pipelined and n > 1 else b2b

    K = max(1, space.max_placements)
    best: List[Tuple[float, Tuple[int, ...], Tuple[int, ...],
                     Tuple[int, ...]]] = []
    visited = 0

    def dfs(
        i: int, gis: List[int], cus: List[int], es: List[int],
        partial_max: float,
    ) -> None:
        nonlocal visited
        visited += 1
        if visited > space.max_search_nodes:
            return
        if len(best) >= K and partial_max >= best[-1][0]:
            return  # monotone prune, as in the homogeneous search
        if i == n:
            g, c, s = tuple(gis), tuple(cus), tuple(es)
            best.append((score(g, c, s, pipelined=True), g, c, s))
            best.sort(key=lambda x: x[0])
            del best[K:]
            return
        for t, gi, cu, e_s in opts[i]:
            gis.append(gi); cus.append(cu); es.append(e_s)
            dfs(i + 1, gis, cus, es, max(partial_max, t))
            gis.pop(); cus.pop(); es.pop()

    dfs(0, [], [], [], 0.0)

    positive = sorted({d for d in space.prefetch_depths if d > 0})
    shapes: List[Tuple[Tuple[int, ...], bool]] = []
    if 0 in space.prefetch_depths:
        shapes.append(((0,) * n, False))
    if positive:
        shapes.append(((max(positive),) + (0,) * (n - 1), False))
        shapes += [((d,) * n, True) for d in positive]
    if not shapes:
        shapes = [((0,) * n, False)]
    scored = [
        (score(gis, cus, es, pipelined), cus, depths, gis, es)
        for _, gis, cus, es in best
        for depths, pipelined in shapes
    ]
    scored.sort(key=lambda x: x[0])
    buckets = [
        [s for s in scored if s[2] == depths] for depths, _ in shapes
    ]
    kept: List = []
    while len(kept) < K and any(buckets):
        for b in buckets:
            if b and len(kept) < K:
                kept.append(b.pop(0))
    kept.sort(key=lambda x: x[0])
    return [(cus, depths, gis, es) for _, cus, depths, gis, es in kept]


def explore_chain(
    chain: "chain_mod.ProgramChain",
    *,
    target: Optional[MemoryTarget] = None,
    n_eq: int = 1 << 16,
    space: Optional[ChainDesignSpace] = None,
    topology=None,
    measure_top: int = 0,
    measure_batches: int = 4,
    calibrate: bool = False,
    profile=None,
    fuse: Optional[str] = None,
    max_stages: Optional[int] = None,
    fuse_barriers: Sequence[str] = (),
    devices=None,
    device=None,
) -> List[ChainCandidate]:
    """Sweep chain plans: per-stage backend combinations and *joint
    per-stage placements* under one shared (divisor-scaled) E.

    ``fuse='auto'`` (or a ``max_stages`` budget below the stage count)
    first runs the cost-driven fusion pass
    (:func:`repro_torch.memory.fusion.fuse_chain_auto`) with default knobs and
    then sweeps the *fused* chain -- so every candidate shares one stage
    structure and the ranking stays homogeneous; each candidate's plan
    carries the fusion decision as ``plan.fusion``.  ``fuse_barriers``
    names stages whose downstream boundary fusion must keep.

    Every
    (policy, backends, E) point contributes the classic chain-wide
    uniform (cu, depth) grid plus the ``max_placements`` best joint
    per-stage vectors found by :func:`_search_stage_placements` over
    ``topology`` (default: just enough devices for the largest swept CU
    count).  Ranked best-first with infeasible plans last, exactly like
    :func:`explore`.  Depth>0 candidates are priced with the
    contention-aware cross-batch overlap term
    (``ChainCost.t_overlapped``: slowest contended stage + amortized
    fill/drain), so replication and stage pipelining competing for the
    same devices is weighed exactly as the executor delivers it.

    On a heterogeneous topology (kind groups with their own datasheets)
    the joint search instead co-varies per-stage ``(group, cu, E_s)``
    via :func:`_search_hetero_placements`; every kind group's
    single-group uniform grid is also swept explicitly, so the winner is
    never worse than the best homogeneous-restricted plan on the same
    device budget.

    ``measure_top`` verifies the k best feasible candidates whose
    planned backends and policy match the chain's compiled ones by
    running the real ``run_chain`` driver over the device pool
    ``devices`` (every visible card by default; ``device`` is the
    one-slot shorthand, ``"cpu"`` for the host; without a ``target``, the
    first slot's datasheet is planned for): a multi-device candidate
    runs as placed where the pool has its slots, and candidates it
    cannot run as planned are skipped (:func:`measure_chain_plan`).
    ``calibrate`` additionally fits the per-term :class:`CostCorrection`
    from those measured runs (each ratio attributed to the bottleneck
    stage's dominating term) and re-ranks every candidate by its
    corrected prediction.

    ``profile`` warm-starts the ranking from the persistent per-machine
    profile store (``repro_torch.trace.ProfileStore``): pass a store, a
    path, or ``True`` for the default location.  The store's correction
    for this target is applied to every candidate *before* any
    measurement (so ``measure_top`` verifies the profile-corrected top),
    and the measured candidates are recorded back into it.  With a
    ``device`` (or ``devices``: their first slot), the store is keyed for
    that device (:meth:`~repro_torch.trace.ProfileStore.for_device`):
    host samples never rank a card's plans."""
    import itertools

    from . import chain as chain_mod  # local: chain imports predict_cost
    from .placement import DeviceTopology

    if calibrate and not measure_top:
        raise ValueError(
            "calibrate=True fits the correction from measured runs; "
            "set measure_top > 0"
        )
    target = (target if target is not None
              else detect_target(resolve_devices(devices, device)[0]))
    space = space or ChainDesignSpace()
    if topology is None:
        topology = DeviceTopology.homogeneous(max(1, max(space.cu_counts)))
    hetero = len(topology.groups) > 1

    fusion_spec = None
    if fuse == "auto" or (
        fuse != "off" and max_stages is not None
        and max_stages < len(chain.stages)
    ):
        from .fusion import fuse_chain_auto  # lazy: fusion imports chain

        fused_plan = fuse_chain_auto(
            chain, mode="auto", max_stages=max_stages,
            barriers=tuple(fuse_barriers), target=target,
            topology=topology, n_eq=n_eq,
        )
        fusion_spec = fused_plan.fusion
        chain = fusion_spec.chain
    n_stages = len(chain.stages)

    combos = list(
        itertools.islice(
            itertools.product(space.backends, repeat=n_stages),
            space.max_backend_combos,
        )
    )
    sched_cache: Dict = {}  # (stage idx, bps) -> Schedule, shared by all points
    cands: List[ChainCandidate] = []
    for policy in space.policies:
        bps = get_policy(policy).bits // 8
        auto_e = chain.auto_batch_elements(
            target, bytes_per_scalar=bps, n_eq=n_eq
        )
        stage_caps = [
            layout.batch_block_cap(
                s.program, target, bytes_per_scalar=bps
            )
            for s in chain.stages
        ]
        auto_e, _ = layout.pad_batch_for_block(
            auto_e, max(stage_caps), limit=n_eq, caps=stage_caps
        )
        e_cands = sorted({max(1, auto_e // d) for d in space.batch_divisors})
        for backends in combos:
            for e in e_cands:
                def make_plan_at(cus, depths, groups=None, stage_es=None):
                    return chain_mod.plan_chain(
                        chain, target=target, policy=policy,
                        backends=backends, batch_elements=e,
                        prefetch_depth=list(depths), cu_count=list(cus),
                        topology=topology, n_eq=n_eq,
                        stage_groups=(
                            list(groups) if groups is not None else None
                        ),
                        stage_batch_elements=(
                            list(stage_es) if stage_es is not None
                            else None
                        ),
                        _sched_cache=sched_cache,
                    )

                # reference plan: per-stage cost terms at cu=1 feed the
                # placement search (device terms scale as 1/cu)
                ref = make_plan_at((1,) * n_stages, (1,) * n_stages)
                vectors = {
                    ((1,) * n_stages, (1,) * n_stages, None, None): ref,
                }
                # the classic chain-wide uniform sweep is kept verbatim
                for depth in space.prefetch_depths:
                    for cu in space.cu_counts:
                        cu = max(1, min(cu, topology.n_devices))
                        vectors.setdefault(
                            ((cu,) * n_stages, (depth,) * n_stages,
                             None, None),
                            None,
                        )
                if hetero:
                    # per-group references: every stage priced on each
                    # kind group's own datasheet at cu=1
                    group_refs = {
                        gi: make_plan_at(
                            (1,) * n_stages, (1,) * n_stages,
                            groups=(gi,) * n_stages,
                        )
                        for gi in range(len(topology.groups))
                    }
                    # single-group-restricted uniforms are explicit
                    # candidates, so the heterogeneous winner can never
                    # rank behind the best homogeneous-restricted plan
                    # on the same device budget
                    for gi, gspec in enumerate(topology.groups):
                        for depth in space.prefetch_depths:
                            for cu in space.cu_counts:
                                cu = max(1, min(cu, gspec.n_devices))
                                vectors.setdefault(
                                    ((cu,) * n_stages,
                                     (depth,) * n_stages,
                                     (gi,) * n_stages, None),
                                    None,
                                )
                    # plus the joint per-stage (group, cu, E_s) frontier
                    for cus, depths, gis, es in _search_hetero_placements(
                        {
                            gi: [sp.cost for sp in r.stages]
                            for gi, r in group_refs.items()
                        },
                        space, topology, e,
                    ):
                        vectors.setdefault((cus, depths, gis, es), None)
                else:
                    # the joint per-stage frontier over the topology
                    for cus, depths in _search_stage_placements(
                        [sp.cost for sp in ref.stages], space, topology, e
                    ):
                        vectors.setdefault((cus, depths, None, None), None)
                for (cus, depths, gis, es), plan in vectors.items():
                    if plan is None:
                        plan = make_plan_at(
                            cus, depths, groups=gis, stage_es=es
                        )
                    if fusion_spec is not None:
                        plan = dataclasses.replace(
                            plan, fusion=fusion_spec
                        )
                    cands.append(
                        ChainCandidate(
                            plan=plan,
                            predicted_s_per_element=(
                                plan.cost.t_pipelined
                                / plan.batch_elements
                            ),
                        )
                    )
    cands.sort(
        key=lambda c: (
            not c.plan.feasible,
            c.predicted_s_per_element,
            c.plan.resident_bytes,
        )
    )
    store = None
    if profile is not None:
        from ..trace.profile import ProfileStore  # lazy: no import cycle

        store = ProfileStore.open(profile)
        key = device if devices is None else list(devices)[0]
        if store is not None and key is not None:
            store = store.for_device(key)
    if store is not None:
        corr = store.correction(target.name)
        if corr.n_samples:
            apply_correction(cands, corr)
    if measure_top:
        measured = 0
        for c in cands:
            if measured >= measure_top:
                break
            if not c.plan.feasible:
                continue
            got = measure_chain_plan(
                chain, c.plan, max_batches=measure_batches,
                devices=devices, device=device,
            )
            if got is not None:
                c.measured_s_per_element = got
                measured += 1
        if store is not None and measured:
            for c in cands:
                if c.measured_s_per_element is not None:
                    store.record_measurement(
                        c.plan, c.predicted_s_per_element,
                        c.measured_s_per_element, scope="dse", save=False,
                    )
            store.save()
        if calibrate:
            apply_correction(cands, fit_correction(cands))
    return cands


def pareto_front(cands: Sequence[Candidate]) -> List[Candidate]:
    """Feasible candidates not dominated in (predicted time, resident
    bytes): the plan menu the operator actually chooses from."""
    feas = [c for c in cands if c.plan.feasible]
    front: List[Candidate] = []
    for c in feas:
        dominated = any(
            (o.predicted_s_per_element <= c.predicted_s_per_element
             and o.plan.resident_bytes <= c.plan.resident_bytes
             and (o.predicted_s_per_element < c.predicted_s_per_element
                  or o.plan.resident_bytes < c.plan.resident_bytes))
            for o in feas
        )
        if not dominated:
            front.append(c)
    return front


def measure_plan(
    plan: MemoryPlan,
    p: int,
    *,
    n_eq: Optional[int] = None,
    max_batches: int = 4,
    devices=None,
    device=None,
) -> Optional[float]:
    """Verify a plan by running the real driver over the device pool
    ``devices`` (every visible card by default; ``device`` is the
    one-slot shorthand, ``"cpu"`` for the host); seconds per element.

    ``run_simulation`` replicates the operator over every slot of the
    pool, as the reference's over its element mesh.  Returns None only
    when the plan replicates more CUs than the pool has slots (such a
    time would belong to another configuration) or its batch does not
    shard evenly over the pool (the reference's run raises there, and it
    returns None).  Every other failure -- a kernel that does not build
    or launch, a policy the backend cannot run -- propagates."""
    from ..cfd.simulation import SimConfig, run_simulation  # lazy: no cycle

    if plan.cu_count > _pool_size(devices, device):
        return None
    pool = resolve_devices(devices, device)
    if plan.batch_elements % len(pool):
        return None
    cfg = SimConfig(
        p=p, n_eq=n_eq or plan.batch_elements * max_batches,
        batch_elements=plan.batch_elements, policy=plan.policy,
        backend=plan.backend, prefetch_depth=plan.prefetch_depth,
    )
    run_simulation(cfg, plan=plan, max_batches=1, devices=pool)  # warm-up
    res = run_simulation(cfg, plan=plan, max_batches=max_batches,
                         devices=pool)
    return res.wall_s / res.elements if res.elements else None


def _measure_candidates(
    cands: List[Candidate],
    p_or_prog,
    top_k: int,
    *,
    n_eq: int,
    max_batches: int,
    devices=None,
    device=None,
) -> None:
    if not isinstance(p_or_prog, int):
        return  # measurement needs the named operator builder
    measured = 0
    for c in cands:
        if measured >= top_k:
            break
        if not c.plan.feasible:
            continue
        got = measure_plan(
            c.plan, p_or_prog,
            n_eq=min(n_eq, c.plan.batch_elements * max_batches),
            max_batches=max_batches, devices=devices, device=device,
        )
        if got is not None:
            c.measured_s_per_element = got
            measured += 1


def format_chain_ranking(
    cands: Sequence[ChainCandidate], limit: int = 10
) -> str:
    """Compact leaderboard for chain sweeps (per-stage backends and
    per-stage (cu, depth) placements)."""
    hdr = (
        f"{'#':>3} {'backends':<28} {'policy':<10} {'E':>8} "
        f"{'K':<8} {'CU':<8} "
        f"{'pred us/elem':>13} {'meas us/elem':>13} "
        f"{'resident MiB':>13} {'feasible':>9}"
    )
    lines = [hdr, "-" * len(hdr)]

    def vec(vals):
        s = ",".join(str(v) for v in vals)
        if len(set(vals)) == 1:
            s = str(vals[0])
        return s if len(s) <= 8 else s[:5] + "..."

    for i, c in enumerate(cands[:limit]):
        p = c.plan
        meas = (
            f"{c.measured_s_per_element * 1e6:13.4f}"
            if c.measured_s_per_element is not None else f"{'-':>13}"
        )
        backends = ",".join(sp.backend for sp in p.stages)
        if len(backends) > 28:
            backends = backends[:25] + "..."
        lines.append(
            f"{i:>3} {backends:<28} {p.policy:<10} {p.batch_elements:>8} "
            f"{vec([sp.prefetch_depth for sp in p.stages]):<8} "
            f"{vec(list(p.cu_counts)):<8} "
            f"{c.predicted_s_per_element * 1e6:>13.4f} "
            f"{meas} {p.resident_bytes / 2**20:>13.1f} "
            f"{'yes' if p.feasible else 'no':>9}"
        )
    return "\n".join(lines)



def format_ranking(cands: Sequence[Candidate], limit: int = 10) -> str:
    """Compact leaderboard for logs/benchmarks."""
    hdr = (
        f"{'#':>3} {'backend':<8} {'policy':<16} {'E':>8} {'K':>2} "
        f"{'CU':>3} {'pred us/elem':>13} {'meas us/elem':>13} "
        f"{'resident MiB':>13} {'feasible':>9}"
    )
    lines = [hdr, "-" * len(hdr)]
    for i, c in enumerate(cands[:limit]):
        meas = (
            f"{c.measured_s_per_element * 1e6:13.4f}"
            if c.measured_s_per_element is not None else f"{'-':>13}"
        )
        lines.append(
            f"{i:>3} {c.plan.backend:<8} {c.plan.policy:<16} "
            f"{c.plan.batch_elements:>8} {c.plan.prefetch_depth:>2} "
            f"{c.plan.cu_count:>3} {c.predicted_s_per_element * 1e6:>13.4f} "
            f"{meas} {c.plan.resident_bytes / 2**20:>13.1f} "
            f"{'yes' if c.plan.feasible else 'no':>9}"
        )
    return "\n".join(lines)
