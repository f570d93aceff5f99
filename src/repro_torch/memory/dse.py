"""Design-space exploration over memory architectures (CHARM-style CDSE)
for one operator.

Sweeps the planner's knobs -- backend, precision policy, batch size E,
prefetch depth K, CU replication -- and scores every candidate plan with
a three-term analytic cost model (compute / device-memory / host-link,
priced from ``memory.channels`` datasheets).  Returns a ranked candidate
list plus the Pareto front over (predicted time, resident device
memory); the top candidates can be *verified by measurement* through
the real simulation driver on the card (:func:`measure_plan`), and the
measured/predicted ratios fit a per-term :class:`CostCorrection` --
the paper's predict-then-build loop.  The chain sweeps
(``explore_chain``, the placement searches) are not ported yet.

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
from .channels import MemoryTarget, detect_target, resolve_device
from .plan import (CostBreakdown, MemoryPlan, channels_used,
                   hbm_stream_bytes, host_stream_bytes)

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

    blk_cap = layout.vmem_block_elements(prog, target, bytes_per_scalar=bps)
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
        e, pad = layout.pad_batch_for_block(e, blk_cap, limit=n_eq)
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
    # fits the VMEM budget (drives the Pallas kernel's block_elements)
    blk = layout.largest_divisor_leq(e, blk_cap)
    blk_ws = layout.block_working_set_bytes(prog, blk, bytes_per_scalar=bps)

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
    device=None,
) -> List[Candidate]:
    """Sweep the design space; return candidates ranked best-first.

    Infeasible plans rank after all feasible ones (kept for the report).
    ``measure_top`` verifies the k best measurable candidates against the
    real simulation driver on ``device`` (the CUDA card unless
    ``"cpu"``; without a ``target``, also the datasheet planned for) and
    stores seconds/element alongside the prediction.  ``calibrate``
    additionally fits the measured-feedback :class:`CostCorrection` from
    those runs and re-ranks every candidate by its corrected prediction.
    """
    if calibrate and not measure_top:
        raise ValueError(
            "calibrate=True fits the correction from measured runs; "
            "set measure_top > 0"
        )
    target = target if target is not None else detect_target(device)
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
            layout.vmem_block_elements(prog, target, bytes_per_scalar=bps),
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
            max_batches=measure_batches, device=device,
        )
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
    device=None,
) -> Optional[float]:
    """Verify a plan by running the real driver on ``device`` (the CUDA
    card unless ``"cpu"``); seconds per element.

    Returns None only when the plan replicates more CUs than there are
    local devices (CUDA cards; the host counts as one).  Every other
    failure -- a kernel that does not build or launch, a policy the
    backend cannot run -- propagates."""
    import torch

    from ..cfd.simulation import SimConfig, run_simulation  # lazy: no cycle

    dev = resolve_device(device)
    n_local = torch.cuda.device_count() if dev.type == "cuda" else 1
    if plan.cu_count > n_local:
        return None
    cfg = SimConfig(
        p=p, n_eq=n_eq or plan.batch_elements * max_batches,
        batch_elements=plan.batch_elements, policy=plan.policy,
        backend=plan.backend, prefetch_depth=plan.prefetch_depth,
    )
    run_simulation(cfg, plan=plan, max_batches=1, device=dev)  # warm-up
    res = run_simulation(cfg, plan=plan, max_batches=max_batches, device=dev)
    return res.wall_s / res.elements if res.elements else None


def _measure_candidates(
    cands: List[Candidate],
    p_or_prog,
    top_k: int,
    *,
    n_eq: int,
    max_batches: int,
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
            max_batches=max_batches, device=device,
        )
        if got is not None:
            c.measured_s_per_element = got
            measured += 1


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
