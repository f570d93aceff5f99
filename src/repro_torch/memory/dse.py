"""The design-space cost model: one design point's plan and its price.

This is the part of the reference's design-space explorer the chain
planner needs: the three-term analytic cost model (compute /
device-memory / host-link, priced from ``memory.channels`` datasheets)
and the single-operator :func:`make_plan`.  The sweeps themselves
(``explore``, ``explore_chain``, measured verification and the
cost-correction fit) are not ported yet.

The model is deliberately monotone: more bandwidth or more FLOP/s never
predicts a slower plan, so sweeps over hypothetical machines
(``MemoryTarget.with_``) are safe to reason about directionally.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

from ..core import dsl, ir, rewrite
from ..core.precision import get_policy
from ..core.schedule import Schedule, schedule as make_schedule
from . import layout
from .channels import MemoryTarget, detect_target
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
