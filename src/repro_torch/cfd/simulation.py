"""Element-batched simulation drivers -- the Olympus system/host layer
on CUDA cards.

Implements the paper's section 3.1 quantities:

  * **batch**: ``E`` elements processed per dispatch, sized by an explicit
    :class:`repro_torch.memory.MemoryPlan` (one operator,
    :func:`run_simulation`, the paper's Fig. 2 flow) or
    :class:`repro_torch.memory.chain.ChainPlan` (the whole pipeline,
    :func:`run_chain`) -- the drivers hold no hardcoded batch size.
  * **N_b = N_eq / E** batches, **I = N_b / N_cu** iterations, where the
    CU count is the number of slots of the device pool the element axis
    is sharded over (CU replication == data parallelism over elements).
  * **transfer pipelining**: batch k+K..k+1 transfer host->device (pinned
    buffers, a side CUDA stream a card) while batch k computes, through
    the generic engine in ``repro_torch.memory.pipeline`` (K=1 is the
    ping/pong channel pair of Fig. 14a; K=0 is the serial baseline).

The device pool (``devices=``, :func:`~repro_torch.memory.channels.resolve_devices`)
stands in for the reference's element mesh: an ordered list of slots,
every visible card by default, one CPU slot with ``device="cpu"``; an
entry may repeat (``[cuda:0, cuda:0]`` is two slots on one card).  A
batch is sharded over a group of slots in contiguous equal chunks of
dim 0 (``memory.pipeline.element_chunks``), each shard runs the stage's
kernels on its slot's device, and outputs are gathered in slot order, so
collected outputs are bitwise those of one slot; a checksum sums the
per-shard sums, in another order than one slot's sum.  :func:`run_chain`
runs a plan's placement with one dispatch ring per device group and
re-shards each handoff that crosses groups; :func:`run_simulation`
replicates the operator over the whole pool.

The synthetic data follows the reference's numpy streams exactly
(``seed + b`` per batch; ``seed + 2**31`` for the Fig. 2 operator's S,
``seed + 2**31 + k`` per shared operand of a chain over the sorted
shared names), so at equal E and seed both packages see the same
inputs.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.precision import FixedPointPolicy
from ..memory import chain as memchain
from ..memory import channels as memchannels
from ..memory import dse as memdse
from ..memory import pipeline as mempipe
from ..memory.placement import DeviceTopology
from ..memory.plan import MemoryPlan
from .operators import build_inverse_helmholtz, flops_per_element


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Numpy arrays by name as tensors on ``device`` (the CUDA card unless
    ``"cpu"``), dtypes kept."""
    dev = memchannels.resolve_device(device)
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        for k, v in arrays.items()
    }


def replicate(arrays: Dict[str, np.ndarray],
              devices) -> Dict[torch.device, Dict[str, torch.Tensor]]:
    """Batch-invariant operands put once on each distinct device of the
    slots ``devices`` (the reference's replicated ``P()`` layout; slots
    that name one card share its copy)."""
    return {dev: to_device(arrays, dev) for dev in dict.fromkeys(devices)}


@dataclasses.dataclass
class SimConfig:
    p: int = 11
    n_eq: int = 2_000_000          # paper: 2M elements simulated
    #: E -- None lets the MemoryPlan auto-size it from the channel model
    batch_elements: Optional[int] = None
    policy: str = "float32"
    backend: str = "xla"
    double_buffer: bool = True
    #: K batches staged ahead; None derives it from ``double_buffer``
    prefetch_depth: Optional[int] = None
    seed: int = 0

    @property
    def depth(self) -> int:
        if self.prefetch_depth is not None:
            return self.prefetch_depth
        return 1 if self.double_buffer else 0

    @property
    def n_batches(self) -> int:
        if self.batch_elements is None:
            raise ValueError(
                "batch_elements unset -- resolve a MemoryPlan first "
                "(simulation.plan_config) or set it explicitly"
            )
        return self.n_eq // self.batch_elements

    def bytes_per_element(self, bytes_per_scalar: int = 4) -> int:
        # u, D in; v out  (S shared, amortized)
        return 3 * self.p ** 3 * bytes_per_scalar

    @classmethod
    def batch_for_channel(cls, p: int, channel_bytes: int = 256 * 2 ** 20,
                          bytes_per_scalar: int = 4) -> int:
        """The paper's E: elements whose I/O fits one HBM channel."""
        return channel_bytes // (3 * p ** 3 * bytes_per_scalar)


def plan_config(
    cfg: SimConfig,
    *,
    target: Optional[memchannels.MemoryTarget] = None,
    cu_count: int = 1,
    device=None,
) -> MemoryPlan:
    """Resolve the memory architecture for this simulation config.

    Explicit ``cfg.batch_elements`` is honored; otherwise the planner
    auto-sizes E against the target's pseudo-channel capacity.  Without
    a ``target`` the datasheet of ``device`` (the CUDA card unless
    ``"cpu"``) is used.
    """
    return memdse.make_plan(
        cfg.p,
        target=(target if target is not None
                else memchannels.detect_target(device)),
        policy=cfg.policy,
        backend=cfg.backend,
        batch_elements=cfg.batch_elements,
        prefetch_depth=cfg.depth,
        cu_count=cu_count,
        n_eq=cfg.n_eq,
    )


def _batch_generator(
    p: int, batch_elements: int, n_batches: int, seed: int
) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic, resumable synthetic element stream ([-1,1] data,
    matching the paper's range normalization)."""
    for b in range(n_batches):
        rng = np.random.default_rng(seed + b)
        yield {
            "D": rng.uniform(-1, 1, (batch_elements, p, p, p)).astype(np.float32),
            "u": rng.uniform(-1, 1, (batch_elements, p, p, p)).astype(np.float32),
        }


@dataclasses.dataclass
class SimResult:
    batches: int
    elements: int
    wall_s: float
    checksum: float
    plan: Optional[MemoryPlan] = None
    #: the device of the pool's first slot
    device: str = ""
    #: every slot of the pool the run replicated the operator over
    devices: Tuple[str, ...] = ()

    @property
    def gflops(self) -> float:
        """Elements per second times 1e-9, as the reference computes it;
        :func:`achieved_gflops` is the paper's Eq. (2) rate."""
        return 0.0 if self.wall_s == 0 else (
            self.elements * 1e-9 / self.wall_s
        )


def run_simulation(
    cfg: SimConfig,
    *,
    devices=None,
    device=None,
    max_batches: Optional[int] = None,
    S: Optional[np.ndarray] = None,
    plan: Optional[MemoryPlan] = None,
    tracer=None,
) -> SimResult:
    """Run the batched Inverse-Helmholtz simulation under a MemoryPlan.

    The plan supplies E, the prefetch depth and the kernel's block; pass
    one explicitly (e.g. a DSE winner) or let :func:`plan_config` derive
    it, with one CU per slot of the pool.  ``devices`` is the pool the
    operator is replicated over (every visible card by default;
    ``device`` is the one-slot shorthand, ``"cpu"`` for the host): each
    batch is sharded over all its slots, as the reference shards it over
    its element mesh, and a plan that asks for more CUs than the pool
    has warns and runs on the pool.  Returns wall time and a checksum
    (the sum of every ``v``, as per-shard sums); GFLOPS by the paper's
    op-count model is :func:`achieved_gflops`.

    Under a fixed-point policy the inputs are encoded on the host, as
    the paper's host code does, and the checksum sums the decoded
    outputs.

    ``tracer`` (``repro_torch.trace.Tracer``; None = off) records the
    staging/dispatch/sync spans of the K-deep engine (the dispatch spans
    in the card's own times on one CUDA card) plus per-channel host byte
    counters from the plan's buffer table.
    """
    pool = memchannels.resolve_devices(devices, device)
    if plan is None:
        plan = plan_config(cfg, cu_count=len(pool), device=pool[0])
    if plan.cu_count > len(pool):
        warnings.warn(
            f"run_simulation: the plan replicates {plan.cu_count} CUs but "
            f"the pool has {len(pool)} slot(s); executing on the pool.",
            RuntimeWarning,
        )
    E = plan.batch_elements
    compiled = {
        dev: build_inverse_helmholtz(cfg.p, policy=cfg.policy,
                                     backend=cfg.backend, plan=plan,
                                     device=dev)
        for dev in dict.fromkeys(pool)
    }
    pol = compiled[pool[0]].policy
    rng = np.random.default_rng(cfg.seed + 2 ** 31)
    if S is None:
        S = rng.uniform(-1, 1, (cfg.p, cfg.p)).astype(np.float32)

    n_total = cfg.n_eq // E
    n = n_total if max_batches is None else min(max_batches, n_total)
    batches = _batch_generator(cfg.p, E, n, cfg.seed)
    if isinstance(pol, FixedPointPolicy):
        S_host = pol.encode(S).numpy()
        batches = ({k: pol.encode(v).numpy() for k, v in b.items()}
                   for b in batches)

        def reduce_fn(out):
            return tuple(torch.sum(pol.decode(v)) for v in out)
    else:
        S_host = S

        def reduce_fn(out):
            return tuple(torch.sum(v) for v in out)
    S_dev = replicate({"S": S_host}, pool)

    def compute(staged: mempipe.Staged):
        shards = staged.shards()
        return tuple(
            compiled[dev].batched_fn({"S": S_dev[dev]["S"],
                                      **{k: v[j] for k, v in shards.items()}})["v"]
            for j, dev in enumerate(pool)
        )

    stage = mempipe.HostStager(pool, slots=plan.prefetch_depth + 1)
    if tracer:
        from ..trace.attribution import (COUNTER_CHANNEL_BYTES,
                                         host_channel_bytes)

        ch_bytes = {
            str(c): float(b)
            for c, b in host_channel_bytes(plan.buffers).items()
        }
        stager = stage

        def stage(batch):
            tracer.bump(COUNTER_CHANNEL_BYTES, ch_bytes)
            return stager(batch)

    t0 = time.perf_counter()
    sums = mempipe.run_pipelined(
        compute,
        batches,
        stage_fn=stage,
        depth=plan.prefetch_depth,
        reduce_fn=reduce_fn,
        tracer=tracer,
        stage_name=plan.operator,
        device=pool,
    )
    wall = time.perf_counter() - t0
    checksum = 0.0
    for per_shard in sums:
        for s in per_shard:
            checksum += float(s)
    return SimResult(
        batches=n, elements=n * E, wall_s=wall, checksum=checksum, plan=plan,
        device=str(pool[0]), devices=tuple(str(d) for d in pool),
    )


def achieved_gflops(res: SimResult, p: int) -> float:
    """GFLOPS under the paper's Eq. (2)-(3) accounting."""
    n_op = res.elements * flops_per_element(p)
    return n_op / res.wall_s / 1e9 if res.wall_s > 0 else 0.0


@dataclasses.dataclass
class ChainResult:
    """One run of a whole pipeline off a single ChainPlan."""

    batches: int
    elements: int
    wall_s: float
    checksums: Dict[str, float]
    plan: Optional[memchain.ChainPlan] = None
    #: full chain outputs, qualified "stage.output" (collect_outputs=True)
    outputs: Optional[Dict[str, np.ndarray]] = None
    #: whether stages were cross-batch pipelined (one dispatch ring per
    #: stage) or run back-to-back per batch (the serial baseline)
    pipelined_stages: bool = False
    #: the device of the pool's first slot
    device: str = ""
    #: per-stage groups of pool slots (indices) the run executed on, as
    #: the plan placed them (None when the placement degenerated to one
    #: group over the whole pool)
    placement_groups: Optional[Tuple[Tuple[int, ...], ...]] = None
    #: every slot of the pool
    devices: Tuple[str, ...] = ()
    #: batch indices the StepMonitor flagged as stragglers (empty when no
    #: monitor was passed or nothing was flagged)
    straggler_batches: Tuple[int, ...] = ()


def _chain_batch_inputs(
    chain: memchain.ProgramChain,
    E: int,
    n_batches: int,
    seed: int,
    inputs: Optional[Dict[str, np.ndarray]],
) -> Iterator[Dict[str, np.ndarray]]:
    """Per-batch host-streamed inputs, qualified "stage.input".

    ``inputs`` supplies full arrays (element-axis leading) to slice;
    otherwise a deterministic synthetic stream in [-1, 1] is generated,
    batch ``b`` from ``default_rng(seed + b)``."""
    names = [
        f"{s.name}.{n}"
        for i, s in enumerate(chain.stages)
        for n, _ in chain.host_element_inputs(i)
    ]
    shapes = {
        f"{s.name}.{n}": v.shape
        for i, s in enumerate(chain.stages)
        for n, v in chain.host_element_inputs(i)
    }
    for b in range(n_batches):
        if inputs is not None:
            yield {q: inputs[q][b * E:(b + 1) * E] for q in names}
        else:
            rng = np.random.default_rng(seed + b)
            yield {
                q: rng.uniform(-1, 1, (E,) + shapes[q]).astype(np.float32)
                for q in names
            }


def _shared_host(
    chain: memchain.ProgramChain,
    seed: int,
    shared: Optional[Dict[str, np.ndarray]],
) -> Dict[str, np.ndarray]:
    """The batch-invariant operands by bare name: from ``shared`` where
    given, else operand ``k`` of the sorted names from
    ``default_rng(seed + 2**31 + k)``."""
    out: Dict[str, np.ndarray] = {}
    for k, (name, node) in enumerate(sorted(chain.shared_operands().items())):
        if shared is not None and name in shared:
            out[name] = np.asarray(shared[name])
        else:
            rng = np.random.default_rng(seed + 2 ** 31 + k)
            out[name] = rng.uniform(-1, 1, node.shape).astype(np.float32)
    return out


def chain_stage_fns(
    chain: memchain.ProgramChain,
    plan: memchain.ChainPlan,
    shared: Dict[torch.device, Dict[str, torch.Tensor]],
    stage_devices: Sequence[Sequence[torch.device]],
) -> List[Callable]:
    """The chain's stages as ``fn(staged, carry)`` for the pipeline
    driver.  Stage ``i`` runs once per slot of its group
    ``stage_devices[i]``, on that shard of the batch: it reads its bound
    streams from the carry (the device-resident handoff, already laid
    over its slots), its shared operands from ``shared[device]`` (one
    copy a distinct device, :func:`replicate`) and its host streams from
    the staged batch's shards, and returns the carry with its outputs
    added under ``"stage.output"`` as one tensor a slot.

    A plan may run some stages at a smaller batch than the chain E
    (per-stage E_s): inside each shard the re-blocking handoff slices the
    shard into sub-batches of ``E_s`` split over the group on the device;
    a kernel stage writes each into its slice of the shard's outputs, any
    other stage's outputs are concatenated (bitwise-equal to the
    full-batch call: elements are independent)."""
    E = plan.batch_elements
    stage_es = [plan.stage_e(i) for i in range(len(plan.stages))]
    if len(stage_es) != len(chain.stages):
        stage_es = [E] * len(chain.stages)

    def make_stage_fn(i: int, s: memchain.ChainStage):
        devs = tuple(stage_devices[i])
        batched_fn = s.compiled.batched_fn
        if 0 < stage_es[i] < E:
            batched_fn = mempipe.reblock_batched_fn(
                batched_fn, tuple(s.program.element_vars),
                -(-stage_es[i] // len(devs)),
                outputs=(
                    {n: tuple(v.shape) for n, v in s.program.outputs.items()}
                    if s.backend == "pallas" else None
                ),
            )

        def run_stage(staged: mempipe.Staged, carry):
            live: Dict[str, Tuple[torch.Tensor, ...]] = (
                dict(carry) if carry else {})
            host = None
            outs = []
            for j, dev in enumerate(devs):
                env: Dict[str, torch.Tensor] = {}
                for name in s.program.inputs:
                    if name in chain.resolved[i]:
                        p_idx, out_name = chain.resolved[i][name]
                        env[name] = live[
                            f"{chain.stages[p_idx].name}.{out_name}"][j]
                    elif name in shared[dev]:
                        env[name] = shared[dev][name]
                    else:
                        if host is None:
                            host = staged.shards()
                        env[name] = host[f"{s.name}.{name}"][j]
                outs.append(batched_fn(env))
            for out_name in outs[0]:
                live[f"{s.name}.{out_name}"] = tuple(o[out_name] for o in outs)
            return live

        return run_stage

    return [make_stage_fn(i, s) for i, s in enumerate(chain.stages)]


def chain_stage_slots(
    chain: memchain.ProgramChain,
    plan: memchain.ChainPlan,
    n_slots: int,
) -> Optional[List[Tuple[int, ...]]]:
    """Per-stage groups of pool slot indices where the plan's placement
    runs as placed on a pool of ``n_slots`` slots, else None: the
    placement needs more slots than the pool has, its stage count differs
    from the compiled chain's, or every stage sits on the one slot 0 (the
    reference's degenerate cases, which run one group over the whole
    pool)."""
    place = plan.placement
    if (place.n_stages != len(chain.stages)
            or mempipe.placement_meshes(place, range(n_slots)) is None):
        return None
    return [tuple(sp.devices) for sp in place.stages]


def run_chain(
    chain: memchain.ProgramChain,
    plan: Optional[memchain.ChainPlan] = None,
    *,
    n_eq: Optional[int] = None,
    devices=None,
    device=None,
    max_batches: Optional[int] = None,
    seed: int = 0,
    inputs: Optional[Dict[str, np.ndarray]] = None,
    shared: Optional[Dict[str, np.ndarray]] = None,
    collect_outputs: bool = False,
    pipeline_stages: Optional[bool] = None,
    tracer=None,
    monitor=None,
    metrics=None,
) -> ChainResult:
    """Execute a whole multi-operator pipeline off one ChainPlan.

    Bound streams (e.g. interpolation's ``w`` into the gradient) never
    leave the device -- exactly the residency the plan prices.  The
    execution schedule comes from the plan's ``pipeline`` spec: in
    pipelined mode each stage gets its own dispatch ring and stage i of
    batch k is dispatched alongside stage i+1 of batch k-1
    (``memory.pipeline.run_stage_pipelined``); in serial mode stages run
    back-to-back per batch -- the paper's baseline, bitwise-equal to the
    pipelined schedule.  ``pipeline_stages`` overrides the plan's mode.

    ``devices`` is the device pool (every visible card by default;
    ``device`` is the one-slot shorthand, and on ``"cpu"`` every kernel
    stage runs its plain PyTorch version); without a plan, the chain is
    planned with one CU per slot on the pool's topology.  A plan whose
    placement fits the pool runs as placed: each stage shards its element
    batch over its own group of slots (one dispatch ring per group), its
    host streams are staged to that group, the shared operands are put
    once per distinct device, and every stream that crosses groups is
    re-sharded onto the consumer's slots before it is read
    (``memory.pipeline.reshard``, a ``handoff`` span under the tracer).
    Every degenerate placement (every stage on one slot, a plan for more
    devices than the pool has -- which warns -- or a stage-count mismatch)
    runs one group over the whole pool.  Host-streamed inputs come from
    ``inputs`` (full numpy arrays, qualified "stage.input") or a
    deterministic synthetic stream; ``shared`` supplies the
    batch-invariant operands by bare name (synthesized when omitted).

    A plan with per-stage batch sizes (``plan.stage_batch_elements``)
    runs each such stage over E_s sub-batches of the chain batch
    (``memory.pipeline.reblock_batched_fn``, inside each shard),
    bitwise-equal to the uniform run.

    ``collect_outputs`` returns the concatenated chain outputs (the
    shards gathered in slot order: bitwise a one-slot run's); by default
    only a checksum per output crosses back, the sum of its per-shard
    sums.

    ``tracer`` (``repro_torch.trace.Tracer``; None = off) records the
    full span hierarchy -- chain run -> per-stage slot -> dispatch (in
    the card's own times on a CUDA device) -- plus per-channel host byte,
    pad-element and CU-occupancy counters from the plan, ready for
    ``repro_torch.trace.attribution``.  ``monitor`` (a
    ``runtime.StepMonitor``) watches per-batch retire times; flagged
    batches are annotated on their sync spans and reported in
    ``ChainResult.straggler_batches``.  ``metrics`` (a
    ``repro_torch.metrics`` registry) records the driver's always-on
    per-stage dispatch/stall histograms keyed by the plan signature.
    None changes results.
    """
    pool = memchannels.resolve_devices(devices, device)
    if n_eq is None and inputs:
        # the data bounds the problem -- derive n_eq before planning so
        # the auto-sized E can never exceed what the arrays hold
        n_eq = min(v.shape[0] for v in inputs.values())
    if plan is None:
        plan = memchain.plan_chain(
            chain, target=memchannels.detect_target(pool[0]),
            cu_count=len(pool), topology=DeviceTopology.from_torch(pool),
            n_eq=n_eq,
        )
    planned = tuple(sp.backend for sp in plan.stages)
    compiled = tuple(s.backend for s in chain.stages)
    if planned != compiled:
        warnings.warn(
            f"run_chain: plan backends {planned} differ from the "
            f"compiled chain's {compiled}; executing the compiled chain.",
            RuntimeWarning,
        )
    if plan.placement.devices_used[-1] >= len(pool):
        warnings.warn(
            f"run_chain: plan placement spans "
            f"{plan.placement.topology.n_devices} device(s) but only "
            f"{len(pool)} are local; executing on the local pool instead.",
            RuntimeWarning,
        )
    E = plan.batch_elements
    pipe = plan.pipeline
    if pipe is None:  # legacy plan: derive the spec from the stage Ks
        pipe = memchain.derive_pipeline(
            [sp.prefetch_depth for sp in plan.stages]
        )
    stage_depths = list(pipe.stage_depths)
    if len(stage_depths) != len(chain.stages):
        # a plan from a differently-staged compile still executes the
        # compiled chain (warned above): carry the plan's deepest K as
        # host staging and keep its mode with depth-1 rings
        stage_depths = [max(stage_depths)] + (
            [1 if pipe.pipelined else 0] * (len(chain.stages) - 1)
        )
    if pipeline_stages is None:
        pipeline_stages = pipe.pipelined
    if pipeline_stages:
        depths = stage_depths
        # forcing the mode on cannot pipeline a plan with no inter-stage
        # ring depth: execution (and the reported flag) stays serial
        pipeline_stages = len(depths) > 1 and any(d > 0 for d in depths[1:])
    else:
        # serial baseline: host staging only, stages back-to-back
        depths = [max(stage_depths)] + [0] * (len(chain.stages) - 1)
    if n_eq is None:
        n_eq = E * (max_batches if max_batches else 4)
    if inputs is not None:
        avail = min(v.shape[0] for v in inputs.values())
        if E > avail:
            raise ValueError(
                f"plan batch E={E} exceeds the provided input arrays "
                f"({avail} elements); re-plan with n_eq or pass larger "
                "inputs"
            )
        # never slice past the data: an oversized n_eq would otherwise
        # run empty batches while reporting their elements as work done
        n_eq = min(n_eq, avail)
    n_total = max(1, n_eq // E)
    n = n_total if max_batches is None else min(max_batches, n_total)

    # placement execution: one dispatch ring per group of pool slots
    groups = chain_stage_slots(chain, plan, len(pool))
    slots = groups or [tuple(range(len(pool)))] * len(chain.stages)
    stage_devs = [tuple(pool[j] for j in g) for g in slots]
    shared_dev = replicate(_shared_host(chain, seed, shared),
                           [d for devs in stage_devs for d in devs])
    out_names = [
        f"{s.name}.{n}"
        for i, s in enumerate(chain.stages)
        for n, _ in chain.chain_outputs(i)
    ]

    stage_fns = chain_stage_fns(chain, plan, shared_dev, stage_devs)
    # multi-group handoff: before stage i consumes a batch, re-shard the
    # device-resident streams it reads from producers on other groups
    place_fns = None
    if groups is not None:
        def make_place_fn(i: int):
            moves = sorted(
                f"{chain.stages[p].name}.{out}"
                for p, out in chain.resolved[i].values()
                if slots[p] != slots[i]
            )
            if not moves:
                return None

            def place(staged, carry):
                carry = dict(carry) if carry else {}
                for q in moves:
                    carry[q] = mempipe.reshard(carry[q], stage_devs[i])
                return staged, carry

            return place

        place_fns = [make_place_fn(i) for i in range(len(chain.stages))]
    if collect_outputs:
        def reduce_fn(live):
            return {q: live[q] for q in out_names}
    else:
        def reduce_fn(live):
            return {q: tuple(torch.sum(x) for x in live[q])
                    for q in out_names}

    #: qualified host stream -> the slots of the stage that reads it
    layout = {
        f"{s.name}.{n}": stage_devs[i]
        for i, s in enumerate(chain.stages)
        for n, _ in chain.host_element_inputs(i)
    }
    stage_batch = mempipe.HostStager(pool, slots=depths[0] + 1, layout=layout)
    if tracer:
        from ..trace.attribution import (COUNTER_CHANNEL_BYTES,
                                         COUNTER_OCCUPANCY,
                                         COUNTER_PAD_ELEMENTS,
                                         host_channel_bytes)

        tracer.meta.update({
            "chain": plan.chain, "target": plan.target.name,
            "policy": plan.policy, "signature": plan.signature,
            "batch_elements": E,
        })
        tracer.bump(COUNTER_OCCUPANCY, {
            sp.name: float(sp.cu_count) for sp in plan.stages
        })
        ch_bytes = {
            str(c): float(b)
            for c, b in host_channel_bytes(plan.buffers).items()
        }
        pad = plan.batch_pad_elements
        stager = stage_batch

        def stage_batch(batch):
            tracer.bump(COUNTER_CHANNEL_BYTES, ch_bytes)
            if pad:
                tracer.bump(COUNTER_PAD_ELEMENTS, {"pad": float(pad)})
            return stager(batch)

    m_count0 = monitor.count if monitor is not None else 0
    m_flags0 = len(monitor.flags) if monitor is not None else 0
    root = (tracer.begin("run_chain", "run", 0, chain=plan.chain,
                         batches=n, batch_elements=E,
                         pipelined=bool(pipeline_stages))
            if tracer else None)
    t0 = time.perf_counter()
    per_batch = mempipe.run_stage_pipelined(
        stage_fns,
        _chain_batch_inputs(chain, E, n, seed, inputs),
        stage_fn=stage_batch,
        depths=depths,
        reduce_fn=reduce_fn,
        place_fns=place_fns,
        tracer=tracer,
        monitor=monitor,
        stage_names=[s.name for s in chain.stages],
        metrics=metrics,
        metrics_labels={"plan": plan.signature[:12]} if metrics else None,
        device=pool,
    )
    wall = time.perf_counter() - t0
    if root is not None:
        tracer.end(root)
    stragglers: Tuple[int, ...] = ()
    if monitor is not None:
        # monitor counts are 1-based record() calls; one call per retired
        # batch in batch order, on top of whatever the monitor saw before
        stragglers = tuple(
            c - 1 - m_count0 for c in monitor.flags[m_flags0:]
        )

    checksums: Dict[str, float] = {q: 0.0 for q in out_names}
    outputs: Optional[Dict[str, np.ndarray]] = None
    if collect_outputs:
        outputs = {}
        for q in out_names:
            t = torch.cat([x for b in per_batch for x in b[q]])
            # numpy has no bfloat16: such outputs come back as float32
            outputs[q] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        for q in out_names:
            checksums[q] = float(np.sum(outputs[q], dtype=np.float64))
    else:
        for b in per_batch:
            for q, v in b.items():
                checksums[q] += sum(float(x) for x in v)
    return ChainResult(
        batches=n, elements=n * E, wall_s=wall, checksums=checksums,
        plan=plan, outputs=outputs, pipelined_stages=bool(pipeline_stages),
        device=str(pool[0]), straggler_batches=stragglers,
        placement_groups=tuple(groups) if groups is not None else None,
        devices=tuple(str(d) for d in pool),
    )
