"""Predicted-vs-measured attribution: overlay a traced run against its
plan's :class:`~repro_torch.memory.chain.ChainCost`.

The planner predicts a per-batch time from three device terms plus
pipeline fill; the trace records what the executor actually spent, span
by span.  :func:`attribute` folds the two together per stage --
``sum(dispatch spans)`` against the stage's predicted steady-state time
-- and names the measured bottleneck in the planner's own vocabulary
(``host`` / ``hbm`` / ``compute`` / ``fill-drain``), so a 5x
pred-vs-measured gap stops being one opaque ratio and becomes "stage
helmholtz is 4.1x slower than its compute term, everything else is on
model".  :func:`attribution_report` renders the ``measured:`` section
appended to the Fig.-14-style plan report; ``stable_only=True`` keeps
only deterministic fields (structure, predictions, counter sums) so the
section can be golden-tested.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from .tracer import HOST_TRACK, Tracer

# -- the span vocabulary the executors emit ---------------------------------
CAT_RUN = "run"            # root span, host track
CAT_STAGE = "stage"        # per-stage umbrella span, track 1+i
CAT_SLOT = "slot"          # one (stage, batch) dispatch slot
CAT_DISPATCH = "dispatch"  # the stage-fn call inside a slot
CAT_HANDOFF = "handoff"    # cross-group reshard inside a slot
CAT_STAGE_HOST = "stage-host"  # host-side staging of one batch
CAT_SYNC = "sync"          # host sync (device_get) retiring a batch
CAT_REQUEST = "request"    # serve-layer per-request span, submit->finish

#: Counter names (``Tracer.bump`` series).
COUNTER_CHANNEL_BYTES = "channel_bytes"
COUNTER_PAD_ELEMENTS = "pad_elements"
COUNTER_OCCUPANCY = "cu_occupancy"
#: Serving-layer series (``repro_torch.serve``).  All cumulative, like every
#: counter here: queue depth at time t is submitted - admitted, plan-
#: cache hit rate is hit / (hit + miss).
COUNTER_PLAN_CACHE = "plan_cache"        # keys: hit / miss
COUNTER_SERVE_REQUESTS = "serve_requests"  # submitted/admitted/completed/
                                           # failed/rejected
COUNTER_SERVE_WAVES = "serve_waves"      # coalesced waves admitted


def host_channel_bytes(buffers) -> Dict[int, int]:
    """Per-pseudo-channel host-streamed bytes for one batch, from the
    plan's buffer table.  Integer remainders land on a buffer's first
    channels, so the values sum *exactly* to ``host_stream_bytes`` --
    the invariant the schema tests pin."""
    out: Dict[int, int] = {}
    for b in buffers:
        if b.role not in ("in", "out") or not b.channels:
            continue
        n = len(b.channels)
        base, rem = divmod(b.batch_bytes, n)
        for j, ch in enumerate(b.channels):
            out[ch] = out.get(ch, 0) + base + (1 if j < rem else 0)
    return out


@dataclasses.dataclass
class StageAttribution:
    """One stage's predicted-vs-measured ledger."""

    index: int
    name: str
    slots: int                  # batches this stage dispatched
    fill_slots: int             # of those, in the fill/drain window
    measured_s: float           # sum of the stage's dispatch spans
    handoff_s: float            # sum of its cross-group reshard spans
    pred_s_per_batch: float
    pred_bottleneck: str

    @property
    def measured_s_per_batch(self) -> float:
        return self.measured_s / self.slots if self.slots else 0.0

    @property
    def ratio(self) -> float:
        """measured / predicted per batch (1.0 = the model was right)."""
        if self.pred_s_per_batch <= 0 or not self.slots:
            return 0.0
        return self.measured_s_per_batch / self.pred_s_per_batch


@dataclasses.dataclass
class Attribution:
    """A whole traced run folded against its plan."""

    wall_s: float
    n_batches: int
    pred_s_per_batch: float
    host_s: float               # staging + retire syncs on the host track
    fill_s: float               # slot time inside the fill/drain window
    stages: List[StageAttribution]
    #: end-of-run counter totals (str channel id -> bytes)
    channel_bytes: Dict[str, float]
    pad_elements: float = 0.0
    straggler_batches: Tuple[int, ...] = ()

    @property
    def measured_s_per_batch(self) -> float:
        return self.wall_s / self.n_batches if self.n_batches else 0.0

    @property
    def ratio(self) -> float:
        if self.pred_s_per_batch <= 0 or not self.n_batches:
            return 0.0
        return self.measured_s_per_batch / self.pred_s_per_batch

    @property
    def bottleneck(self) -> str:
        """Where the measured time actually went: the slowest stage's
        device term, the host side, or pipeline fill/drain."""
        terms: List[Tuple[float, str]] = [
            (self.host_s, "host"),
            (self.fill_s, "fill-drain"),
        ]
        for s in self.stages:
            term = s.pred_bottleneck
            label = "host" if term == "host-link" else term
            terms.append((s.measured_s, f"{s.name}:{label}"))
        return max(terms, key=lambda kv: kv[0])[1] if terms else ""


def attribute(tracer: Tracer, plan) -> Attribution:
    """Fold a traced chain run against its ChainPlan.

    ``plan`` is a :class:`~repro_torch.memory.chain.ChainPlan`; the tracer must
    hold the spans ``repro_torch.memory.pipeline.run_stage_pipelined`` emits
    (slot spans carrying ``stage``/``batch``/``tick`` args).
    """
    slots = [s for s in tracer.spans if s.cat == CAT_SLOT and not s.open]
    dispatch = [
        s for s in tracer.spans if s.cat == CAT_DISPATCH and not s.open
    ]
    handoff = [
        s for s in tracer.spans if s.cat == CAT_HANDOFF and not s.open
    ]
    n_batches = 1 + max(
        (int(s.args.get("batch", 0)) for s in slots), default=-1
    )
    max_skew = 0
    pipe = getattr(plan, "pipeline", None)
    if pipe is not None:
        max_skew = pipe.stage_skews[-1]

    def in_fill(span) -> bool:
        t = int(span.args.get("tick", 0))
        return t < max_skew or t >= n_batches

    cost = plan.cost
    pred_stage = (
        list(cost.stage_steady_times) if cost.pipelined_stages
        else [c.t_pipelined for c in cost.stages]
    )
    stages: List[StageAttribution] = []
    for i, sp in enumerate(plan.stages):
        my_slots = [s for s in slots if int(s.args.get("stage", -1)) == i]
        my_disp = [s for s in dispatch if int(s.args.get("stage", -1)) == i]
        my_hand = [s for s in handoff if int(s.args.get("stage", -1)) == i]
        stages.append(StageAttribution(
            index=i, name=sp.name, slots=len(my_slots),
            fill_slots=sum(1 for s in my_slots if in_fill(s)),
            measured_s=sum(s.duration for s in my_disp),
            handoff_s=sum(s.duration for s in my_hand),
            pred_s_per_batch=pred_stage[i] if i < len(pred_stage) else 0.0,
            pred_bottleneck=sp.cost.bottleneck,
        ))

    host_s = sum(
        s.duration for s in tracer.spans
        if s.cat in (CAT_STAGE_HOST, CAT_SYNC) and not s.open
    )
    fill_s = sum(s.duration for s in slots if in_fill(s))
    runs = [s for s in tracer.spans if s.cat == CAT_RUN and not s.open]
    wall = (
        sum(s.duration for s in runs) if runs
        else max(0.0, tracer.t_end - tracer.t_start)
    )
    stragglers = tuple(sorted(
        int(s.args["batch"]) for s in tracer.spans
        if s.cat == CAT_SYNC and s.args.get("straggler")
        and "batch" in s.args
    ))
    return Attribution(
        wall_s=wall, n_batches=n_batches,
        pred_s_per_batch=cost.t_pipelined,
        host_s=host_s, fill_s=fill_s, stages=stages,
        channel_bytes=tracer.totals(COUNTER_CHANNEL_BYTES),
        pad_elements=sum(
            tracer.totals(COUNTER_PAD_ELEMENTS).values()
        ),
        straggler_batches=stragglers,
    )


def attribution_report(
    tracer: Tracer, plan, *, stable_only: bool = False
) -> str:
    """Render the ``measured:`` section for a traced run of ``plan``.

    ``stable_only=True`` drops every timing-derived field (wall times,
    ratios, bottleneck attribution) and keeps the deterministic ones --
    structure, predictions, counter sums -- for golden tests."""
    a = attribute(tracer, plan)
    ms = lambda s: f"{s * 1e3:.3f}"
    lines: List[str] = []
    if stable_only:
        lines.append(
            f"measured: {a.n_batches} batches traced   "
            f"predicted {ms(a.pred_s_per_batch)} ms/batch"
        )
    else:
        lines.append(
            f"measured: {a.n_batches} batches traced   wall "
            f"{ms(a.wall_s)} ms ({ms(a.measured_s_per_batch)} ms/batch)   "
            f"predicted {ms(a.pred_s_per_batch)} ms/batch   "
            f"[x{a.ratio:.2f}]"
        )
        lines.append(
            f"  attribution: {a.bottleneck}   host {ms(a.host_s)} ms   "
            f"fill/drain {ms(a.fill_s)} ms"
        )
        if a.straggler_batches:
            lines.append(
                "  stragglers: batches "
                f"[{','.join(str(b) for b in a.straggler_batches)}]"
            )
    hdr = (
        f"  {'stage':<12} {'slots':>5} {'fill':>4} {'pred ms/b':>10} "
        f"{'meas ms/b':>10} {'ratio':>7}  pred-bound"
    )
    lines.append(hdr)
    for s in a.stages:
        meas = "-" if stable_only else ms(s.measured_s_per_batch)
        ratio = "-" if stable_only else f"x{s.ratio:.2f}"
        lines.append(
            f"  {s.name:<12} {s.slots:>5} {s.fill_slots:>4} "
            f"{ms(s.pred_s_per_batch):>10} {meas:>10} {ratio:>7}  "
            f"{s.pred_bottleneck}"
        )
    total = sum(a.channel_bytes.values())
    per_batch = total / a.n_batches if a.n_batches else 0.0
    want = getattr(plan, "host_stream_bytes", 0)
    tick = "ok" if int(round(per_batch)) == want else "MISMATCH"
    lines.append(
        f"  counters: host stream {per_batch / 2**20:.2f} MiB/batch over "
        f"{len(a.channel_bytes)} channels (plan: "
        f"{want / 2**20:.2f} MiB/batch -> {tick})   "
        f"pad {int(a.pad_elements)} elem"
    )
    occupancy = tracer.totals(COUNTER_OCCUPANCY)
    if occupancy:
        vec = ",".join(
            str(int(occupancy[k])) for k in sorted(occupancy)
        )
        lines.append(f"  cu occupancy: [{vec}]")
    return "\n".join(lines)


def chrome_counter_totals(
    trace: Dict[str, Any]
) -> Dict[str, Dict[str, float]]:
    """Final cumulative counter totals from an exported Chrome-trace
    document.  ``Tracer.bump`` counters export as ``ph: "C"`` events
    each carrying the *running* totals, so the last event per counter
    name is the run's sum -- the totals ``repro_torch.metrics`` reconciles
    its own counters against (``python -m repro_torch.metrics --check
    --trace``)."""
    totals: Dict[str, Dict[str, float]] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "C":
            totals[ev["name"]] = {
                str(k): float(v) for k, v in ev.get("args", {}).items()
            }
    return totals


def samples_from_trace(tracer: Tracer, plan) -> List[Dict[str, Any]]:
    """Per-term (predicted, measured) pairs a profile store learns from:
    one sample per stage with measured slot time, attributed to the
    stage's predicted bottleneck term, plus one chain-level sample.  A
    stage sample timed by the card's own clock carries
    ``clock="device"`` (see :func:`~repro_torch.memory.chain.fit_contention`)."""
    a = attribute(tracer, plan)
    # stages whose dispatch spans carry the card's own times (the host
    # clock's duration kept as ``host_s``): pure device evidence
    device_timed = {
        int(s.args.get("stage", -1)) for s in tracer.spans
        if s.cat == CAT_DISPATCH and "host_s" in s.args
    }
    samples: List[Dict[str, Any]] = []
    for s in a.stages:
        if not s.slots or s.pred_s_per_batch <= 0 or s.measured_s <= 0:
            continue
        sample = {
            "scope": f"stage:{s.name}",
            "predicted_s": s.pred_s_per_batch,
            "measured_s": s.measured_s_per_batch,
            "bottleneck": s.pred_bottleneck,
        }
        if s.index in device_timed:
            sample["clock"] = "device"
        samples.append(sample)
    if a.n_batches and a.pred_s_per_batch > 0 and a.wall_s > 0:
        samples.append({
            "scope": "chain",
            "predicted_s": a.pred_s_per_batch,
            "measured_s": a.measured_s_per_batch,
            "bottleneck": plan.cost.bottleneck,
        })
    return samples
